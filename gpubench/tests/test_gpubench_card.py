"""The cells on the card at small sizes (marker `cuda`; they skip without
as many CUDA devices as a cell asks for): each run correct, and a traced
run that reads the device. Each cell's sizes here are the "card"
overrides of the "tests" key of its traffic file.

    python3 -m pytest gpubench/tests -m cuda
"""
import pytest
import torch

from gpubench import harness
from gpubench.tests.cells import SEED, SIZED, small_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SIZED)
def test_cell_on_the_card(card, name):
    cell = small_cell(name, "card")
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"{name} needs {cell.chips} CUDA devices")
    r = harness.run_cell(cell, SEED, 0.5, False, card)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    t = harness.run_cell(cell, SEED, 0.5, True, card)
    assert t["correct"] and t["device"]["busy_s"] > 0
    assert set(t["metrics"]) == {m["name"] for m in cell.per_layer}
    for name_, m in t["metrics"].items():
        if name_.endswith("roofline"):
            assert 0 < m["value"] <= 100
    labels = [n for n, _ in t["breakdown"]["device_ops"]]
    if name == "device-roundtrip-sweep":
        assert {"K1", "K2", "K3", "K4"} <= {n.split()[0] for n in labels}
