"""The cells on the card at small sizes (marker `cuda`; they skip without
a CUDA device): each run correct, and a traced run that reads the device.

    python3 -m pytest gpubench/tests -m cuda
"""
import dataclasses

import pytest
import torch

from gpubench import harness
from gpubench.tests.test_gpubench_harness import CELLS, SEED, SMALL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the device cell at 2,048 blocks (8 MB), where K1-K4 outweigh the small
# torch operations among the trace's top ten
ON_CARD = {"device-roundtrip-sweep": {"blocks": 2048}}


def small(name):
    cfg, traffic = SMALL[name]
    cfg = {**cfg, **ON_CARD.get(name, {})}
    cell = harness.load_cell(name)
    return dataclasses.replace(cell, config={**cell.config, **cfg},
                               traffic={**cell.traffic, **traffic, "trace_ops": 4})


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    cell = small(name)
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
