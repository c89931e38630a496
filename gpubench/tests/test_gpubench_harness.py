"""The harness on the CPU, at small sizes: the manifest against the
contract's shape, every cell's test sizes in its own files, a cell added
as data files alone, the controls found wrong, and every cell's run with
its timed path broken found wrong."""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.control import run_control
from gpubench.tests.cells import (CELLS, FAULTS, MANIFEST, REPO, ROOT, SEED, SIZED,
                                  break_timed_path, copy_with_stub, files_of, small_cell,
                                  sizes_of)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_shape():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["gpubench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [c["name"] for c in MANIFEST["configs"]] + CELLS + [
        m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    # one chip or four; at most a quarter of the cells on four, and always one
    assert all(w["chips"] in (1, 4) for w in MANIFEST["workloads"])
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
        cell = harness.load_cell(w["name"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in cell.end_to_end:
            assert m["name"] == "setup_s" or m["name"] in cell.traffic["end_to_end"]
        for m in cell.per_layer:
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
            assert (ROOT / "layer_metrics" / f"{m['name']}.py").exists()
        assert (ROOT / "drivers" / f"{cell.traffic['driver']}.py").exists()
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def _run(cell, trace=False, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, trace, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_states_its_test_sizes(name):
    """The traffic file's "tests" key: the sizes of the cell's CPU and card
    tests and the faults of its timed path, with a planter for them."""
    tests = sizes_of(name)
    assert tests is not None, f"the traffic file of {name} has no 'tests' key"
    missing = {"cpu", "card", "faults"} - set(tests)
    assert not missing, f"the 'tests' key of {name}'s traffic file lacks {sorted(missing)}"
    for where in ("cpu", "card"):
        assert set(tests[where]) <= {"config", "traffic"}
        assert "tests" not in tests[where].get("traffic", {})
    assert tests["faults"]["cases"]
    cell = small_cell(name)
    assert (cell.root / "tests" / "faults" / f"{tests['faults']['planter']}.py").exists()


@pytest.mark.parametrize("name", SIZED)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct_on_the_cpu(name, trace):
    r = _run(small_cell(name), trace)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks" and list(r)[:5] == ["correct", "attempted", "failed",
                                                        "metrics", "device"]
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in small_cell(name).end_to_end}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        # no device on the CPU: the trace's readers find nothing and stay silent
        assert r["device"]["busy_s"] == 0 and set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert not any(k.startswith("device.idle") or k.endswith("roofline") for k in r["metrics"])


def test_same_seed_same_inputs():
    cell = small_cell("device-roundtrip-sweep")
    mod = harness.load_module(ROOT / "drivers" / "device_roundtrip.py")
    a, b, c = (mod.Driver(cell.config, cell.traffic, s, "cpu") for s in (SEED, SEED, SEED + 1))
    for d in (a, b, c):
        d.make_inputs()
    assert all(torch.equal(x, y) for x, y in zip(a.bitmaps, b.bitmaps))
    assert not torch.equal(a.bitmaps[0], c.bitmaps[0])
    # P(bit) = 2^-exponent
    density = [float(np.unpackbits(x.numpy().view(np.uint8)).mean()) for x in a.bitmaps]
    for e, d in zip(cell.traffic["exponents"], density):
        assert abs(d - 2.0 ** -e) < 4 * (2.0 ** -e / (3 * 992 * 32)) ** 0.5 + 1e-4


@pytest.mark.parametrize("chips", [1, 4])
def test_a_cell_added_as_data_alone(tmp_path, chips):
    """A stub configuration, traffic mix, per-layer metric (on four chips
    also a driver and a fault planter), dropped as new files into a copy of
    the benchmark with new manifest entries, are found without editing any
    file that was there, and pass every test of the copy that is
    parametrised over cells, and its manifest's shape."""
    name = copy_with_stub(tmp_path, chips)
    root = tmp_path / "gpubench"
    cell = harness.load_cell(name, tmp_path / "BENCHMARK.json", root)
    assert cell.chips == chips and [m["name"] for m in cell.per_layer] == ["stub.op_ms"]
    plain = harness.run_cell(cell, SEED, 0.3, False, "cpu")
    assert plain["correct"] and set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    traced = harness.run_cell(cell, SEED, 0.3, True, "cpu")
    assert traced["correct"] and traced["metrics"]["stub.op_ms"]["value"] > 0
    # the copy's own tests on the copy's manifest, the program from here
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "gpubench/tests", "-k", f"{name} or test_manifest_shape"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True,
        text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    cases = len(json.loads((root / "traffic" / f"{name}.json").read_text())
                ["tests"]["faults"]["cases"])
    # the shape, the test sizes, two runs, the control, each fault; the card's skips
    assert re.search(rf"\b{5 + cases} passed, 1 skipped\b", p.stdout), p.stdout[-2000:]
    after = files_of(root)
    assert all(after[k] == v for k, v in files_of(ROOT).items())


@pytest.mark.parametrize("name", SIZED)
def test_control_is_found_wrong(name):
    """Step 3 of how `correct` is decided, at a size a test run holds: the
    configuration's control (gpubench/reference/control.py) in the
    program's place fails the check."""
    cell = small_cell(name)
    result = run_control(cell, SEED, 3, "cpu")
    assert not result["correct"], result


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_found_wrong(monkeypatch, name, fault):
    """A whole run, past the look for a chip, with the program broken under
    the timed path after set-up, on every rank (the cell's "faults": a
    planter in gpubench/tests/faults/ and its cases): `correct` comes out
    false."""
    cell = small_cell(name)
    break_timed_path(monkeypatch, cell, fault)
    r = _run(cell)
    assert r["attempted"] > 0 and not r["correct"], r["checks"]


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA device: non-zero exit and no result line. The same in a
    directory that holds only the manifest and the benchmark."""
    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT, tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (REPO, tmp_path):
        p = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", CELLS[0],
                            "--seed", "1", "--seconds", "1", "--trace", "0"],
                           cwd=cwd, capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and not p.stdout.strip()


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "wah_tpu_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "wah_tpu.api", sys)
    assert harness.forbidden_modules() == ["wah_tpu"]
