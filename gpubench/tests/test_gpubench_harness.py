"""The harness on the CPU, at small sizes: the manifest against the
contract's shape, a cell added as data files alone, the controls found
wrong, and every cell's run with its timed path broken found wrong."""
import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.control import run_control

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SEED = 2**31 + 12345
# each cell cut to a size the CPU runs in a moment: configuration and traffic
SMALL = {
    "api-roundtrip-2e-4": ({"blocks": 3}, {"check_sample": 2, "trace_ops": 2}),
    "device-roundtrip-sweep": ({"blocks": 3}, {"check_sample": 2, "trace_ops": 2}),
}


def small_cell(name):
    cfg, traffic = SMALL[name]
    cell = harness.load_cell(name)
    return dataclasses.replace(cell, config={**cell.config, **cfg},
                               traffic={**cell.traffic, **traffic})


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
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
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


def test_a_cell_added_as_data_alone(tmp_path):
    """A stub configuration, traffic mix and per-layer metric, dropped as
    new files into a copy of the benchmark with new manifest entries, are
    found without editing any file that was there."""
    root = tmp_path / "gpubench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "stub-bitmaps.json").write_text(json.dumps(
        {"name": "stub-bitmaps", "blocks": 2, "block_ints": 992, "reduced": []}))
    (root / "traffic" / "stub-mix.json").write_text(json.dumps({
        "driver": "device_roundtrip", "exponents": [2, 9], "check_sample": 2,
        "trace_ops": 3, "end_to_end": {"device_GBps": {"stat": "rate", "count": "bytes",
                                                       "scale": 1e-9}}}))
    (root / "layer_metrics" / "stub.ops.py").write_text(
        "def read(ctx):\n    return float(len(ctx.ops)) if ctx is not None else None\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "stub-bitmaps", "source": "stub", "why": "stub",
                                "file": "gpubench/configs/stub-bitmaps.json", "reduced": []})
    manifest["workloads"].append({"name": "stub-cell", "config": "stub-bitmaps",
                                  "traffic": "stub-mix", "chips": 1, "why": "stub"})
    for m in manifest["end_to_end"]:
        if m["name"] == "device_GBps":
            m["workloads"].append("stub-cell")
    manifest["per_layer"].append({"name": "stub.ops", "unit": "ops", "better": "higher",
                                  "source": "program_counter", "layer": "device",
                                  "moves": "device_GBps", "workloads": ["stub-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.load_cell("stub-cell", tmp_path / "BENCHMARK.json", root)
    assert [m["name"] for m in cell.per_layer] == ["stub.ops"]
    plain = harness.run_cell(cell, SEED, 0.3, False, "cpu")
    assert plain["correct"] and set(plain["metrics"]) == {"device_GBps", "setup_s"}
    traced = harness.run_cell(cell, SEED, 0.3, True, "cpu")
    assert traced["metrics"]["stub.ops"]["value"] == traced["attempted"]
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_found_wrong(name):
    """Step 3 of how `correct` is decided, at a size a test run holds: the
    configuration's control (gpubench/reference/control.py) in the
    program's place fails the check."""
    cell = small_cell(name)
    result = run_control(cell, SEED, 3, "cpu")
    assert not result["correct"], result


def _flip_first(words):
    words = words.copy() if isinstance(words, np.ndarray) else words.clone()
    words.reshape(-1)[0] ^= 1
    return words


def _faults(monkeypatch, fault):
    """Break the timed path of a cell underneath: `unchanged` (the step
    hands back its input), `half` (half of the batch left out), `altered`
    (an answer altered where it is produced). Both cells run the same
    kernels, the api cell under WahCodec."""
    from wah_tpu_torch.ops.cuda import decode_kernel, encode_kernel

    enc = encode_kernel.encode_padded
    if fault == "unchanged":
        def decode(words, m, cap, chunk_base=0):
            n = cap // 1024 * 992
            return words[:n].clone(), torch.tensor(n, dtype=torch.int32)
        monkeypatch.setattr(decode_kernel, "decode", decode)
    elif fault == "half":
        def encode(ints, nv, chunk_base=0, stitch="auto"):
            ints = ints.clone()
            ints[ints.shape[0] // 2:] = 0
            return enc(ints, nv, chunk_base, stitch)
        monkeypatch.setattr(encode_kernel, "encode_padded", encode)
    else:
        def encode(ints, nv, chunk_base=0, stitch="auto"):
            words, total = enc(ints, nv, chunk_base, stitch)
            return _flip_first(words), total
        monkeypatch.setattr(encode_kernel, "encode_padded", encode)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_found_wrong(monkeypatch, name, fault):
    """A whole run, past the look for a chip, with the program broken under
    the timed path: `correct` comes out false."""
    cell = small_cell(name)
    driver = harness.load_module(ROOT / "drivers" / f"{cell.traffic['driver']}.py").Driver
    prepare = driver.prepare

    def prepare_then_break(self):
        prepare(self)  # set-up sound, the window's operations broken
        _faults(monkeypatch, fault)

    monkeypatch.setattr(driver, "prepare", prepare_then_break)
    monkeypatch.setattr(harness, "load_module",
                        lambda path, _load=harness.load_module:
                        type("M", (), {"Driver": driver}) if path.parent.name == "drivers"
                        else _load(path))
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
