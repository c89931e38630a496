"""The port's differential on the CPU (plain versions), and the
rule that the port imports nothing of JAX or wah_tpu."""
import ast
import json
import pathlib

import numpy as np
import pytest

from wah_tpu_torch import differential

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def report():
    return differential.run(device="cpu", quick=True)


def test_quick_run_every_section_ok(report):
    assert report["summary"]["failed"] == 0
    names = [c["case"] for c in report["cases"]]
    assert names[-4:] == ["batch_6cols", "logical_ops", "batch_segments", "sharded_1dev_mesh"]
    assert report["summary"]["total_cases"] == len(names) == 6 + 4
    for case in report["cases"]:
        checks = {k: v for k, v in case.items() if isinstance(v, bool)}
        assert case["ok"] and all(checks.values()), case
    for case in report["cases"][:6]:
        assert {"api_enc", "api_dec", "fused", "gather", "native"} <= set(case)


def test_sharded_section_runs_every_check(report):
    """tests/tpu_differential.py's sharded section: three bitmaps, each
    encoded equal to golden and round-tripped, under a gloo group of one
    rank that the run brought up and tore down."""
    import torch.distributed as dist

    (case,) = [c for c in report["cases"] if c["case"] == "sharded_1dev_mesh"]
    checks = {k: v for k, v in case.items() if isinstance(v, bool) and k != "ok"}
    assert sorted(checks) == sorted(f"{d}_{s}" for d in ("enc", "dec")
                                    for s in ("sparse", "dense", "clustered"))
    assert case["ok"] and all(checks.values())
    assert not dist.is_initialized()
    assert "not ported" not in json.dumps(report)


def test_cpu_report_never_names_a_card(report):
    assert report["card"] is None and report["device"] == "cpu"
    assert "no kernel ran" in report["backend"]


def test_case_matrix_is_the_jax_differentials():
    """Same names, seeds and sizes as tests/tpu_differential.py::build_cases."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("tpu_differential", ROOT / "tests" / "tpu_differential.py")
    jdiff = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdiff)
    want = jdiff.build_cases(differential.BLOCK_INTS)
    got = differential.build_cases()
    assert len(got) == len(want) == 22
    for (gn, gd), (wn, wd) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(gd, wd)


def test_native_check_fails_when_the_library_cannot_be_built(monkeypatch):
    def broken(data):
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(differential.native, "encode", broken)
    assert differential._native_encode_equals(np.zeros(4, np.uint32), np.zeros(1, np.uint32)) is False


def test_main_writes_the_report_and_prints_it_as_one_line(tmp_path, capsys):
    out = tmp_path / "diff.json"
    differential.main(["--out", str(out), "--quick", "--device", "cpu"])
    written = json.loads(out.read_text())
    lines = capsys.readouterr().out.splitlines()
    printed = [json.loads(l) for l in lines if l.startswith("{")]
    assert printed == [written] and lines[-1] == "DIFFERENTIAL OK"


def test_cuda_device_without_a_card_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        differential.run(device="cuda", quick=True)


def _imports(path: pathlib.Path) -> set[str]:
    """Top-level names of every absolute import in the file, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


PORT_FILES = sorted(ROOT.glob("wah_tpu_torch/**/*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_wah_tpu(path):
    banned = {"jax", "jaxlib", "wah_tpu", "flax", "optax"}
    assert not (_imports(path) & banned), path
