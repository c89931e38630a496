"""Import isolation, read from the sources: nothing under gpubench/ imports
JAX or the JAX package (wah_tpu), nothing imports the JAX package's
benchmarks (benchmarks/, bench.py), and the reference imports nothing of
the program. Names are compared by their part before the first dot, whole,
so that wah_tpu_torch is not taken for wah_tpu."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted(ROOT.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "wah_tpu"}
JAX_BENCHMARKS = {"benchmarks", "bench"}


def imported_tops(path: Path) -> set[str]:
    """Top-level names of every module the file imports, at any depth of
    its code (relative imports stay inside gpubench)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_sources_found():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"run.py", "harness.py", "reference/wah.py", "layer_metrics/encode.roofline.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_jax_benchmarks(path):
    tops = imported_tops(path)
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    assert not tops & JAX_BENCHMARKS, f"{path} imports {tops & JAX_BENCHMARKS}"


@pytest.mark.parametrize(
    "path", sorted((ROOT / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "wah_tpu_torch" not in tops
    assert tops <= {"__future__", "numpy"}, tops


def test_the_run_checks_the_same_names():
    from gpubench import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
