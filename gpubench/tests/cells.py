"""What the tests read of each cell, from the cell's own files: the cells
of the manifest; each cut to a test's size by the "tests" key of its
traffic file ("cpu", "card"); the faults its timed path can have
("faults": a planter in gpubench/tests/faults/ and its cases), planted
under a whole run, rank processes included; and a copy of the benchmark
with a stub cell added as new files and manifest entries alone."""
from __future__ import annotations

import dataclasses
import json
import shutil
import sys
import types
from pathlib import Path

from gpubench import harness

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SEED = 2**31 + 12345
STUB = Path(__file__).resolve().parent / "stub_cell"


def sizes_of(name: str) -> dict | None:
    """The "tests" key of the cell's traffic file, None without one."""
    return harness.load_cell(name).traffic.get("tests")


# the cells that state their test sizes; test_each_cell_states_its_test_sizes
# fails, naming the key, for any other
SIZED = [name for name in CELLS if sizes_of(name) is not None]
FAULTS = [(name, fault) for name in SIZED
          for fault in sizes_of(name).get("faults", {}).get("cases", [])]


def small_cell(name: str, where: str = "cpu") -> harness.Cell:
    """The cell with its "tests"[where] overrides of configuration and
    traffic applied."""
    cell = harness.load_cell(name)
    sizes = cell.traffic["tests"][where]
    return dataclasses.replace(cell, config={**cell.config, **sizes.get("config", {})},
                               traffic={**cell.traffic, **sizes.get("traffic", {})})


def planter_path(cell: harness.Cell) -> Path:
    return cell.root / "tests" / "faults" / f"{cell.traffic['tests']['faults']['planter']}.py"


def break_drivers(harness_module, planter: str, fault: str, set_attr) -> None:
    """Make every driver that `harness_module` loads plant `fault` (the
    planter file's plant(fault, setattr)) once its prepare() has run: set-up
    sound, the window's operations broken. `set_attr`: monkeypatch.setattr
    in a test's process, setattr in a rank process."""
    plant = harness_module.load_module(Path(planter)).plant
    load = harness_module.load_module

    def load_broken(path):
        module = load(path)
        if path.parent.name != "drivers":
            return module

        class Broken(module.Driver):
            def prepare(self):
                super().prepare()
                plant(fault, set_attr)

        return types.SimpleNamespace(Driver=Broken)

    set_attr(harness_module, "load_module", load_broken)


def rank_command(*lines: str) -> list[str]:
    """A rank process's command (gpubench.rank.COMMAND) that runs `lines`
    of Python first."""
    run = 'import runpy; runpy.run_module("gpubench.rank", run_name="__main__", alter_sys=True)'
    return [sys.executable, "-c", "\n".join([*lines, run])]


def break_timed_path(monkeypatch, cell: harness.Cell, fault: str) -> None:
    """Plant `fault` after set-up in this process and in every rank process
    that a run of `cell` starts."""
    from gpubench import rank

    planter = str(planter_path(cell))
    break_drivers(harness, planter, fault, monkeypatch.setattr)
    monkeypatch.setattr(rank, "COMMAND", rank_command(
        "from gpubench import harness",
        "from gpubench.tests.cells import break_drivers",
        f"break_drivers(harness, {planter!r}, {fault!r}, setattr)"))


def copy_with_stub(tmp_path: Path, chips: int, **traffic) -> str:
    """A copy of the benchmark at tmp_path (BENCHMARK.json, gpubench/) with
    one stub cell on `chips` chips added as new files and manifest entries
    alone, its traffic file updated by `traffic`; returns the cell's name.
    One chip: the device cell's driver at 2 blocks; more: the stub driver
    gpubench/tests/stub_cell/drivers/stub_gather.py, which all-gathers a
    small tensor over the ranks."""
    root = tmp_path / "gpubench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    kind = "device" if chips == 1 else "gather"
    config, name = f"stub-{kind}", f"stub-{kind}-{chips}"
    shutil.copy(STUB / "configs" / f"{config}.json", root / "configs" / f"{config}.json")
    t = json.loads((STUB / "traffic" / f"{config}.json").read_text())
    (root / "traffic" / f"{name}.json").write_text(json.dumps({**t, **traffic}, indent=2))
    shutil.copy(STUB / "layer_metrics" / "stub.op_ms.py", root / "layer_metrics")
    if chips > 1:
        shutil.copy(STUB / "drivers" / "stub_gather.py", root / "drivers")
        shutil.copy(STUB / "faults" / "stub_gather.py", root / "tests" / "faults")
    manifest["configs"].append({"name": config, "source": "https://example.org/stub",
                                "file": f"gpubench/configs/{config}.json", "reduced": [],
                                "why": "a stub"})
    manifest["workloads"].append({"name": name, "config": config, "traffic": name,
                                  "chips": chips, "why": "a stub"})
    if chips == 1:
        e2e = "device_GBps"
        next(m for m in manifest["end_to_end"] if m["name"] == e2e)["workloads"].append(name)
    else:
        e2e = "stub_GBps"
        manifest["end_to_end"].append({"name": e2e, "unit": "GB/s", "better": "higher",
                                       "bound": 0.1, "source": "host_clock",
                                       "workloads": [name]})
    manifest["per_layer"].append({"name": "stub.op_ms", "unit": "ms", "better": "lower",
                                  "source": "host_clock", "layer": "stub", "moves": e2e,
                                  "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest, indent=2))
    return name


def files_of(root: Path) -> dict:
    """Every file under root but Python's caches: {relative path: bytes}."""
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}
