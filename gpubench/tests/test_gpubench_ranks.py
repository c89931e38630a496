"""The harness's ranks on the CPU (gpubench/rank.py): a stub cell on two or
four chips, added to a copy of the benchmark as data files alone, whose
driver (gpubench/tests/stub_cell/drivers/stub_gather.py) all-gathers a
small tensor over gloo. Every rank runs the same operations; an
operation that fails on one rank fails; a rank that ends or hangs ends
the run, with no result and no process left; the forbidden modules of a
rank are reported; the memory peak is the largest rank's. No test
changes a file that the copy had."""
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

from gpubench import harness, rank, run
from gpubench.tests.cells import REPO, SEED, copy_with_stub, files_of, rank_command

TIMEOUT_S, GRACE_S = 4.0, 2.0  # shortened waits, for the tests that end a run


def processes_naming(token: str) -> list[int]:
    """Live processes whose command line holds `token` (Linux: /proc)."""
    found = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit() and int(d.name) != os.getpid():
            try:
                if token.encode() in (d / "cmdline").read_bytes():
                    found.append(int(d.name))
            except OSError:
                continue
    return found


def left_behind(token: str, seconds: float = 5.0) -> list[int]:
    """The processes naming `token` still alive after up to `seconds`."""
    deadline = time.monotonic() + seconds
    while (left := processes_naming(token)) and time.monotonic() < deadline:
        time.sleep(0.05)
    return left


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """make(chips, **traffic): the stub cell in a copy of the benchmark at
    tmp_path/copy. The ranks' temporary directories, which their command
    lines name, go under tmp_path/t. Afterwards: no file the copy had was
    changed, and no rank process is left."""
    tmp = tmp_path / "t"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    copy = tmp_path / "copy"
    made = {}

    def make(chips, **traffic):
        name = copy_with_stub(copy, chips, **traffic)
        made["files"] = files_of(copy)
        return harness.load_cell(name, copy / "BENCHMARK.json", copy / "gpubench")

    make.copy, make.tmp = copy, tmp
    yield make
    if made:
        after = files_of(copy)
        assert all(after[k] == v for k, v in made["files"].items())
    assert not left_behind(str(tmp))


@pytest.mark.parametrize("chips", [2, 4])
def test_every_rank_runs_the_same_operations(stub, tmp_path, chips):
    counts = tmp_path / "counts"
    counts.mkdir()
    cell = stub(chips, count_dir=str(counts))
    r = harness.run_cell(cell, SEED, 0.5, False, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert r["device"]["count"] == chips
    # every rank's driver counted its own steps: the window's, after the warm-up
    ran = {p.name: json.loads(p.read_text())["ran"] for p in counts.iterdir()}
    assert ran == {str(k): r["attempted"] for k in range(chips)}


def test_a_step_that_raises_on_one_rank_fails_the_operation(stub):
    cell = stub(4, fail={"rank": 2, "step": 3, "how": "raise"})
    r = harness.run_cell(cell, SEED, 0.5, False, "cpu")
    assert r["attempted"] > 3 and r["failed"] == 1 and not r["correct"]
    assert r["checks"]["ops_failed"]["value"] == 1 and r["checks"]["values_wrong"]["value"] == 0


def test_the_memory_peak_is_the_largest_ranks(stub, monkeypatch):
    """On the CPU no peak is kept: each rank's reading is stubbed, rank 0's
    here and the others' in their processes."""
    monkeypatch.setattr(harness, "memory_peak", lambda device: 5)
    monkeypatch.setattr(rank, "COMMAND", rank_command(
        "import sys",
        "from gpubench import harness",
        "r = int(sys.argv[sys.argv.index('--rank') + 1])",
        "harness.memory_peak = lambda device: {1: 300, 2: 100, 3: 200}[r]"))
    r = harness.run_cell(stub(4), SEED, 0.3, False, "cpu")
    assert r["correct"] and r["device"]["memory_peak_bytes"] == 300


def _cpu_run(monkeypatch, copy, chips):
    """run.main as on a machine with `chips` cards, every rank on the CPU,
    the cell read from the copy's manifest."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: chips)
    load, run_cell = harness.load_cell, harness.run_cell
    monkeypatch.setattr(harness, "load_cell", lambda name: load(
        name, copy / "BENCHMARK.json", copy / "gpubench"))
    monkeypatch.setattr(harness, "run_cell", lambda cell, seed, seconds, trace, device, **kw:
                        run_cell(cell, seed, seconds, trace, "cpu", **kw))
    for var in run.CACHES:
        monkeypatch.setenv(var, "unset")


def test_a_forbidden_module_in_a_rank_is_reported(stub, monkeypatch, capsys):
    cell = stub(4, load_on_rank=3)
    _cpu_run(monkeypatch, stub.copy, 4)
    code = run.main(["--workload", cell.name, "--seed", str(SEED), "--seconds", "0.3",
                     "--trace", "0"])
    out, err = capsys.readouterr()
    assert code != 0 and not out.strip()
    assert "must not load: {'rank 3': ['jax']}" in err


# run.main in a process of its own, on the copy, as on a machine with four
# cards, with the waits shortened
RUN = f"""
import sys, torch
from gpubench import harness, rank, run
rank.TIMEOUT_S, rank.GRACE_S = {TIMEOUT_S}, {GRACE_S}
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 4
run_cell = harness.run_cell
harness.run_cell = lambda cell, seed, seconds, trace, device, **kw: run_cell(
    cell, seed, seconds, trace, "cpu", **kw)
sys.exit(run.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("how,seconds", [("exit", 30.0), ("hang", 3.0)])
def test_a_rank_that_ends_or_hangs_ends_the_run(stub, how, seconds):
    """A rank process that exits mid-window ends run.py at once (within
    the grace period), far before the window's end; one that hangs fails
    each operation after it by the timeout and the reports' wait ends the
    run. Either way: non-zero, no result line, no process left."""
    cell = stub(4, fail={"rank": 2, "step": 5, "how": how})
    t0 = time.monotonic()
    p = subprocess.run(
        [sys.executable, "-c", RUN, "--workload", cell.name, "--seed", str(SEED),
         "--seconds", str(seconds), "--trace", "0"],
        cwd=stub.copy, env={**os.environ, "PYTHONPATH": str(REPO), "TMPDIR": str(stub.tmp)},
        capture_output=True, text=True, timeout=120)
    took = time.monotonic() - t0
    assert p.returncode != 0 and not p.stdout.strip(), p.stderr[-3000:]
    assert not left_behind(str(stub.tmp))
    set_up = 20.0  # the ranks' start, on a loaded CPU
    if how == "exit":
        assert "rank 2 exited with code 3" in p.stderr
        assert took < set_up + TIMEOUT_S + GRACE_S < seconds
    else:  # the window, its last operation's wait, the reports' wait
        assert took < set_up + seconds + 2 * TIMEOUT_S + GRACE_S
