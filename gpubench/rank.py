"""The ranks of a cell on more than one chip: rank 0 is the harness's own
process (`Ranks`), every other rank a process of its own:

    python3 -m gpubench.rank --cell FILE --seed N --rank R --world W \\
        --init file://DIR/rendezvous --device cuda|cpu --timeout S --parent PID

which `Ranks` starts; nobody else does. Each rank drives its own card
(cuda:R) or, in the tests, the CPU. The default torch.distributed group
spans the ranks (NCCL on CUDA, gloo on the CPU) and belongs to the
driver; a gloo side group carries the harness's own messages:

1. every rank builds the cell's Driver (gpubench/driver.py) and runs
   make_inputs() and prepare(); a barrier then opens the window;
2. before each operation rank 0 broadcasts its index, and every rank runs
   step(index); after the window it broadcasts STOP;
3. every other rank then sends rank 0 its report: how many operations it
   ran, the indices of those that raised with the first error, its
   device's memory peak and the forbidden modules it loaded; rank 0
   folds them into its own run (gpubench/harness.py).

Every wait has a timeout (TIMEOUT_S: the groups, the rendezvous, each
operation, the reports). Rank 0 watches the other processes: when one
exits before STOP, or no operation has ended for TIMEOUT_S + GRACE_S, it
stops the rest (terminate, then kill after GRACE_S) and, if its own
thread is stuck in a collective that will never end, exits the process
GRACE_S later. A rank process dies with rank 0 (PR_SET_PDEATHSIG).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import asdict
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from gpubench import harness

HERE = Path(__file__).resolve().parent
COMMAND = [sys.executable, "-m", "gpubench.rank"]
TIMEOUT_S = 120.0  # the longest any rank waits for another
GRACE_S = 10.0  # from terminate to kill, and for rank 0 to end after a rank's failure
POLL_S = 0.05
STOP = -1
EXIT_RANK_FAILED = 4


def init_groups(device: torch.device, init: str, world: int, rank: int, timeout: float):
    """Join the default group (NCCL on CUDA, gloo on the CPU) and return
    the gloo side group that carries the harness's messages."""
    t = timedelta(seconds=timeout)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank, timeout=t)
    return dist.new_group(backend="gloo", timeout=t)


def broadcast_index(index: int, side) -> int:
    """Rank 0's `index` on every rank of the side group."""
    t = torch.tensor([index], dtype=torch.int64)
    dist.broadcast(t, src=0, group=side)
    return int(t)


class Ranks:
    """Rank 0's side of a run on `cell.chips` ranks: starts the other rank
    processes and joins the groups on entry, commands each operation, and
    on exit leaves no rank process behind. `device` is rank 0's."""

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.world = cell.chips
        self.timeout, self.grace = TIMEOUT_S, GRACE_S
        self.procs: dict[int, subprocess.Popen] = {}
        self.failure: str | None = None
        self.side = None
        self._stopping = False  # STOP sent: a rank that exits cleanly now is done
        self._last: float | None = None  # monotonic time of the last command
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._watch = threading.Thread(target=self._watch_ranks, name="gpubench-ranks",
                                       daemon=True)
        self.dir = tempfile.mkdtemp(prefix="gpubench-ranks-")

    def __enter__(self):
        try:
            cell_file = Path(self.dir) / "cell.json"
            cell_file.write_text(json.dumps(asdict(self.cell), default=str))
            init = (Path(self.dir) / "rendezvous").as_uri()
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                [str(HERE.parent)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
            for r in range(1, self.world):
                args = ["--cell", str(cell_file), "--seed", str(self.seed), "--rank", str(r),
                        "--world", str(self.world), "--init", init,
                        "--device", self.device.type, "--timeout", str(self.timeout),
                        "--parent", str(os.getpid())]
                # stdout to our stderr: the result line stays the last of stdout
                self.procs[r] = subprocess.Popen([*COMMAND, *args], env=env, stdout=2)
            self._watch.start()
            self.side = init_groups(self.device, init, self.world, 0, self.timeout)
        except BaseException:
            self._close(ok=False)
            raise
        return self

    def __exit__(self, kind, exc, tb):
        self._close(ok=kind is None)
        if kind is not None and self.failure is not None:
            raise RankFailure(self.failure) from exc
        return False

    def ready(self) -> None:
        """Wait until every rank has prepared: the window opens after it."""
        dist.barrier(group=self.side)

    def command(self, index: int) -> None:
        """Every other rank runs operation `index` (STOP: leaves its loop)."""
        self._last = time.monotonic()
        broadcast_index(index, self.side)

    def finish(self) -> list[dict]:
        """STOP, then every other rank's report, in rank order, once each
        process has ended cleanly."""
        self._stopping = True
        self.command(STOP)
        reports: list = [None] * self.world
        dist.gather_object(None, reports, dst=0, group=self.side)
        self._last = None
        dist.destroy_process_group()
        for r, p in self.procs.items():
            code = p.wait(self.timeout)
            if code != 0:
                raise RankFailure(f"rank {r} exited with code {code} after its report")
        return reports[1:]

    def _close(self, ok: bool) -> None:
        if not ok and self.failure is None:
            self.failure = self._fault()  # a rank that died may be why rank 0 failed
        self._stopping = True
        self._done.set()  # the watch ends first: what is stopped now is no failure
        if self._watch.is_alive():
            self._watch.join()
        self._stop_processes()
        # after a failure an NCCL group may hold a collective that never
        # ends: leave it to the process's exit (gpubench/run.py)
        if dist.is_initialized() and (ok or dist.get_backend() == "gloo"):
            dist.destroy_process_group()
        shutil.rmtree(self.dir, ignore_errors=True)

    def _stop_processes(self) -> None:
        with self._lock:
            live = [p for p in self.procs.values() if p.poll() is None]
            for p in live:
                p.terminate()
            deadline = time.monotonic() + self.grace
            for p in live:
                try:
                    p.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    try:
                        p.wait(self.grace)
                    except subprocess.TimeoutExpired:
                        print(f"gpubench: rank process {p.pid} outlived SIGKILL",
                              file=sys.stderr, flush=True)

    def _fault(self) -> str | None:
        for r, p in self.procs.items():
            code = p.poll()
            if code is not None and (code != 0 or not self._stopping):
                return f"rank {r} exited with code {code}"
        last = self._last
        if last is not None and time.monotonic() - last > self.timeout + self.grace:
            return f"no operation ended within {self.timeout + self.grace} s"
        return None

    def _watch_ranks(self) -> None:
        while not self._done.wait(POLL_S):
            why = self._fault()
            if why is None:
                continue
            self.failure = why
            print(f"gpubench: {why}: stopping every rank", file=sys.stderr, flush=True)
            self._stop_processes()
            if not self._done.wait(self.grace):
                print(f"gpubench: rank 0 did not end within {self.grace} s of the failure",
                      file=sys.stderr, flush=True)
                shutil.rmtree(self.dir, ignore_errors=True)
                os._exit(EXIT_RANK_FAILED)
            return


class RankFailure(RuntimeError):
    """A rank process failed, or a rank stopped answering: no result."""


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when rank 0's process ends (Linux)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        sys.exit(EXIT_RANK_FAILED)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m gpubench.rank")
    p.add_argument("--cell", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), required=True)
    p.add_argument("--timeout", type=float, required=True)
    p.add_argument("--parent", type=int, required=True)
    args = p.parse_args(argv)
    _die_with_parent(args.parent)
    spec = json.loads(Path(args.cell).read_text())
    cell = harness.Cell(**{**spec, "root": Path(spec["root"])})
    device = torch.device("cuda", args.rank) if args.device == "cuda" else torch.device("cpu")
    side = init_groups(device, args.init, args.world, args.rank, args.timeout)
    module = harness.load_module(cell.root / "drivers" / f"{cell.traffic['driver']}.py")
    driver = module.Driver(cell.config, cell.traffic, args.seed, device,
                           rank=args.rank, world=args.world)
    driver.make_inputs()
    driver.prepare()
    driver.sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dist.barrier(group=side)
    ran, failed, first_error = 0, [], None
    while (i := broadcast_index(STOP, side)) != STOP:
        try:
            driver.step(i)
        except Exception as e:  # the loop keeps running: a failed operation is counted
            failed.append(i)
            if first_error is None:
                first_error = f"{type(e).__name__}: {e}"
                traceback.print_exc(file=sys.stderr)
        ran += 1
    driver.sync()
    report = {"rank": args.rank, "ran": ran, "failed": failed, "first_error": first_error,
              "memory_peak_bytes": harness.memory_peak(device)}
    driver.free()
    report["forbidden"] = harness.forbidden_modules()
    dist.gather_object(report, None, dst=0, group=side)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
