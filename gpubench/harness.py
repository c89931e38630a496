"""Run one cell of BENCHMARK.json once: set-up, a closed-loop window of
operations on the program, the check against the reference, the metrics.

Everything that belongs to one cell is found by name, so a later PR adds
a configuration, a traffic mix or a metric as new files and manifest
entries, never by editing a file here:

  configs/<config>.json           the deployment's sizes and guarantees
  traffic/<traffic>.json          the mix: its driver, parameters, sample
                                  sizes, and how each end-to-end metric is
                                  taken from the window's operations
  drivers/<driver>.py             class Driver (gpubench/driver.py)
  stats/<stat>.py                 value(ops, window_s, params): an
                                  end-to-end metric from the window
  layer_metrics/<metric>.py       read(ctx): a per-layer metric from the
                                  traced window, or None where it finds
                                  nothing to read
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import random
import shutil
import sys
import tempfile
import time
import traceback
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import activity
from .driver import Spans

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "wah_tpu")
SETUP_METRIC = "setup_s"
TOP = 10  # entries in each list of the breakdown


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path = HERE


@dataclass
class Op:
    """One operation of the window: host clock start and end (seconds),
    what the driver counted, and the error it raised, if any."""

    index: int
    name: str
    t0: float
    t1: float
    counts: dict = field(default_factory=dict)
    error: str | None = None


@dataclass
class Context:
    """What a per-layer metric reads: every operation of the window; from
    the traced part of it the benchmark's spans, the traced window and the
    device's busy time in it (microseconds) and the operations traced;
    and the window's seconds an operation once the trace had closed."""

    ops: list
    spans: list
    window_us: float
    busy_us: float
    n_traced: int = 0
    untraced_op_s: float | None = None

    def spans_named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def idle_percent(self):
        """The device's idle share of the untraced window: 100 minus the
        device's busy time an operation, from the trace, over the window's
        time an operation after it. The profiler slows the host's issue of
        work, not the device's work, so the traced window's own idle share
        reads the profiler's cost as idle time."""
        if self.busy_us <= 0 or not self.n_traced or not self.untraced_op_s:
            return None
        return 100.0 * (1.0 - self.busy_us * 1e-6 / self.n_traced / self.untraced_op_s)


def load_module(path: Path):
    """A module from a file path (metric files carry dots in their names)."""
    name = "gpubench_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, manifest_path: Path = MANIFEST, root: Path = HERE) -> Cell:
    """The cell `name` of the manifest, with its configuration and traffic
    files read and the metrics it reports picked out."""
    manifest = json.loads(Path(manifest_path).read_text())
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {manifest_path}: {sorted(entries)}")
    w = entries[name]
    config = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in manifest["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer, root)


class Reservoir:
    """A uniform sample of `k` of the window's outputs, drawn from the seed
    while the count is still unknown (reservoir sampling): the outputs the
    check compares in full. Dropping one frees it."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.items: list = []

    def offer(self, index: int, output) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((index, output))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = (index, output)


def process_age_s() -> float | None:
    """Seconds since this process started (Linux: /proc), or None."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _profiler(device: torch.device):
    # one start and stop a profiler: its note that a cycle's end clears the
    # events says nothing here
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _read_trace(prof, device, ops, trace_from, trace_to):
    """Export the trace to a fresh temporary directory, read it, delete it."""
    tmp = tempfile.mkdtemp(prefix="gpubench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = activity.read_events(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    merged = activity.union((a, b) for a, b, _ in activity.device_intervals(events))
    spans = activity.benchmark_spans(events, merged)
    traced = [s for s in spans if trace_from <= s.index < trace_to]
    after = ops[trace_to:]
    untraced_op_s = (after[-1].t1 - after[0].t0) / len(after) if after else None
    if not traced:
        return Context(ops, [], 0.0, 0.0), {"device_ops": [], "idle_gaps": []}
    lo = min(s.t0 for s in traced)
    hi = max(s.t1 for s in traced)
    act = activity.device_activity(events, lo, hi)
    by_label: dict[str, float] = {}
    for name, us, _ in act["ops"]:
        label = activity.op_label(name)
        by_label[label] = by_label.get(label, 0.0) + us
    device_ops = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
    idle = activity.idle_by_span(merged, lo, hi, traced)[:TOP]
    breakdown = {
        "device_ops": [[n, us * 1e-6] for n, us in device_ops],
        "idle_gaps": [[n, us * 1e-6] for n, us in idle],
    }
    n_traced = len({s.index for s in traced})
    return (Context(ops, traced, act["window_us"], act["busy_us"], n_traced, untraced_op_s),
            breakdown)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float | None = None) -> dict:
    """One run of `cell` on `device`: the result line as a dict.
    `started`: time.perf_counter() at the process's start, where /proc
    cannot tell it."""
    device = torch.device(device)
    traffic = cell.traffic
    module = load_module(cell.root / "drivers" / f"{traffic['driver']}.py")
    spans = Spans()
    driver = module.Driver(cell.config, traffic, seed, device, spans)
    driver.make_inputs()
    driver.prepare()
    trace_from = int(traffic.get("trace_skip", 1))
    trace_to = trace_from + int(traffic.get("trace_ops", 8))
    prof = None
    if trace:  # the profiler's own first start, outside the window
        prof = _profiler(device)
        prof.start()
        prof.stop()
        prof = _profiler(device)
    driver.sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    reservoir = Reservoir(int(traffic["check_sample"]), seed)
    ops: list[Op] = []
    age = process_age_s()
    t_start = time.perf_counter()
    if age is not None:
        setup_s = age
    else:
        setup_s = t_start - started if started is not None else math.nan
    deadline = t_start + seconds
    i = 0
    while time.perf_counter() < deadline:
        if prof is not None and i == trace_from:
            prof.start()
            spans.active = True
        spans.index = i
        t0 = time.perf_counter()
        try:
            with spans(driver.op_span):
                name, output, counts = driver.step(i)
        except Exception as e:  # the loop keeps running: a failed operation is counted
            name, output, counts = "failed", None, {}
            err = f"{type(e).__name__}: {e}"
            if not any(op.error for op in ops):
                traceback.print_exc(file=sys.stderr)
        else:
            err = None
        t1 = time.perf_counter()
        ops.append(Op(i, name, t0, t1, counts, err))
        if err is None:
            reservoir.offer(i, output)
        i += 1
        if spans.active and i == trace_to:
            driver.sync()
            prof.stop()
            spans.active = False
    if spans.active:
        driver.sync()
        prof.stop()
        spans.active = False
    window_s = (ops[-1].t1 - t_start) if ops else 0.0
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    ctx, breakdown = (None, None)
    if prof is not None:
        ctx, breakdown = _read_trace(prof, device, ops, trace_from, trace_to)
    driver.free()
    failed = sum(1 for op in ops if op.error)
    checks = {"ops_failed": (failed, 0)}
    checks.update(driver.check([op for op in ops if not op.error], reservoir.items))
    correct = bool(ops) and all(v <= lim for v, lim in checks.values())

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == SETUP_METRIC:
                value = setup_s
            else:
                how = traffic["end_to_end"][m["name"]]
                stat = load_module(cell.root / "stats" / f"{how['stat']}.py")
                value = stat.value([op for op in ops if not op.error], window_s, how)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            reader = load_module(cell.root / "layer_metrics" / f"{m['name']}.py")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": memory_peak,
    }
    if trace:
        dev["busy_s"] = ctx.busy_us * 1e-6
        dev["window_s"] = ctx.window_us * 1e-6
    result = {"correct": correct, "attempted": len(ops), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
