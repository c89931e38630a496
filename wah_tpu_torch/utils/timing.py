"""Phase timing — the port's counterpart of wah_tpu.utils.timing, after
the reference's cudaEvent timer macros (reference: timeMeasuring.h:11-28).

Three phases per direction, as the reference reports them
(compress.h:16-18): transfer to the device, kernel, transfer back. On a
CUDA device every phase is timed with torch.cuda.Event pairs on the
current stream; on the CPU with a wall clock. Given a span prefix, each
phase is also the span "<prefix>.<phase>" while a profiler records
(utils.profiling.span), opened by start and closed by stop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from . import profiling


@dataclass
class PhaseTimings:
    """Milliseconds per phase, reference CSV column parity
    (source.cpp:38-48)."""

    to_device_ms: float = 0.0
    kernel_ms: float = 0.0
    from_device_ms: float = 0.0

    def as_tuple(self) -> tuple[float, float, float]:
        return (self.to_device_ms, self.kernel_ms, self.from_device_ms)


@dataclass
class PhaseTimer:
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    timings: PhaseTimings = field(default_factory=PhaseTimings)
    span: str | None = None
    _t0: float = 0.0
    _ev0: object = None
    _span: object = None

    def start(self, phase: str | None = None, **counts) -> None:
        """Start timing a phase; with a span prefix and the phase's name,
        open its span first (counts: its numbers known now)."""
        if self.span is not None and phase is not None:
            self._span = profiling.span(f"{self.span}.{phase}", **counts)
            self._span.__enter__()
        if self.device.type == "cuda":
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()

    def stop(self, phase: str, **counts) -> float:
        """End the phase: its ms, kept in `timings`; then close the span
        that start opened (counts: its numbers known only now)."""
        if self.device.type == "cuda":
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(torch.cuda.current_stream(self.device))
            ev1.synchronize()
            ms = self._ev0.elapsed_time(ev1)
        else:
            ms = (time.perf_counter() - self._t0) * 1e3
        setattr(self.timings, f"{phase}_ms", ms)
        if self._span is not None:
            self._span.set(**counts)
            self._span.__exit__(None, None, None)
            self._span = None
        return ms
