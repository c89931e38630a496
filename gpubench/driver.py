"""What every traffic driver (gpubench/drivers/<driver>.py, class Driver)
provides to the harness.

A driver turns one configuration and one traffic file into operations on
the program. The harness calls, in order:

1. `make_inputs()`: the inputs, drawn from the seed on the device;
2. `prepare()`: the program's state and a warm-up of every shape the
   traffic uses (set-up);
3. `step(i)` for i = 0, 1, ... until the window closes: operation i
   through the program, returning (name, output, counts). `output` is what
   the check compares (kept only for a sample of the operations, drawn
   from the seed); `counts` are numbers the metrics read (work done, the
   program's own phase timings, sizes);
4. `free()`: the program's state released;
5. `check(ops, kept)`: {name: (value, limit)}, every number compared with
   the reference beside its limit.

`control_step(i)` answers operation i with the configuration's control
(gpubench/reference/control.py) in the program's place; only
`python -m gpubench.control` and the tests call it.
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import torch

# threads for the reference's NumPy work after the window (NumPy releases
# the interpreter lock in its loops)
REFERENCE_THREADS = 4


class Spans:
    """The benchmark's spans: a torch.profiler range named
    "<name>#<operation index>" while a trace is being taken, nothing
    otherwise."""

    def __init__(self):
        self.active = False
        self.index = 0

    def __call__(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"{name}#{self.index}")


class Driver:
    #: the span around each whole operation
    op_span = "op"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 span: Spans | None = None):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.span = span or Spans()

    def make_inputs(self) -> None:
        raise NotImplementedError

    def prepare(self) -> None:
        raise NotImplementedError

    def step(self, i: int):
        raise NotImplementedError

    def control_step(self, i: int):
        raise NotImplementedError

    def free(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self, ops, kept) -> dict:
        raise NotImplementedError

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def parallel_map(fn, items) -> list:
    """fn over items on REFERENCE_THREADS threads, results in order."""
    with ThreadPoolExecutor(REFERENCE_THREADS) as pool:
        return list(pool.map(fn, items))
