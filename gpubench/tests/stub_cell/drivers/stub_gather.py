"""A stub driver for the tests of a cell on more than one chip: every rank
holds a float64 slice of `values` drawn from the seed and its rank, and
operation i all-gathers the slices rolled by i over the default group
(torch.distributed.all_gather, gloo on the CPU, NCCL on cards). Rank 0's
gathered (world, values) tensor is checked against the slices drawn
again, exactly; the control computes them in float32.

traffic params, all optional, for the tests:
  "fail": {"rank": r, "step": i, "how": "raise" | "exit" | "hang"}: on
      rank r, after the gather of operation i;
  "load_on_rank": r: a module named jax put into rank r's sys.modules;
  "count_dir": a directory into which each rank writes, at free(), how
      many operations it ran and its device's memory peak (file <rank>,
      JSON);
  "scratch_mb": rank r holds (r + 1) * scratch_mb MiB more on its device.
"""
from __future__ import annotations

import json
import os
import sys
import time
import types
from pathlib import Path

import torch
import torch.distributed as dist

from gpubench.driver import Driver as Base


def drawn(seed: int, rank: int, n: int) -> torch.Tensor:
    """Rank `rank`'s slice, float64, on the CPU."""
    g = torch.Generator().manual_seed((seed * 1000003 + rank) % (1 << 63))
    return torch.rand(n, generator=g, dtype=torch.float64)


class Driver(Base):
    op_span = "stub.gather"

    def make_inputs(self) -> None:
        self.n = int(self.config["values"])
        self.slice = drawn(self.seed, self.rank, self.n).to(self.device)
        self.ran = 0

    def prepare(self) -> None:
        mb = int(self.traffic.get("scratch_mb", 0))
        self.scratch = torch.zeros((self.rank + 1) * mb << 20, dtype=torch.uint8,
                                   device=self.device)
        if self.traffic.get("load_on_rank") == self.rank:
            sys.modules["jax"] = types.ModuleType("jax")
        self.step(0)
        self.ran = 0

    def step(self, i: int):
        out = torch.zeros(self.world, self.n, dtype=torch.float64, device=self.device)
        dist.all_gather(list(out.unbind(0)), torch.roll(self.slice, i))
        self.ran += 1
        fail = self.traffic.get("fail")
        if fail and fail["rank"] == self.rank and fail["step"] == i:
            if fail["how"] == "exit":
                os._exit(3)
            if fail["how"] == "hang":
                time.sleep(3600)
            raise RuntimeError(f"stub: operation {i} fails on rank {self.rank}")
        return "gather", (i, out), {"bytes": 8 * self.world * self.n}

    def control_step(self, i: int):
        rows = [torch.roll(drawn(self.seed, r, self.n).float(), i) for r in range(self.world)]
        return "gather", (i, torch.stack(rows).double()), {"bytes": 8 * self.world * self.n}

    def free(self) -> None:
        if "count_dir" in self.traffic:
            peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
            Path(self.traffic["count_dir"], str(self.rank)).write_text(
                json.dumps({"ran": self.ran, "memory_peak_bytes": peak}))
        self.scratch = None
        super().free()

    def check(self, ops, kept) -> dict:
        slices = [drawn(self.seed, r, self.n) for r in range(self.world)]
        wrong = 0
        for _, (i, out) in kept:
            want = torch.stack([torch.roll(s, i) for s in slices])
            wrong += int((out.cpu() != want).sum())
        return {"values_wrong": (wrong, 0)}
