"""The one collective the sharded codec needs: gather equal-sized tensors
from every rank, in rank order.

The backend decides where the gather runs. NCCL gathers on the device.
Any other backend (gloo) takes only host tensors, so a CUDA tensor is
staged through host memory: copied out, gathered, copied back. That is
the rule for several ranks on one card, which NCCL refuses. The backend
is read from the group, never guessed. Under a group the collective runs
even at a world size of 1, so that a one-rank group drives the same
route as a larger one; only with no group up is the gather the identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.profiling import span

__all__ = ["rank_and_size", "all_gather"]


def rank_and_size(group=None) -> tuple[int, int]:
    """(this rank, world size) of `group`; (0, 1) when no process group is up."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(k,) tensor, the same k on every rank -> (D, k) on t's device, row d
    being rank d's tensor. With no process group up the result is a view
    of `t`. all_gather.routes counts the collectives by route: "device"
    (NCCL), "staged" (a CUDA tensor through host memory), "host". Each
    collective is a wah.gather span, counting its route and the bytes it
    delivered to this rank (all D rows, its own included)."""
    if not dist.is_initialized():
        return t[None]
    t = t.contiguous()
    staged = t.device.type == "cuda" and dist.get_backend(group) != dist.Backend.NCCL
    route = "staged" if staged else "device" if t.is_cuda else "host"
    with span("wah.gather", route=route) as s:
        src = t.cpu() if staged else t
        out = src.new_empty((dist.get_world_size(group), *src.shape))
        dist.all_gather(list(out.unbind(0)), src, group=group)
        all_gather.routes[route] += 1
        out = out.to(t.device)
        s.set(bytes=out.numel() * out.element_size())
    return out


all_gather.routes = {"device": 0, "staged": 0, "host": 0}
