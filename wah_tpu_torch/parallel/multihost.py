"""Process-group bring-up and per-rank data placement for the sharded codec
— the port of wah_tpu/parallel/multihost.py on torch.distributed.

One process a rank, one rank a device. Nothing on a machine tells a
program of a cluster, so the rendezvous (init_method), the world size
and the rank come from the caller or from the usual environment
variables (MASTER_ADDR/MASTER_PORT with WORLD_SIZE, RANK, LOCAL_RANK):

    from wah_tpu_torch.parallel import ShardedCodec, multihost
    multihost.initialize("tcp://10.0.0.1:29500", world_size=4, rank=r)
    codec = ShardedCodec(group=multihost.global_group())  # this rank's card

The backend is a rule, not a guess: NCCL when every rank has a CUDA
device of its own, gloo otherwise (several ranks on one card, or the
CPU), in which case the gathers stage CUDA tensors through host memory
(_comm). Every wait on another process has a timeout.
"""
from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..constants import BLOCK_INTS
from ..convert import words_to_tensor
from ._comm import rank_and_size

__all__ = ["TIMEOUT", "choose_backend", "initialize", "global_group", "local_device",
           "host_shard_bitmap"]

TIMEOUT = timedelta(seconds=120)  # the longest a rank waits for the others


def choose_backend(world_size: int, kind: str = "cuda") -> str:
    """"nccl" when `world_size` ranks on `kind` devices each get a CUDA
    device of their own, "gloo" otherwise."""
    if kind == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def local_device(kind: str = "cuda", rank: int | None = None) -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK, else the rank) modulo the
    device count, or the CPU for kind "cpu". Raises without a CUDA device."""
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("local_device: no CUDA device")
    if rank is None:
        rank = int(os.environ.get("LOCAL_RANK", rank_and_size()[0]))
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    timeout: timedelta = TIMEOUT,
) -> str | None:
    """Bring up the default process group; return its backend, or None for
    a job of one process. A no-op when a group is already up, or when the
    world size (argument, else WORLD_SIZE, else 1) is 1. The backend
    defaults to choose_backend; under NCCL the rank's device is made
    current first."""
    if dist.is_initialized():
        return dist.get_backend()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return None
    if rank is None:
        rank = int(os.environ["RANK"])
    backend = backend or choose_backend(world_size)
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda", rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout)
    return backend


def global_group():
    """The group over every rank of the job (None when none is up: a world
    of one)."""
    return dist.group.WORLD if dist.is_initialized() else None


def host_shard_bitmap(host_ints: np.ndarray, device, group=None) -> torch.Tensor:
    """This rank's rows of the global (nb, 992) bitmap (nb a multiple of
    the world size; contiguous equal slices in rank order), flat on
    `device`: the ints_l that encode_sharded takes."""
    rows = np.asarray(host_ints, dtype=np.uint32).reshape(-1, BLOCK_INTS)
    rank, D = rank_and_size(group)
    if rows.shape[0] % D:
        raise ValueError(f"{rows.shape[0]} blocks do not split over {D} ranks")
    nb_l = rows.shape[0] // D
    return words_to_tensor(rows[rank * nb_l : (rank + 1) * nb_l].reshape(-1), device)
