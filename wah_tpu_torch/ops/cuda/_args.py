"""Argument checks shared by the kernel wrappers, the device rule (a
tensor on the CPU takes the plain version, a CUDA tensor launches the
kernel, anything else raises), and the small int32 argument tensors the
pipelines build from Python ints."""
from __future__ import annotations

import torch


def check(t: torch.Tensor, name: str, shape: tuple) -> None:
    """Raise unless `t` is a contiguous int32 tensor of `shape` (None in
    `shape` matches any size)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if the tensors lie on the CPU (take the plain version), False if
    on one CUDA device (launch the kernel); raise for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def device_ints(values, device, dtype=torch.int32) -> torch.Tensor:
    """(len(values),) `dtype` on `device` holding the Python ints `values`,
    each written by a fill. torch.tensor(values, device=...) would copy
    them from pageable host memory, which a CUDA graph cannot capture; a
    fill carries its value in the launch, so a captured pipeline replays
    with the same arguments."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out
