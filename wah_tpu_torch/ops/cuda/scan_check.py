"""T1: the kernels' shared scans and warp search, run inside a kernel —
counterpart of the test-local Pallas kernel of tests/test_pallas.py
(test_wide_scans_match_flat).

`rows_scan` runs the scan and search functions of
wah_tpu_torch/csrc/common.cuh over whole rows: the block scans of threads
that own several elements each (sum and running maximum: K4's scan of its
window and its forward fill, decode.cu) and the 32-way warp search (K4's
and K6's). CUDA kernel wah_tpu_torch/csrc/scan_check.cu for a CUDA tensor,
`rows_scan_plain` (torch.cumsum, torch.cummax, torch.searchsorted) for a
CPU tensor. K1 and K5 scan by ballots and share none of these.
"""
from __future__ import annotations

import torch

from ._args import check, on_cpu

__all__ = ["rows_scan", "rows_scan_plain", "ROW_LEN"]

ROW_LEN = 2048  # a CTA of 256 threads, 8 elements each, takes a row in one pass


def _span(lo: int, hi: int | None) -> tuple[int, int]:
    hi = ROW_LEN if hi is None else hi
    if not 0 <= lo < hi <= ROW_LEN:
        raise ValueError(f"search span [{lo}, {hi}) is not inside [0, {ROW_LEN})")
    return lo, hi


def rows_scan_plain(
    x: torch.Tensor, keys: torch.Tensor, lo: int = 0, hi: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of rows_scan."""
    lo, hi = _span(lo, hi)
    csum = torch.cumsum(x, dim=1, dtype=torch.int32)
    cmax = torch.cummax(x, dim=1).values
    idx = torch.searchsorted(csum[:, lo:hi].contiguous(), keys, right=True) - 1 + lo
    return csum, cmax, idx.to(torch.int32)


def rows_scan(
    x: torch.Tensor, keys: torch.Tensor, lo: int = 0, hi: int | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (R, 2048) int32, keys (R, Q) int32 -> (cumsum (R, 2048), cummax
    (R, 2048), idx (R, Q)), all int32: the inclusive scans along each row,
    and idx[r, k] the largest i in [lo, hi) with cumsum[r, i] <= keys[r, k].

    The cumsum must not decrease over [lo, hi) (x >= 0 there) and every key
    must be at least cumsum[r, lo]; sums wrap in int32.
    """
    check(x, "x", (None, ROW_LEN))
    check(keys, "keys", (x.shape[0], None))
    lo, hi = _span(lo, hi)
    if on_cpu(x, keys):
        return rows_scan_plain(x, keys, lo, hi)
    if x.data_ptr() % 16:
        raise ValueError("x: the kernel loads 16 B vectors; pass a 16 B-aligned tensor")
    csum, cmax = torch.empty_like(x), torch.empty_like(x)
    idx = torch.empty_like(keys)
    if x.shape[0]:
        from ._build import launch

        launch(
            "wah_rows_scan", x.device, x.data_ptr(), keys.data_ptr(), csum.data_ptr(),
            cmax.data_ptr(), idx.data_ptr(), x.shape[0], keys.shape[1], lo, hi,
        )
        rows_scan.launches += 1
    return csum, cmax, idx


rows_scan.launches = 0
