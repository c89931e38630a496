"""Per-column offset rebasing shared by the batched encode and decode —
counterpart of wah_tpu/ops/pallas/common.py:rebase_exclusive_per_col."""
from __future__ import annotations

import torch

__all__ = ["rebase_exclusive_per_col"]


def rebase_exclusive_per_col(
    counts_flat: torch.Tensor, cols: int, percol: int, colcap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat per-row counts (cols*percol,) int32 -> (per-column EXCLUSIVE
    offsets rebased to the column bases c*colcap (cols*percol,), per-column
    totals (cols,)), both int32, from one flat cumsum. The caller keeps
    cols*colcap below 2^31."""
    cf = torch.cumsum(counts_flat, dim=0, dtype=torch.int32).view(cols, percol)
    ends = cf[:, -1]
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    base = torch.arange(cols, dtype=torch.int32, device=counts_flat.device) * colcap
    off = cf - counts_flat.view(cols, percol) + (base - starts)[:, None]
    return off.reshape(-1), ends - starts
