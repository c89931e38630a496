"""The least time the exchange between the cards could take: the bytes
that must reach one rank over the link's peak in one direction.

Counts are of the operation, not of the implementation: for the sharded
codec, every rank ends with the whole stream and the whole bitmap, so
what must reach a rank is the other ranks' live stream words and the
other ranks' live bitmap ints, 4 bytes each. Padding and a rank's own
shard are the implementation's, so a PR that stops gathering them reads
as a gain.

Peak: NVIDIA's data sheet for the H100 SXM5 80 GB: NVLink 4, 18 links,
900 GB/s in both directions together, 450 GB/s in each.
"""
from __future__ import annotations

LINK_BYTES_PER_S = 450e9  # NVLink 4, one direction


def exchange_bytes(n_ints: int, total: int, n_own: int, total_own: int) -> int:
    """Bytes that must reach a rank holding n_own of the bitmap's n_ints
    ints and total_own of its stream's total words."""
    return 4 * (total - total_own) + 4 * (n_ints - n_own)


def exchange_seconds(n_ints: int, total: int, n_own: int, total_own: int) -> float:
    return exchange_bytes(n_ints, total, n_own, total_own) / LINK_BYTES_PER_S
