"""Sharded WAH codec over torch.distributed — the port of wah_tpu.parallel.

One rank a device, the block axis split over the ranks in rank order; the
concatenated per-rank streams are the single-device stream (dist.py).
multihost.py brings the process group up; `python -m
wah_tpu_torch.parallel N` is the dry run over N spawned ranks
(dryrun.py). The reference's make_mesh has no counterpart: the group is
a torch.distributed process group, or None for a world of one.
"""
from . import multihost
from .dist import (
    ShardedCodec,
    compact_payload,
    decode_local,
    decode_sharded,
    encode_local,
    encode_sharded,
    estimate_word_cap,
    gather_bitmap,
    gather_stream,
    stitch_global,
    stitch_word_cap,
)

__all__ = [
    "multihost",
    "ShardedCodec",
    "encode_local",
    "encode_sharded",
    "stitch_global",
    "compact_payload",
    "stitch_word_cap",
    "estimate_word_cap",
    "gather_stream",
    "decode_local",
    "decode_sharded",
    "gather_bitmap",
]
