"""K1 block encoder, K6 gather stitch and K5 fused encode — counterpart
of wah_tpu/ops/pallas/encode_kernel.py.

`encode_tiles` (K1) encodes each 992-int block into its WAH words: CUDA
kernel wah_tpu_torch/csrc/encode.cu for a CUDA tensor,
`encode_tiles_plain` for a CPU tensor. K1 and K5 share the per-block
encode of csrc/encode_block.cuh, built for a kernel that memory bounds
on paper and latency in practice: CTAs of 128 threads, eight chunks a
thread, the block's ints copied by cp.async into a two-stage staging,
run starts and fill lengths from ballots, the block's row compacted in
shared memory and stored 16 B a thread. `stitch_tiles` (K6) lays the
blocks' words into the dense stream tile by output tile
(wah_tpu_torch/csrc/stitch_gather.cu), with K2's contract plus a zeroed
last tile. `encode_padded` is the encode pipeline, K1 -> exclusive scan
of the counts (torch.cumsum, outside the kernels as in wah_tpu) -> K2
(K6 on request); `encode_rows_batch` the same over batched columns (K1
with a per-column position mask, K2 with per-row counts). `encode_fused` (K5)
is the whole single-stream pipeline in one kernel
(wah_tpu_torch/csrc/encode_fused.cu: no staging array, the scan of the
counts done inside the kernel by a decoupled look-back over tiles of
FUSED_TILE_BLOCKS blocks, a tile's look-back deferred behind the encode
of its CTA's next tile), and
`encode_padded_fused` its `encode_padded`; as in wah_tpu the codec never
selects it, it is an independent implementation to check the pipeline
against. Each `_plain` twin runs the same pipeline through the plain
versions.
"""
from __future__ import annotations

import torch

from ...constants import BLOCK_CHUNKS, BLOCK_INTS
from ...utils.profiling import span
from .. import bits
from ..encode import encode_blocks
from ._args import check, device_ints, on_cpu
from ._batch import rebase_exclusive_per_col
from .stitch2 import stitch_tiles_plain, stitch_tiles_v2

__all__ = [
    "encode_tiles",
    "encode_tiles_plain",
    "stitch_tiles",
    "encode_padded",
    "encode_padded_plain",
    "encode_fused",
    "encode_fused_plain",
    "encode_padded_fused",
    "encode_padded_fused_plain",
    "check_fused_error",
    "encode_padded_batch",
    "encode_rows_batch",
    "encode_rows_batch_plain",
]

_IDENTITY_MASK = 0x7FFFFFFF
# blocks to a tile of K5's look-back: kTileBlocks of csrc/encode_fused.cu
FUSED_TILE_BLOCKS = 3


def _nv3(nv: torch.Tensor) -> torch.Tensor:
    """[bound, chunk_base] or [bound, chunk_base, pos_mask] -> the 3-entry form."""
    if nv.dim() != 1 or nv.shape[0] not in (2, 3):
        raise ValueError(f"nv: expected (2,) or (3,), got {tuple(nv.shape)}")
    if nv.shape[0] == 2:
        nv = torch.cat([nv, nv.new_full((1,), _IDENTITY_MASK)])
    return nv.to(torch.int32).contiguous()


def _check_aligned(ints2d: torch.Tensor) -> None:
    if ints2d.data_ptr() % 16:
        raise ValueError("ints2d: the kernel copies 16 B vectors; pass a 16 B-aligned tensor")


def encode_tiles_plain(
    ints2d: torch.Tensor, nv: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of encode_tiles."""
    bound, base, mask = _nv3(nv).tolist()
    chunks = bits.repartition_chunks(ints2d)
    staging, counts = encode_blocks(chunks, bound, base, mask)
    return staging, counts[:, None]


def encode_tiles(
    ints2d: torch.Tensor, nv: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(nb, 992) int32 bitmap blocks + nv = [bound, chunk_base(, pos_mask)]
    int32 -> (staging (nb, 1024) int32, counts (nb, 1) int32).

    Chunk k of block b is valid when ((chunk_base + 1024 b + k) & pos_mask)
    < bound; invalid chunks emit nothing. Row b of staging holds block b's
    words as a dense prefix of counts[b] words, zero after it.
    """
    check(ints2d, "ints2d", (None, BLOCK_INTS))
    nv = _nv3(nv)
    if on_cpu(ints2d, nv):
        return encode_tiles_plain(ints2d, nv)
    _check_aligned(ints2d)
    nb = ints2d.shape[0]
    staging = torch.empty((nb, BLOCK_CHUNKS), dtype=torch.int32, device=ints2d.device)
    counts = torch.empty((nb, 1), dtype=torch.int32, device=ints2d.device)
    if nb:
        from ._build import launch

        launch(
            "wah_encode_tiles", ints2d.device, ints2d.data_ptr(), nv.data_ptr(),
            staging.data_ptr(), counts.data_ptr(), nb,
        )
        encode_tiles.launches += 1
    return staging, counts


encode_tiles.launches = 0


def stitch_tiles(staging: torch.Tensor, offsets_ext: torch.Tensor) -> torch.Tensor:
    """(nb, 1024) int32 staging rows + exclusive word offsets (nb+1,) int32,
    offsets_ext[nb] = total -> (nb*1024,) int32 stream: row b's first
    offsets_ext[b+1] - offsets_ext[b] words land at offsets_ext[b]; the
    words of the last partial 1024-word tile past the total are zero, and
    words past that tile are unspecified.

    The plain version is stitch2.stitch_tiles_plain: it zeroes everything
    past the total, which meets this contract.
    """
    nb = staging.shape[0]
    check(staging, "staging", (None, BLOCK_CHUNKS))
    check(offsets_ext, "offsets_ext", (nb + 1,))
    if on_cpu(staging, offsets_ext):
        return stitch_tiles_plain(staging, offsets_ext)
    out = torch.empty(nb * BLOCK_CHUNKS, dtype=torch.int32, device=staging.device)
    if nb:
        from ._build import launch

        launch(
            "wah_stitch_gather", staging.device, staging.data_ptr(), offsets_ext.data_ptr(),
            out.data_ptr(), nb,
        )
        stitch_tiles.launches += 1
    return out


stitch_tiles.launches = 0

STITCHES = ("v1", "v3")


def _blocks_and_nv(ints, n_valid_chunks: int, chunk_base: int):
    """(nb*992,) ints -> ((nb, 992) view, nv = [bound, chunk_base]), the bound
    clamped to this call's blocks (wah_tpu encode_kernel._clamped_nv): a
    shard's padding rows must not count as valid."""
    if ints.dim() != 1 or ints.shape[0] % BLOCK_INTS:
        raise ValueError(f"expected (nb*{BLOCK_INTS},) ints, got {tuple(ints.shape)}")
    nb = ints.shape[0] // BLOCK_INTS
    bound = min(n_valid_chunks, chunk_base + nb * BLOCK_CHUNKS)
    return ints.view(nb, BLOCK_INTS), device_ints([bound, chunk_base], ints.device)


def _encode_padded(ints, n_valid_chunks: int, chunk_base: int, stitch: str, tiles, v3, v1):
    if stitch not in STITCHES:
        raise ValueError(f"stitch must be one of {STITCHES}, got {stitch!r}")
    with span("wah.encode"):
        ints2d, nv = _blocks_and_nv(ints, n_valid_chunks, chunk_base)
        staging, counts = tiles(ints2d, nv)
        offsets_ext = torch.cat(
            [counts.new_zeros(1), torch.cumsum(counts[:, 0], dim=0, dtype=torch.int32)]
        )
        total = offsets_ext[-1]
        return (v1 if stitch == "v1" else v3)(staging, offsets_ext), total


def encode_padded(
    ints: torch.Tensor, n_valid_chunks: int, chunk_base: int = 0, stitch: str = "v3"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress a block-aligned (nb*992,) int32 bitmap whose first
    `n_valid_chunks` chunks are live (chunk_base: global index of its
    first chunk). Returns (words (nb*1024,), total int32 0-dim on the
    device, no host read); words past total are unspecified.

    stitch: "v3" (the default) runs K2, "v1" K6. wah_tpu's default picks
    K6 for sparse streams on a host read of the total; on the H100 K6
    loses on dense stagings and is within a few microseconds of K2 on
    sparse ones, which does not pay for that read, so the port takes K2,
    and K6 stays as the port of wah_tpu's stitch_tiles for the
    differential and its tests.
    """
    return _encode_padded(
        ints, n_valid_chunks, chunk_base, stitch, encode_tiles, stitch_tiles_v2, stitch_tiles
    )


def encode_padded_plain(
    ints: torch.Tensor, n_valid_chunks: int, chunk_base: int = 0, stitch: str = "v3"
) -> tuple[torch.Tensor, torch.Tensor]:
    """encode_padded through the plain versions, on any device (both
    stitches have the one plain version)."""
    return _encode_padded(
        ints, n_valid_chunks, chunk_base, stitch, encode_tiles_plain, stitch_tiles_plain,
        stitch_tiles_plain,
    )


def encode_fused_plain(
    ints2d: torch.Tensor, nv: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of encode_fused: the plain block encode, a cumsum
    of its counts, the plain stitch (zeros past the total)."""
    staging, counts = encode_tiles_plain(ints2d, nv)
    offsets_ext = torch.cat(
        [counts.new_zeros(1), torch.cumsum(counts[:, 0], dim=0, dtype=torch.int32)]
    )
    return stitch_tiles_plain(staging, offsets_ext), counts


def _fused(ints2d: torch.Tensor, nv: torch.Tensor):
    """encode_fused and the total as a 0-dim int32 tensor on the same device
    (no host sync): the last tile's inclusive prefix, a view of the kernel's
    workspace, or on the CPU the sum of the counts."""
    check(ints2d, "ints2d", (None, BLOCK_INTS))
    check(nv, "nv", (2,))
    if on_cpu(ints2d, nv):
        words, counts = encode_fused_plain(ints2d, nv)
        return words, counts, counts.sum(dtype=torch.int32)
    _check_aligned(ints2d)
    nb, dev = ints2d.shape[0], ints2d.device
    words = torch.empty(nb * BLOCK_CHUNKS, dtype=torch.int32, device=dev)
    counts = torch.empty((nb, 1), dtype=torch.int32, device=dev)
    if not nb:
        return words, counts, counts.sum(dtype=torch.int32)
    from ._build import launch

    # 64-bit words, seen as int32 pairs (low half first): the ticket, the
    # error flag, one descriptor per tile of FUSED_TILE_BLOCKS blocks; zeroed
    # on the launch's stream, so a launch never meets a stale one. The flag
    # and the total (the low half of the last tile's descriptor, its
    # inclusive prefix) are views: no kernel beside K5 and the zeroing.
    n_tiles = -(-nb // FUSED_TILE_BLOCKS)
    ws = torch.zeros(2 * (n_tiles + 2), dtype=torch.int32, device=dev)
    launch(
        "wah_encode_fused", dev, ints2d.data_ptr(), nv.data_ptr(), words.data_ptr(),
        counts.data_ptr(), ws.data_ptr(), nb, n_tiles + 2,
    )
    encode_fused.launches += 1
    encode_fused.error = ws[2]
    return words, counts, ws[2 * (n_tiles + 1)]


def encode_fused(
    ints2d: torch.Tensor, nv: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(nb, 992) int32 bitmap blocks + nv = [bound, chunk_base] int32 ->
    (words (nb*1024,) int32, counts (nb, 1) int32): the dense stream as a
    prefix of `words` (what is past counts.sum() is unspecified) and each
    block's word count. Chunk k of block b is valid when
    chunk_base + 1024 b + k < bound.

    One kernel, K5. Its waits between blocks are bounded: should one run
    past its bound the kernel raises a flag instead of hanging, and the
    outputs are then invalid. `check_fused_error()` reads the flag.
    """
    return _fused(ints2d, nv)[:2]


encode_fused.launches = 0
encode_fused.error = None  # the last launch's error flag, a 0-dim device tensor


def check_fused_error() -> None:
    """Raise if the last K5 launch gave up a wait (reads the flag: a host
    sync). Call it after the launch, before trusting its outputs."""
    if encode_fused.error is not None and int(encode_fused.error):
        raise RuntimeError("encode_fused: a look-back wait ran past its bound; outputs invalid")


def encode_padded_fused(
    ints: torch.Tensor, n_valid_chunks: int, chunk_base: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """encode_padded through the one fused kernel, K5: (nb*992,) int32 ->
    (words (nb*1024,), total int32 0-dim on the same device); words past
    total are unspecified."""
    words, _, total = _fused(*_blocks_and_nv(ints, n_valid_chunks, chunk_base))
    return words, total


def encode_padded_fused_plain(
    ints: torch.Tensor, n_valid_chunks: int, chunk_base: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """encode_padded_fused through the plain versions, on any device."""
    words, counts = encode_fused_plain(*_blocks_and_nv(ints, n_valid_chunks, chunk_base))
    return words, counts.sum(dtype=torch.int32)


def _encode_rows_batch(ints2d, C: int, n_valid_chunks: int, group_rows: int, tiles, stitch):
    check(ints2d, "ints2d", (None, BLOCK_INTS))
    rows = ints2d.shape[0]
    if C < 1 or rows % C:
        raise ValueError(f"{rows} block rows do not split into {C} columns")
    nb = rows // C
    if nb & (nb - 1):
        raise ValueError(f"blocks per column must be a power of two, got {nb}")
    col_chunks = nb * BLOCK_CHUNKS
    # validity wraps per column: chunk k of the group is valid iff
    # (k & (col_chunks - 1)) < n_valid_chunks
    nv3 = device_ints([n_valid_chunks, 0, col_chunks - 1], ints2d.device)
    G = max(1, min(C, group_rows // nb))  # columns per group (int32 positions)
    words, totals = [], []
    for c0 in range(0, C, G):
        g = min(G, C - c0)
        staging, counts = tiles(ints2d[c0 * nb : (c0 + g) * nb], nv3)
        rc = counts[:, 0]
        offsets, totals_g = rebase_exclusive_per_col(rc, g, nb, col_chunks)
        offsets_ext = torch.cat([offsets, offsets[-1:] + rc[-1:]])
        words.append(stitch(staging, offsets_ext, rc))
        totals.append(totals_g)
    if len(words) == 1:
        return words[0], totals[0]
    return torch.cat(words), torch.cat(totals)


def encode_rows_batch(
    ints2d: torch.Tensor, C: int, n_valid_chunks: int, group_rows: int = 1 << 19
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched-column encode over block rows: (C*nb, 992) int32, column c
    owning rows [c*nb, (c+1)*nb), nb a power of two, every column with the
    same `n_valid_chunks` -> (words (C*nb*1024,), totals (C,)) int32.
    Column c's stream is words[c*nb*1024:][:totals[c]], equal to
    encode_padded of that column alone; words past it are unspecified.

    K1 runs with nv = [n_valid_chunks, 0, nb*1024 - 1] (validity by the
    position within the column), the counts are rebased to exclusive
    offsets from each column's base c*nb*1024, and K2 lays every column's
    stream into its own slice, given the per-row counts because the
    offsets jump at column bases. Columns go in groups of at most
    `group_rows` block rows, which keeps chunk positions within int32.
    """
    return _encode_rows_batch(ints2d, C, n_valid_chunks, group_rows, encode_tiles, stitch_tiles_v2)


def encode_rows_batch_plain(
    ints2d: torch.Tensor, C: int, n_valid_chunks: int, group_rows: int = 1 << 19
) -> tuple[torch.Tensor, torch.Tensor]:
    """encode_rows_batch through the plain versions, on any device."""
    return _encode_rows_batch(
        ints2d, C, n_valid_chunks, group_rows, encode_tiles_plain, stitch_tiles_plain
    )


def encode_padded_batch(
    cols: torch.Tensor, n_valid_chunks: int, group_rows: int = 1 << 19
) -> tuple[torch.Tensor, torch.Tensor]:
    """encode_rows_batch of (C, nb*992) columns (a free view in torch)."""
    C, width = cols.shape
    if width % BLOCK_INTS:
        raise ValueError(f"column width must be a multiple of {BLOCK_INTS}, got {width}")
    return encode_rows_batch(cols.reshape(-1, BLOCK_INTS), C, n_valid_chunks, group_rows)
