"""wah_tpu_torch — the WAH codec of wah_tpu, ported to PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Imports torch and numpy, never JAX or wah_tpu; wah_tpu stays the
reference it is tested against.

Public API:
  compress(bitmap, device)             -> (stream, timings)
  decompress(stream, out_ints, device) -> (bitmap, timings)
  WahCodec(device)                     the codec on one torch device:
                                       compress / decompress, compress_batch /
                                       decompress_batch, the _segments forms of
                                       both (any size), logical / logical_many
  BitmapIndex.build(values, cardinality, codec=WahCodec(device))
                                       the bitmap index over compressed columns
  ops.bits / ops.encode / ops.decode   plain torch ports of wah_tpu.ops
  ops.logical                          compressed-domain AND/OR/XOR/ANDNOT/NOT
  ops.cuda.*                           kernels K1-K6 and T1 with their plain versions
  rechunk_stream(words)                general WAH stream -> this codec's canonical form
  native                               the C++ host codec (built at first use)
  golden                               NumPy oracle (copy of wah_tpu.golden)
  python -m wah_tpu_torch              the file CLI (compress, decompress, info, logical)
  python -m wah_tpu_torch.differential every path against golden, on the card
"""
from . import constants, golden
from .api import WahCodec, compress, decompress, validate_stream
from .index import BitmapIndex
from .interop import rechunk_stream

__version__ = "0.1.0"

__all__ = [
    "constants",
    "golden",
    "WahCodec",
    "BitmapIndex",
    "compress",
    "decompress",
    "validate_stream",
    "rechunk_stream",
    "__version__",
]
