"""wah_tpu_torch — the WAH codec of wah_tpu, ported to PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Imports torch and numpy, never JAX or wah_tpu; wah_tpu stays the
reference it is tested against.

Every entry point runs on the card unless the caller asks otherwise, as
wah_tpu's run on its accelerator: the device defaults to "cuda", and
without a CUDA device the default raises RuntimeError (pass
device="cpu" for the plain versions); nothing falls back by itself.

Public API (wah_tpu's signatures, plus the device):
  compress(bitmap, device="cuda")      -> (stream, timings)
  decompress(stream, out_ints=None, device="cuda") -> (bitmap, timings)
  WahCodec(device="cuda")              the codec on one torch device:
                                       compress / decompress, compress_batch /
                                       decompress_batch, the _segments forms of
                                       both (any size), logical / logical_many
  BitmapIndex.build(values, cardinality=None, codec=None)
                                       the bitmap index over compressed columns
                                       (codec None: WahCodec())
  parallel.ShardedCodec(device=None, group=None)
                                       the sharded codec (None: the rank's card)
  utils.profiling                      trace, device_activity, amortized_seconds
                                       (a step captured in a CUDA graph, replayed)
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
