"""Faults under the codec's timed path, for the cells that run
wah_tpu_torch's encode and decode pipelines (the api cell runs them under
WahCodec): `unchanged`, decode hands back its input; `half`, half of the
bitmap left out of the encode; `altered`, the first word of every stream
flipped where it is produced."""
import torch


def _flip_first(words):
    words = words.clone()
    words.reshape(-1)[0] ^= 1
    return words


def plant(fault: str, setattr) -> None:
    from wah_tpu_torch.ops.cuda import decode_kernel, encode_kernel

    enc = encode_kernel.encode_padded
    if fault == "unchanged":
        def decode(words, m, cap, chunk_base=0):
            n = cap // 1024 * 992
            return words[:n].clone(), torch.tensor(n, dtype=torch.int32)
        setattr(decode_kernel, "decode", decode)
    elif fault == "half":
        def encode(ints, nv, chunk_base=0, stitch="auto"):
            ints = ints.clone()
            ints[ints.shape[0] // 2:] = 0
            return enc(ints, nv, chunk_base, stitch)
        setattr(encode_kernel, "encode_padded", encode)
    elif fault == "altered":
        def encode(ints, nv, chunk_base=0, stitch="auto"):
            words, total = enc(ints, nv, chunk_base, stitch)
            return _flip_first(words), total
        setattr(encode_kernel, "encode_padded", encode)
    else:
        raise ValueError(f"no fault {fault!r}")
