"""Faults under the sharded codec's timed path (wah_tpu_torch.parallel,
planted on every rank): `unchanged`, the span decode hands back its
input, the first words of the stream in place of the span's ints;
`swapped`, two ranks' payload rows (with their totals) laid into the
stream in the wrong order; `short`, a word cap one tile below
stitch_word_cap's; `altered`, one payload word flipped where the payload
is gathered."""
import torch


def plant(fault: str, setattr) -> None:
    from wah_tpu_torch import parallel
    from wah_tpu_torch.parallel import dist

    compact = dist.compact_payload
    if fault == "unchanged":
        decode = parallel.decode_sharded

        def decode_sharded(words, m, chunk_capacity, group=None):
            ints_l, n_chunks = decode(words, m, chunk_capacity, group)
            out = torch.zeros_like(ints_l)
            k = min(out.shape[0], words.shape[0])
            out[:k] = words[:k]
            return out, n_chunks
        setattr(parallel, "decode_sharded", decode_sharded)
    elif fault == "swapped":
        def compact_payload(segs, totals):
            order = torch.arange(segs.shape[0], device=segs.device)
            order[:2] = order[:2].flip(0)
            return compact(segs[order], totals[order])
        setattr(dist, "compact_payload", compact_payload)
    elif fault == "short":
        cap = parallel.stitch_word_cap
        setattr(parallel, "stitch_word_cap", lambda totals: cap(totals) - 1024)
    elif fault == "altered":
        def compact_payload(segs, totals):
            segs = segs.clone()
            segs[0, 0] ^= 1
            return compact(segs, totals)
        setattr(dist, "compact_payload", compact_payload)
    else:
        raise ValueError(f"no fault {fault!r}")
