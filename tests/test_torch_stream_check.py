"""V1's plain twin (ops/cuda/stream_check.check_stream_plain, through the
wrapper on CPU tensors) against the C++ host codec (native.validate and
native.decoded_chunks), and WahCodec("cpu").decompress's errors against
api.checked_stream's messages: on the golden streams, on malformed streams
(each kind of violation, both kinds in both orders, at the first and last
word, in the words past the last whole 16 B vector) and on streams of m =
1, 1023, 1024 and 1025 words. Every host entry point that puts words on
the device (compress, the batched forms, the logical ops, ShardedCodec)
makes no host pass over them: no check, no count, no padded host array;
and decompress_batch and ShardedCodec.decompress, which check with V1 on
the device, raise wah_tpu's messages. Tolerance zero.

This file imports no jax at import time (the two message tests import
wah_tpu's api inside them): tests/test_torch_cuda.py holds the kernel to
its plain twin on the same CASES.
"""
import numpy as np
import pytest
import torch

from wah_tpu_torch import WahCodec, api, golden, native
from wah_tpu_torch.constants import BIT31, BIT3130, BLOCK_INTS, ONES31
from wah_tpu_torch.ops.cuda import stream_check
from wah_tpu_torch.parallel import ShardedCodec, dist

U = np.uint32


def _bitmap(n_ints: int, density: float, seed: int) -> np.ndarray:
    bits = np.random.default_rng(seed).random((n_ints, 32)) < density
    return np.packbits(bits, axis=1, bitorder="little").view(U).reshape(-1)


def _valid(m: int, seed: int) -> np.ndarray:
    """m words that pass the format's checks: literals, and every fifth word
    a zero or one fill of length 1 to 1024."""
    rng = np.random.default_rng(seed)
    words = rng.integers(1, ONES31, size=m, dtype=U)  # literals in [1, 0x7FFFFFFE]
    fills = rng.integers(1, 1025, size=m, dtype=U) | np.where(rng.random(m) < 0.5, BIT31, BIT3130)
    words[::5] = fills[::5].astype(U)
    return words


def _with(words: np.ndarray, **at) -> np.ndarray:
    """A copy of `words` with word i set to at[f"w{i}"] (negative i from
    the end as "wm1", "wm2", ...)."""
    out = words.copy()
    for key, word in at.items():
        i = int(key[1:].replace("m", "-"))
        out[i] = word
    return out


GOLDEN = {
    "random_sparse": lambda: _bitmap(4 * BLOCK_INTS, 1 / 64, 1),
    "random_mid": lambda: _bitmap(9 * BLOCK_INTS, 1 / 16, 3),
    "random_dense": lambda: _bitmap(2 * BLOCK_INTS, 0.5, 4),
    "all_zeros": lambda: np.zeros(8 * BLOCK_INTS, U),
    "all_ones": lambda: np.full(4 * BLOCK_INTS, 0xFFFFFFFF, U),
    "odd_size": lambda: _bitmap(3 * BLOCK_INTS + 345, 0.1, 6),
    "tiny": lambda: np.array([0x1, 0, 0, 0xFFFFFFFF], dtype=U),
}
LONG = _valid(1031, 11)  # 257 whole vectors and 3 words past them

# name -> (the stream, index of its first bad word or None)
CASES = {f"golden_{k}": (lambda f=f: golden.encode(f()), None) for k, f in GOLDEN.items()}
CASES.update({
    # the malformed streams of tests/test_torch_native.py
    "zero_word": (lambda: np.array([0x80000001, 0x5, 0x0, 0x7], U), 2),
    "ones_literal": (lambda: np.array([0x5, 0x7FFFFFFF], U), 1),
    "zero_length_fill": (lambda: np.array([0x5, 0x80000000, 0x80000001], U), 1),
    "fill_length_1025": (lambda: np.array([0xC0000000 | 1025, 0x5], U), 0),
    # both kinds, in both orders: the first in the stream decides
    "literal_fill_then_length": (lambda: np.array([0x5, 0x0, 0xC0000000 | 1025, 0x7], U), 1),
    "length_then_literal_fill": (lambda: np.array([0x5, 0x80000000 | 2000, 0x7FFFFFFF, 0x7], U), 1),
    "zero_length_fill_alone": (lambda: np.array([0x80000000], U), 0),
    "zero_length_one_fill_in_tail": (lambda: _with(LONG, w1029=BIT3130), 1029),
    "fill_1025_in_tail": (lambda: _with(LONG, wm1=0x80000000 | 1025), 1030),
    "fill_1025_in_tail_after_zero_word": (lambda: _with(LONG, w700=0, wm2=BIT31 | 1025), 700),
    "fill_2pow30_minus_1": (lambda: _with(LONG, w500=BIT3130 | 0x3FFFFFFF), 500),
    "zero_word_first": (lambda: _with(LONG, w0=0), 0),
    "zero_word_last": (lambda: _with(LONG, wm1=0), 1030),
    "ones_literal_first": (lambda: _with(LONG, w0=ONES31), 0),
    "ones_literal_last": (lambda: _with(LONG, wm1=ONES31), 1030),
})
for _m in (1, 1023, 1024, 1025):
    CASES[f"m{_m}"] = (lambda m=_m: _valid(m, m), None)
    CASES[f"m{_m}_bad_last"] = (lambda m=_m: _with(_valid(m, m), wm1=0), _m - 1)


@pytest.fixture(autouse=True)
def _toolchain():
    if not native.available():
        pytest.skip("native toolchain unavailable")


def _message(fn, *args) -> str:
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value)


@pytest.mark.parametrize("name", CASES)
def test_check_stream_plain_matches_the_host_codec(name):
    gen, want_bad = CASES[name]
    words = gen()
    m = len(words)
    # a buffer of whole blocks, as decompress sends it, with a bad word past m
    buf = torch.zeros(-(-(m + 1) // 1024) * 1024, dtype=torch.int32)
    buf[:m] = torch.from_numpy(words.view(np.int32))
    before = stream_check.check_stream.launches
    got = stream_check.check_stream(buf, m)
    assert stream_check.check_stream.launches == before  # a CPU tensor launches nothing
    assert got.dtype == torch.int64 and got.shape == (2,)
    first_bad, n_chunks = got.tolist()
    codec = WahCodec("cpu")
    if want_bad is None:
        assert first_bad == m
        native.validate(words)
        assert n_chunks == native.decoded_chunks(words)
        out, _ = codec.decompress(words)
        np.testing.assert_array_equal(out, native.decode(words))
    else:
        assert first_bad == want_bad
        native.validate(words[:first_bad])  # no violation before it
        msg = _message(api.checked_stream, words)
        assert _message(native.validate, words[: first_bad + 1]) == msg
        assert _message(codec.decompress, words) == msg


def _refuse_host_passes(monkeypatch, *more) -> None:
    """From here on, every host check or count of a stream raises, and so
    does np.concatenate; `more` adds (module, name) pairs."""
    def reached(*_, **__):
        raise AssertionError("a host pass over the stream")

    for mod, name in ((native, "validate"), (native, "decoded_chunks"), (api, "checked_stream"),
                      (api, "stream_chunks"), (api, "validate_stream"), (np, "concatenate"),
                      *more):
        monkeypatch.setattr(mod, name, reached)


def test_decompress_makes_no_host_pass_over_the_stream(monkeypatch):
    """decompress neither validates nor counts nor pads on the host."""
    words = golden.encode(GOLDEN["odd_size"]())
    want, _ = WahCodec("cpu").decompress(words)
    _refuse_host_passes(monkeypatch)
    got, _ = WahCodec("cpu").decompress(words)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="literal-fill"):
        WahCodec("cpu").decompress(_with(words, wm1=0))


N_HOST = 5000  # ints a column: 6 blocks, the last one partial


def _host_path(name: str, device="cpu"):
    """(a call through one host entry point, what it must give), with every
    input and the codecs made before any host pass is refused."""
    codec, sharded = WahCodec(device), ShardedCodec(device)
    cols = np.stack([_bitmap(N_HOST, d, 20 + i) for i, d in enumerate((1 / 16, 1 / 2, 0.0))])
    streams = [golden.encode(c) for c in cols]
    if name == "compress":
        return lambda: codec.compress(cols[0])[0], streams[0]
    if name == "compress_batch":
        def call():
            words, totals = codec.compress_batch(cols)
            return [words[c, :t] for c, t in enumerate(totals)]
        return call, streams
    if name == "decompress_batch_even":  # columns that expand equally: one batched decode
        words, totals = codec.compress_batch(cols)
        return lambda: codec.decompress_batch(words, totals, N_HOST), cols
    if name == "decompress_batch_uneven":  # a decode a column
        short = golden.encode(cols[0][: 2 * BLOCK_INTS])
        words = np.zeros((2, len(streams[1])), U)
        words[0, : len(short)], words[1] = short, streams[1]
        totals = np.array([len(short), len(streams[1])])

        def call():
            out = codec.decompress_batch(words, totals)
            return [out[0, : 2 * BLOCK_INTS], out[1, :N_HOST]]
        return call, [cols[0][: 2 * BLOCK_INTS], cols[1]]
    if name == "logical":
        return lambda: codec.logical(streams[0], streams[1], "andnot", N_HOST), \
            golden.encode(cols[0] & ~cols[1])
    if name == "logical_many":  # three columns: a fourth, the identity, pads the fan-in
        return lambda: codec.logical_many(streams, "or", N_HOST), \
            golden.encode(cols[0] | cols[1] | cols[2])
    if name == "sharded_compress":
        return lambda: sharded.compress(cols[1]), streams[1]
    assert name == "sharded_decompress"
    return lambda: sharded.decompress(streams[1], out_ints=N_HOST), cols[1]


HOST_PATHS = ["compress", "compress_batch", "decompress_batch_even", "decompress_batch_uneven",
              "logical", "logical_many", "sharded_compress", "sharded_decompress"]


@pytest.mark.parametrize("name", HOST_PATHS)
def test_host_entry_points_make_no_host_pass(monkeypatch, name):
    """Every host entry point copies its words to the device as they are:
    no host check or count of a stream (V1 checks on the device), and no
    padded host array (np.zeros and np.full refused too, the padding is
    written on the device)."""
    call, want = _host_path(name)
    _refuse_host_passes(monkeypatch, (np, "zeros"), (np, "full"), (dist, "checked_stream"))
    got = call()
    monkeypatch.undo()
    for g, w in zip(got, want) if isinstance(want, list) else [(got, want)]:
        np.testing.assert_array_equal(g, w)


def _batch(fault: str):
    """(words (3, M), totals) of three golden streams of unequal lengths
    (each column 6 blocks, so they expand equally), a fault planted."""
    streams = [golden.encode(_bitmap(N_HOST, d, 30 + i)) for i, d in enumerate((1 / 2, 1 / 16, 0.1))]
    totals = np.array([len(s) for s in streams])
    words = np.full((3, totals.max() + 5), 0x5, U)  # words past a total are the caller's
    for c, s in enumerate(streams):
        words[c, : len(s)] = s
    at = {  # (column, word) -> the bad word
        "literal_fill": {(1, 3): 0},
        "ones_literal": {(1, 3): ONES31},
        "fill_length_0": {(1, 3): BIT31},
        "fill_length_1025": {(1, 3): BIT3130 | 1025},
        "both_in_one_column": {(1, 2): BIT31 | 1025, (1, 7): 0},
        "both_in_two_columns": {(0, 9): BIT31 | 1025, (2, 4): ONES31},
        "last_column_only": {(2, totals[2] - 1): 0},
        "past_a_total_only": {(2, totals[2]): 0, (1, totals[1] + 1): BIT31},
    }[fault]
    for (c, i), word in at.items():
        words[c, i] = word
    return words, totals


BATCH_FAULTS = ["literal_fill", "ones_literal", "fill_length_0", "fill_length_1025",
                "both_in_one_column", "both_in_two_columns", "last_column_only",
                "past_a_total_only"]


@pytest.mark.parametrize("fault", BATCH_FAULTS)
def test_decompress_batch_raises_wah_tpus_message(fault):
    """V1 finds the bad column on the device; the message is wah_tpu's
    decompress_batch's (literal-fill before fill-length, over every
    column's live words), and a bad word past a column's total is no
    fault."""
    from wah_tpu import api as japi

    words, totals = _batch(fault)
    codec = WahCodec("cpu")
    if fault == "past_a_total_only":
        want = [golden.decode(words[c, :t], out_ints=N_HOST) for c, t in enumerate(totals)]
        np.testing.assert_array_equal(codec.decompress_batch(words, totals, N_HOST), np.stack(want))
        return
    want = _message(japi.WahCodec(kernel="xla").decompress_batch, words, totals)
    assert _message(codec.decompress_batch, words, totals) == want


STREAM_FAULTS = {  # word index -> the bad word, in a golden stream of 5,000 ints
    "literal_fill": {3: 0},
    "fill_length_0": {3: BIT31},
    "fill_length_1025": {3: BIT3130 | 1025},
    "length_then_literal_fill": {2: BIT31 | 1025, 7: ONES31},
    "literal_fill_then_length": {2: 0, 7: BIT3130 | 2000},
    "last_word_only": {-1: 0},
}


def _stream_with(fault: str) -> np.ndarray:
    words = golden.encode(_bitmap(N_HOST, 1 / 2, 40))
    for i, word in STREAM_FAULTS[fault].items():
        words[i] = word
    return words


@pytest.mark.parametrize("fault", STREAM_FAULTS)
def test_sharded_decompress_raises_checked_streams_message(fault):
    """ShardedCodec.decompress checks with V1 on its device copy and raises
    wah_tpu's checked_stream message (in a world of one; every rank of a
    group does the same before any collective)."""
    from wah_tpu import api as japi

    words = _stream_with(fault)
    want = _message(japi.checked_stream, words)
    assert _message(ShardedCodec("cpu").decompress, words) == want


def test_check_stream_refuses_m_past_the_words():
    words = torch.ones(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        stream_check.check_stream(words, 9)
    with pytest.raises(TypeError):
        stream_check.check_stream(words.to(torch.int64), 8)
    assert stream_check.check_stream(words, 0).tolist() == [0, 0]
