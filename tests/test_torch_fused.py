"""K5's port on the CPU (its plain version) against the Pallas fused kernel,
and a model of the kernel's look-back protocol.

The same numpy inputs (the case matrix of test_pallas.py, and block counts
around K5's tile size) go through
wah_tpu.ops.pallas.encode_kernel.encode_padded_fused, run as test_pallas.py
runs it (jit, interpret mode on the CPU), and through
wah_tpu_torch.ops.cuda.encode_kernel.encode_padded_fused on CPU tensors:
words up to the total, the total, and the per-block counts. Tolerance is
zero: an integer codec must agree bit for bit.

The CUDA kernel cannot run here. What can go wrong between its CTAs is the
protocol (tickets, tiles, descriptors, the deferred look-back, the error
flag), so that is modelled in Python, one generator a CTA, and stepped
under a seeded random scheduler.
"""
import random
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_pallas import CASES
from wah_tpu import golden
from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu.ops.pallas import encode_kernel as jek
from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
from wah_tpu_torch.ops.cuda import encode_kernel as ek

IDS = [c[0] for c in CASES]
NB = 16  # blocks of every case (a multiple of the CPU TILE_BLOCKS, 8): one compile
TILE = ek.FUSED_TILE_BLOCKS


def _ends_inside(n_blocks: int) -> np.ndarray:
    """A bitmap of n_blocks blocks, P(bit) = 2^-4, that ends inside the last one."""
    rng = np.random.default_rng(n_blocks)
    words = [rng.integers(0, 1 << 32, size=n_blocks * BLOCK_INTS - 300, dtype=np.uint32)
             for _ in range(4)]
    return words[0] & words[1] & words[2] & words[3]


# block counts around K5's tile size, a tile short of and past many tiles
BLOCK_COUNTS = [1, TILE - 1, TILE, TILE + 1, 2 * TILE + 1, 33 * TILE - 1, 88 * TILE + 1]
COUNT_CASES = [(f"blocks_{n}", n) for n in BLOCK_COUNTS]


def _padded(data: np.ndarray, nb: int = NB):
    padded = np.zeros(nb * BLOCK_INTS, dtype=np.uint32)
    padded[: len(data)] = data
    return padded, golden.chunk_count(len(data))


@pytest.mark.parametrize(
    "name,gen", CASES + [(name, n) for name, n in COUNT_CASES], ids=IDS + [c[0] for c in COUNT_CASES])
def test_fused_matches_pallas_and_golden(name, gen):
    if isinstance(gen, int):  # a block count: exactly that many blocks
        data = _ends_inside(gen)
        padded, nv = _padded(data, gen)
    else:
        data = gen()
        padded, nv = _padded(data)
    jwords, jtotal = jax.jit(jek.encode_padded_fused)(padded, np.int32(nv))
    before = ek.encode_fused.launches
    words, total = ek.encode_padded_fused(words_to_tensor(padded, "cpu"), nv)
    assert ek.encode_fused.launches == before  # a CPU tensor launches nothing
    assert total.dtype == torch.int32 and total.dim() == 0
    assert int(total) == int(jtotal)
    got = tensor_to_words(words[: int(total)])
    np.testing.assert_array_equal(got, np.asarray(jwords)[: int(jtotal)])
    np.testing.assert_array_equal(got, golden.encode(data))


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_fused_counts_match_pallas(name, gen):
    padded, nv = _padded(gen())
    nv_arr = np.array([nv, 0], np.int32)
    _, jcounts = jax.jit(jek.encode_fused)(padded.reshape(NB, BLOCK_INTS), nv_arr)
    ints2d = words_to_tensor(padded, "cpu").view(NB, BLOCK_INTS)
    words, counts = ek.encode_fused(ints2d, torch.from_numpy(nv_arr))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert words.shape == (NB * BLOCK_CHUNKS,) and counts.shape == (NB, 1)
    # the fused path equals the two-kernel pipeline's plain twin
    w2, t2 = ek.encode_padded_plain(ints2d.view(-1), nv, stitch="v3")
    assert int(t2) == int(counts.sum())
    assert torch.equal(words[: int(t2)], w2[: int(t2)])


def test_fused_shard_padding_emits_no_spurious_words():
    """Twin of test_pallas.py's regression for the fused path: on a non-final
    shard the padding rows lie below the GLOBAL bound; the clamp to the
    call's own blocks keeps them from emitting BIT31|1024 words."""
    nb = 4
    data = np.zeros(nb * BLOCK_INTS, dtype=np.uint32)
    nv_global = 8 * nb * BLOCK_CHUNKS  # simulates 8 shards
    for base in (0, nb * BLOCK_CHUNKS):
        jwords, jtotal = jax.jit(jek.encode_padded_fused)(data, np.int32(nv_global), np.int32(base))
        words, total = ek.encode_padded_fused(words_to_tensor(data, "cpu"), nv_global, base)
        assert int(total) == int(jtotal) == nb, base
        want = np.full(nb, 0x80000000 | 1024, np.uint32)
        np.testing.assert_array_equal(tensor_to_words(words[:nb]), want)
        np.testing.assert_array_equal(np.asarray(jwords)[:nb], want)


@pytest.mark.parametrize("base_blocks", [0, 3])
def test_fused_chunk_base_with_a_bound_inside_the_call(base_blocks):
    """A non-zero chunk_base and a bound that ends inside the call's blocks."""
    rng = np.random.default_rng(23)
    data = rng.integers(0, 2**32, size=8 * BLOCK_INTS, dtype=np.uint64).astype(np.uint32)
    base = base_blocks * BLOCK_CHUNKS
    bound = base + 5 * BLOCK_CHUNKS + 100
    jwords, jtotal = jax.jit(jek.encode_padded_fused)(data, np.int32(bound), np.int32(base))
    words, total = ek.encode_padded_fused(words_to_tensor(data, "cpu"), bound, base)
    assert int(total) == int(jtotal)
    np.testing.assert_array_equal(tensor_to_words(words[: int(total)]), np.asarray(jwords)[: int(jtotal)])


def test_fused_rejects_bad_arguments():
    ints = torch.zeros(BLOCK_INTS + 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ek.encode_padded_fused(ints, 10)
    with pytest.raises(ValueError):  # K5 takes no position mask
        ek.encode_fused(torch.zeros((1, BLOCK_INTS), dtype=torch.int32), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        ek.encode_fused(torch.zeros((1, BLOCK_INTS), dtype=torch.int64), torch.zeros(2, dtype=torch.int32))
    ek.check_fused_error()  # no launch yet, or a clean one: does not raise


def test_tile_constant_matches_the_kernel_source():
    """The wrapper sizes the workspace from FUSED_TILE_BLOCKS; the kernel
    cannot be built here, so the constant is held against the source."""
    src = Path(ek.__file__).resolve().parents[2] / "csrc" / "encode_fused.cu"
    (value,) = re.findall(r"constexpr int kTileBlocks = (\d+);", src.read_text())
    assert int(value) == ek.FUSED_TILE_BLOCKS


# --- a model of K5's protocol (wah_tpu_torch/csrc/encode_fused.cu) ---------
#
# One generator a CTA; every `yield` is a point where the scheduler may run
# another CTA, so every access to the shared state (ticket counter, error
# flag, descriptors) is one step. The CTA's own work (the encode, the stores)
# takes no step: it touches nothing shared.

EMPTY, AGGREGATE, INCLUSIVE = 0, 1, 2


class World:
    def __init__(self, counts, B, max_spins):
        self.counts, self.B, self.max_spins = counts, B, max_spins
        self.n_tiles = -(-len(counts) // B)
        self.ticket, self.err = 0, 0
        self.desc = [(EMPTY, 0)] * self.n_tiles
        self.prefix = {}  # tile -> the exclusive prefix its CTA stored it at
        self.waited_on = []  # (tile resolved, lowest tile polled, tickets taken so far)

    def take_ticket(self):
        if self.err:
            return -1
        self.ticket += 1
        return self.ticket - 1

    def publish(self, tile, status, value):
        assert self.desc[tile][0] < status, "a descriptor only moves forward"
        self.desc[tile] = (status, value)


def _look_back(w: World, t: int):
    """The kernel's look_back: 32 predecessors a step, waiting for the ones up
    to the nearest inclusive; a generator that returns the prefix or -1."""
    prefix, spins = 0, 0
    j0 = t - 1
    while True:
        lanes = [j0 - lane for lane in range(32)]
        w.waited_on.append((t, max(min(lanes), 0), w.ticket))
        yield
        d = [w.desc[j] if j >= 0 else (INCLUSIVE, 0) for j in lanes]
        while True:
            incl = [i for i, (status, _) in enumerate(d) if status == INCLUSIVE]
            need = incl[0] if incl else 31
            if all(status != EMPTY for status, _ in d[: need + 1]):
                break
            spins += 1
            if spins > w.max_spins or w.err:
                w.err = 1
                return -1
            yield  # back off, then poll the empty lanes again
            d = [w.desc[j] if j >= 0 and d[i][0] == EMPTY else d[i] for i, j in enumerate(lanes)]
        prefix += sum(value for _, value in d[: need + 1])
        if incl:
            return prefix
        j0 -= 32


def _cta(w: World):
    B = w.B
    tile = w.take_ticket()
    yield
    prev, prev_agg = -1, 0
    while True:
        have = 0 <= tile < w.n_tiles
        if have:
            nxt = w.take_ticket()  # the next tile's ticket, taken early
            yield
            agg = sum(w.counts[tile * B : (tile + 1) * B])
            w.publish(tile, INCLUSIVE if tile == 0 else AGGREGATE, agg)
            yield
        if prev >= 0:
            prefix = 0
            if prev > 0:
                prefix = yield from _look_back(w, prev)
                if prefix < 0:
                    return
                w.publish(prev, INCLUSIVE, prefix + prev_agg)
                yield
            assert prev not in w.prefix
            w.prefix[prev] = prefix
        if not have:
            return
        prev, prev_agg, tile = tile, agg, nxt


def _run(counts, B, grid, seed, max_spins=10**9, starve=None, step_cap=10**6):
    """Step `grid` CTAs under a seeded random scheduler until all have ended.
    `starve`: a CTA that takes its first two tickets and is then not scheduled
    again until every other CTA has ended or half the step cap has passed (it
    stands for a CTA the hardware holds up with its tiles unpublished)."""
    w = World(counts, B, max_spins)
    rng = random.Random(seed)
    ctas = {i: _cta(w) for i in range(grid)}
    steps = 0
    if starve is not None:
        next(ctas[starve]), next(ctas[starve])
    while ctas:
        live = [i for i in ctas if i != starve] or list(ctas)
        if starve in ctas and steps > step_cap // 2:
            live = list(ctas)
        i = rng.choice(live)
        try:
            next(ctas[i])
        except StopIteration:
            del ctas[i]
        steps += 1
        assert steps < step_cap, "the CTAs did not end"
    return w


PROTOCOL_CASES = [
    # (B, grid, nb)
    (3, 1, 10), (3, 2, 10), (3, 4, 3), (3, 4, 2), (3, 7, 100), (3, 64, 100), (3, 5, 301),
    (2, 3, 1), (2, 3, 65), (4, 6, 4 * 40), (4, 6, 4 * 40 + 1), (8, 3, 7), (8, 50, 8 * 45 - 1),
    (1, 40, 70), (16, 2, 100),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("B,grid,nb", PROTOCOL_CASES)
def test_look_back_protocol_gives_every_tile_its_prefix(B, grid, nb, seed):
    counts = np.random.default_rng(seed).integers(0, 1025, size=nb).tolist()
    if seed == 2:  # tiles whose blocks are all invalid count 0
        counts[: nb // 2] = [0] * (nb // 2)
    w = _run(counts, B, grid, seed)
    n_tiles = -(-nb // B)
    tile_counts = [sum(counts[t * B : (t + 1) * B]) for t in range(n_tiles)]
    want = np.concatenate([[0], np.cumsum(tile_counts)])
    assert w.prefix == {t: int(want[t]) for t in range(n_tiles)}
    assert not w.err
    # the last tile's inclusive prefix is the total
    assert w.desc[n_tiles - 1] == (INCLUSIVE, sum(counts))
    # no CTA ever polls a tile at or above the one it resolves, nor one whose
    # ticket was not yet taken (a CTA waits only for CTAs that are running)
    for tile, lowest, taken in w.waited_on:
        assert lowest < tile <= taken - 1


@pytest.mark.parametrize("B,grid,nb", [(3, 8, 200), (4, 3, 50), (2, 16, 33)])
def test_look_back_protocol_error_flag_ends_every_cta(B, grid, nb):
    """A CTA that the scheduler holds up makes its successors' bounded waits
    run out: the flag goes up, every CTA ends (none is left waiting), and
    the tiles that were stored before the flag lie at their true prefix."""
    counts = np.random.default_rng(7).integers(0, 1025, size=nb).tolist()
    w = _run(counts, B, grid, seed=3, max_spins=5, starve=0)
    assert w.err == 1
    tile_counts = [sum(counts[t * B : (t + 1) * B]) for t in range(-(-nb // B))]
    want = np.concatenate([[0], np.cumsum(tile_counts)])
    assert len(w.prefix) < len(tile_counts)
    for t, prefix in w.prefix.items():
        assert prefix == int(want[t])


@settings(max_examples=60, deadline=None)
@given(B=st.integers(1, 9), grid=st.integers(1, 40), nb=st.integers(1, 150),
       seed=st.integers(0, 2**31))
def test_look_back_protocol_under_any_schedule(B, grid, nb, seed):
    counts = np.random.default_rng(seed).integers(0, 1025, size=nb).tolist()
    w = _run(counts, B, grid, seed)
    tile_counts = [sum(counts[t * B : (t + 1) * B]) for t in range(-(-nb // B))]
    want = np.concatenate([[0], np.cumsum(tile_counts)])
    assert w.prefix == {t: int(want[t]) for t in range(len(tile_counts))} and not w.err
