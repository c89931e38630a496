"""The sharded codec of the port (wah_tpu_torch.parallel) against wah_tpu.

Two real gloo ranks: one module fixture runs `python -m
wah_tpu_torch.parallel 2 --device cpu --save DIR` once (the kernels'
plain versions), and each case holds both ranks' saved outputs against
wah_tpu.golden.encode in full and against the input. The cases are those
of tests/test_dist.py, on the same bitmaps. In-process: a world of one
with no group; the bodies of D = 8 ranks (encode_local / decode_local)
against wah_tpu.parallel on the conftest's 8-device CPU mesh; the payload
bounds against wah_tpu's; stitch_global's edges; multihost's helpers.
Tolerance zero.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import clustered_bitmap, random_bitmap
from wah_tpu import golden
from wah_tpu import parallel as jpar
from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu_torch import parallel as tpar
from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
from wah_tpu_torch.parallel import multihost
import test_torch_dist_cases as cases
from test_torch_dist_cases import COMPACT_TOTALS, compact_case

ROOT = Path(__file__).resolve().parent.parent
RANKS = 2


def _runner(*args, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [env.get("PYTHONPATH"), str(ROOT), str(ROOT / "tests")]))
    return subprocess.run([sys.executable, "-m", "wah_tpu_torch.parallel", *map(str, args)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    res = _runner(RANKS, "--device", "cpu", "--save", out, "--cases", "test_torch_dist_cases")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "backend gloo" in res.stdout and f"{RANKS} ranks: ok" in res.stdout

    def load(case):
        files = [out / f"{case}.rank{r}.npz" for r in range(RANKS)]
        return [dict(np.load(f)) for f in files]
    return load


ROUNDTRIPS = {  # tests/test_dist.py:43-69, 125-130
    "random": lambda: random_bitmap(16 * BLOCK_INTS, density=1 / 16),
    "clustered": lambda: clustered_bitmap(16 * BLOCK_INTS),
    "all_zero": lambda: np.zeros(8 * BLOCK_INTS, dtype=np.uint32),
    "all_one": lambda: np.full(8 * BLOCK_INTS, 0xFFFFFFFF, dtype=np.uint32),
    "non_block_multiple": lambda: random_bitmap(5 * BLOCK_INTS + 17, density=0.3, seed=7),
    "dense": lambda: random_bitmap(8 * BLOCK_INTS, density=0.5),
    "codec_roundtrip": lambda: clustered_bitmap(8 * BLOCK_INTS, seed=5),
}


def test_the_cases_are_the_ranks_cases():
    """The ranks run every case below, on the bitmaps of conftest's
    generators (their copies in test_torch_dist_cases)."""
    assert set(ROUNDTRIPS) | {"totals_sum", "span_partition", "corrupt_stream", "bounded_payload",
                              "overflow_flag", "estimate_word_cap", "host_shard_bitmap",
                              "configs4_trip"} == set(cases.CASES)
    for name, make in ROUNDTRIPS.items():
        np.testing.assert_array_equal(cases.ROUNDTRIPS[name](), make())
    for dens, seed in cases.ESTIMATE_DENSITIES:
        np.testing.assert_array_equal(cases.random_bitmap(BLOCK_INTS, dens, seed),
                                      random_bitmap(BLOCK_INTS, dens, seed))


@pytest.mark.parametrize("case", ROUNDTRIPS)
def test_two_ranks_codec_roundtrip(saved, case):
    data = ROUNDTRIPS[case]()
    ref = golden.encode(data)
    for out in saved(case):
        np.testing.assert_array_equal(out["data"], data)
        np.testing.assert_array_equal(out["stream"], ref)
        np.testing.assert_array_equal(out["bitmap"], data)


def test_two_ranks_totals_sum(saved):  # tests/test_dist.py:71-77
    data = random_bitmap(8 * BLOCK_INTS, density=1 / 64)
    ref = golden.encode(data)
    outs = saved("totals_sum")
    for out in outs:
        np.testing.assert_array_equal(out["data"], data)
        assert out["totals"].shape == (RANKS,) and int(out["totals"].sum()) == len(ref)
        np.testing.assert_array_equal(out["totals"], outs[0]["totals"])
        np.testing.assert_array_equal(out["stream"], ref)


def test_two_ranks_span_partition(saved):  # tests/test_dist.py:80-94
    data = clustered_bitmap(8 * BLOCK_INTS, seed=3)
    spans = []
    for r, out in enumerate(saved("span_partition")):
        np.testing.assert_array_equal(out["data"], data)
        assert int(out["n_chunks"]) == golden.chunk_count(len(data))
        L = 8 * BLOCK_INTS // RANKS
        assert out["ints_l"].shape == (L,)
        np.testing.assert_array_equal(out["ints_l"], data[r * L : (r + 1) * L])
        spans.append(out["ints_l"])
    np.testing.assert_array_equal(np.concatenate(spans), data)


def test_two_ranks_corrupt_stream_raises_on_every_rank(saved):  # tests/test_dist.py:133-138
    from wah_tpu import api as japi

    with pytest.raises(ValueError) as err:
        japi.validate_stream(np.array([0x80000000], dtype=np.uint32))
    for out in saved("corrupt_stream"):
        assert str(out["error"]) == f"ValueError: {err.value}"


def test_two_ranks_stitch_global_bounded_payload(saved):  # tests/test_dist.py:237-253
    data = random_bitmap(16 * BLOCK_INTS, density=1 / 256, seed=23)
    ref = golden.encode(data)
    for out in saved("bounded_payload"):
        cap_w = int(out["word_cap"])
        assert cap_w < int(out["cap_l"])  # the bound bites
        assert not bool(out["overflow"])
        assert out["stream"].shape == (RANKS * cap_w,)
        assert int(out["total"]) == int(out["full_total"]) == len(ref)
        np.testing.assert_array_equal(out["stream"][: len(ref)], ref)
        assert not out["stream"][len(ref) :].any()


def test_two_ranks_stitch_global_overflow_flag(saved):  # tests/test_dist.py:256-272
    data = random_bitmap(8 * BLOCK_INTS, density=0.5, seed=29)
    ref = golden.encode(data)
    for out in saved("overflow_flag"):
        assert int(out["totals"].max()) > 64
        assert bool(out["overflow"]) and int(out["total"]) == len(ref)
        assert int(out["bounded_len"]) == RANKS * 64
        assert not bool(out["overflow_retry"]) and int(out["total_retry"]) == len(ref)
        np.testing.assert_array_equal(out["stream"][: len(ref)], ref)
        assert not out["stream"][len(ref) :].any()


def test_two_ranks_estimate_word_cap_holds(saved):  # tests/test_dist.py:275-287
    for out in saved("estimate_word_cap"):
        for i, (dens, seed) in enumerate(((1 / 2, 1), (1 / 16, 2), (1 / 1024, 3))):
            data = random_bitmap(16 * BLOCK_INTS, density=dens, seed=seed)
            np.testing.assert_array_equal(out[f"data{i}"], data)
            cap = int(out[f"cap{i}"])
            assert cap == jpar.estimate_word_cap(data, 16 // RANKS)
            assert cap >= int(out[f"totals{i}"].max()), (dens, cap)


def test_two_ranks_host_shard_bitmap_rows(saved):
    for r, out in enumerate(saved("host_shard_bitmap")):
        assert int(out["rank"]) == r
        rows = out["data"].reshape(-1, BLOCK_INTS)
        np.testing.assert_array_equal(out["rows"], rows[r * 3 : (r + 1) * 3].reshape(-1))


def test_two_ranks_configs4_trip_against_the_plain_reference(saved):
    """BASELINE configs[4]'s operation (gpubench's sharded-configs4 cell) at
    P(bit) = 0.01, the last rank holding padding: every rank's stream and
    gathered bitmap == the plain torch reference and golden, word for word."""
    from gpubench.reference_torch import wah_torch

    data = random_bitmap(cases.CONFIGS4_INTS, density=0.01, seed=41)
    ref = golden.encode(data)
    ints = torch.from_numpy(data.view(np.int32))
    np.testing.assert_array_equal(tensor_to_words(wah_torch.encode(ints)), ref)
    for out in saved("configs4_trip"):
        np.testing.assert_array_equal(out["data"], data)
        assert int(out["blocks"]) * BLOCK_CHUNKS > golden.chunk_count(len(data)) + BLOCK_CHUNKS
        np.testing.assert_array_equal(out["stream"], ref)
        assert not out["past_total"].any() and not bool(out["overflow"])
        assert int(out["n_chunks"]) == golden.chunk_count(len(data))
        np.testing.assert_array_equal(out["bitmap"], data)


def test_two_ranks_dry_run(saved):
    for out in saved("dryrun"):
        assert out["data"].shape == (32 * RANKS * BLOCK_INTS,)
        np.testing.assert_array_equal(out["stream"], golden.encode(out["data"]))
        np.testing.assert_array_equal(out["bitmap"], out["data"])


def test_runner_exits_1_when_a_rank_disagrees(tmp_path):
    data = random_bitmap(4 * BLOCK_INTS, density=0.1, seed=3)
    wrong = golden.encode(data)
    wrong[3] ^= 1
    np.savez(tmp_path / "case.npz", data=data, stream=wrong)
    res = _runner(RANKS, "--device", "cpu", "--check", tmp_path / "case.npz")
    assert res.returncode == 1, res.stdout + res.stderr
    assert "FAILED" in res.stderr and "case.npz stream" in res.stderr


# -- in-process -------------------------------------------------------------

@pytest.mark.parametrize("name", ["random", "clustered", "non_block_multiple", "all_one"])
def test_world_of_one_without_a_group(name):
    assert not dist.is_initialized()
    data = ROUNDTRIPS[name]()
    codec = tpar.ShardedCodec("cpu")
    stream = codec.compress(data)
    np.testing.assert_array_equal(stream, golden.encode(data))
    np.testing.assert_array_equal(codec.decompress(stream, out_ints=len(data)), data)
    np.testing.assert_array_equal(codec.decompress(stream), golden.decode(stream))


def test_world_of_one_group_runs_the_collectives(tmp_path):
    """Under a group, even of one rank, every gather is the backend's
    collective (gloo on host tensors here): the totals, the stream and the
    bitmap."""
    from wah_tpu_torch.parallel._comm import all_gather

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=multihost.TIMEOUT)
    try:
        before = dict(all_gather.routes)
        data = ROUNDTRIPS["clustered"]()
        codec = tpar.ShardedCodec("cpu", multihost.global_group())
        stream = codec.compress(data)
        np.testing.assert_array_equal(stream, golden.encode(data))
        np.testing.assert_array_equal(codec.decompress(stream, out_ints=len(data)), data)
        assert all_gather.routes == {**before, "host": before["host"] + 3}
    finally:
        dist.destroy_process_group()


def test_world_of_one_empty_and_size_checks():
    codec = tpar.ShardedCodec("cpu")
    assert codec.compress(np.zeros(0, np.uint32)).size == 0
    assert codec.decompress(np.zeros(0, np.uint32)).size == 0
    with pytest.raises(ValueError, match="literal-fill"):
        codec.decompress(np.array([0x0], dtype=np.uint32))
    from wah_tpu_torch import api

    with pytest.raises(ValueError, match="int32 position limit"):
        api._check_size(api.MAX_INTS_PER_BITMAP + 1)


def test_cuda_codec_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.ShardedCodec("cuda")


def _shard_shapes_bitmap(nb: int) -> np.ndarray:
    """tests/test_dist.py:141-182: fills inside shard 0, a one-fill tail on
    the last shard, random words between."""
    n = nb * BLOCK_INTS
    rng = np.random.default_rng(42)
    data = np.where(rng.random(n) < 0.5, rng.integers(0, 1 << 32, n, dtype=np.uint64), 0
                    ).astype(np.uint32)
    data[2 * BLOCK_INTS : 5 * BLOCK_INTS] = 0
    data[-3 * BLOCK_INTS :] = 0xFFFFFFFF
    return data


@pytest.fixture(scope="module")
def mesh():
    m = jpar.make_mesh()
    assert m.size == 8, "conftest should provide 8 virtual CPU devices"
    return m


@pytest.mark.parametrize("nb", [96, 8 * 5, 8])
def test_eight_rank_bodies_match_wah_tpu_sharded(mesh, nb):
    """encode_local of D = 8 ranks, one after another: per-rank totals ==
    wah_tpu.parallel.encode_sharded's on the 8-device mesh; the ranks'
    streams, concatenated, == golden; decode_local's spans == the input."""
    D = 8
    data = _shard_shapes_bitmap(nb)
    nv = golden.chunk_count(len(data))
    _, jtotals = jpar.encode_sharded(mesh, jax.device_put(data), np.int32(nv))
    ints = words_to_tensor(data, "cpu")
    nb_l = nb // D
    parts, totals = [], []
    for r in range(D):
        words_l, total_l = tpar.encode_local(ints[r * nb_l * BLOCK_INTS : (r + 1) * nb_l * BLOCK_INTS],
                                             nv, r)
        assert total_l.shape == (1,)
        totals.append(int(total_l))
        parts.append(tensor_to_words(words_l[: int(total_l)]))
    np.testing.assert_array_equal(np.array(totals), np.asarray(jtotals))
    ref = golden.encode(data)
    np.testing.assert_array_equal(np.concatenate(parts), ref)
    stream = words_to_tensor(np.concatenate([ref, np.zeros(-len(ref) % 1024, np.uint32)]), "cpu")
    spans = [tpar.decode_local(stream, len(ref), nb_l * BLOCK_CHUNKS, r) for r in range(D)]
    assert all(int(n) == nv for _, n in spans)
    np.testing.assert_array_equal(tensor_to_words(torch.cat([s for s, _ in spans])), data)


@pytest.mark.parametrize("chunks_l", [32, 992, 4064, 3 * BLOCK_CHUNKS + 96])
def test_decode_local_spans_off_the_blocks(chunks_l):
    """Spans that are no whole number of blocks are cut out of the decode
    of the blocks that cover them; the spans tile the bitmap."""
    data = clustered_bitmap(6 * BLOCK_INTS + 40, seed=12)
    ref = golden.encode(data)
    stream = words_to_tensor(np.concatenate([ref, np.zeros(-len(ref) % 1024, np.uint32)]), "cpu")
    nv = golden.chunk_count(len(data))
    D = -(-nv // chunks_l)
    spans = [tpar.decode_local(stream, len(ref), chunks_l, r)[0] for r in range(D)]
    assert all(s.shape == (chunks_l // 32 * 31,) for s in spans)
    got = tensor_to_words(torch.cat(spans))
    np.testing.assert_array_equal(got[: len(data)], data)
    assert not got[(31 * nv + 31) // 32 :].any()


def test_decode_sharded_refuses_a_capacity_off_the_warps():
    with pytest.raises(ValueError, match="multiple of 32"):
        tpar.decode_sharded(torch.zeros(1024, dtype=torch.int32), 1, 1000)


@pytest.mark.parametrize("density,seed", [(1 / 2, 1), (1 / 16, 2), (1 / 256, 23), (1 / 1024, 3), (0.0, 4)])
def test_payload_bounds_equal_wah_tpus(density, seed):
    data = random_bitmap(16 * BLOCK_INTS, density=density, seed=seed)
    for nb_l in (1, 2, 16):
        assert tpar.estimate_word_cap(data, nb_l) == jpar.estimate_word_cap(data, nb_l)
    totals = np.array([len(golden.encode(data)), 3, 1025])
    for t in (totals, totals[:1], torch.from_numpy(totals), np.zeros(2, np.int64)):
        want = jpar.stitch_word_cap(np.asarray(t))
        assert tpar.stitch_word_cap(t) == want


WORD_CAPS = {"unbounded": None, "exact": "exact", "not_a_tile": 1000, "one_tile": 1024,
             "overflowing": 64, "zero": 0}


@pytest.mark.parametrize("cap", WORD_CAPS)
@pytest.mark.parametrize("density", [1 / 256, 0.0, 1.0])
def test_stitch_global_at_a_world_of_one(cap, density):
    """wah_tpu's stitch_global contract at D = 1: length D * eff, overflow
    iff max(totals) > eff < cap_l, total always right, zero past the live
    words, the stream exact when no overflow."""
    data = random_bitmap(3 * BLOCK_INTS, density=density, seed=5)
    ref = golden.encode(data)
    words_l, totals = tpar.encode_sharded(words_to_tensor(data, "cpu"), golden.chunk_count(len(data)))
    assert totals.tolist() == [len(ref)]
    word_cap = tpar.stitch_word_cap(totals) if WORD_CAPS[cap] == "exact" else WORD_CAPS[cap]
    stream, total, overflow = tpar.stitch_global(words_l, totals, word_cap)
    cap_l = 3 * BLOCK_CHUNKS
    eff = cap_l if word_cap is None else min(word_cap, cap_l)
    assert stream.shape == (eff,) and int(total) == len(ref)
    assert bool(overflow) == (eff < cap_l and len(ref) > eff)
    got = tensor_to_words(stream)
    live = min(len(ref), eff)
    assert not got[live:].any()
    if not bool(overflow):
        np.testing.assert_array_equal(got[: len(ref)], ref)


def test_initialize_world_of_one_is_a_no_op(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize(world_size=1) is None
    assert multihost.initialize() is None
    assert not dist.is_initialized()
    assert multihost.global_group() is None
    assert multihost.local_device("cpu") == torch.device("cpu")


def test_backend_rule():
    assert multihost.choose_backend(2, "cpu") == "gloo"
    n = torch.cuda.device_count()
    assert multihost.choose_backend(n + 1, "cuda") == "gloo"
    if n:
        assert multihost.choose_backend(n, "cuda") == "nccl"


def test_host_shard_bitmap_at_a_world_of_one():
    data = random_bitmap(4 * BLOCK_INTS, density=0.1, seed=2)
    rows = multihost.host_shard_bitmap(data, "cpu")
    assert rows.dtype == torch.int32 and rows.shape == (4 * BLOCK_INTS,)
    np.testing.assert_array_equal(tensor_to_words(rows), data)
    with pytest.raises(ValueError):
        multihost.host_shard_bitmap(data[:-1], "cpu")


@pytest.mark.parametrize("name", COMPACT_TOTALS)
def test_compact_payload_lays_the_ranks_words_in_order(name):
    segs, totals, want = compact_case(name)
    got = tpar.compact_payload(words_to_tensor(segs.reshape(-1), "cpu").view(segs.shape),
                               torch.from_numpy(totals))
    np.testing.assert_array_equal(tensor_to_words(got), want)
