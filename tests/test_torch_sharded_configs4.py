"""BASELINE configs[4] on the port: the plain PyTorch reference of the
benchmark's sharded-configs4 cell (gpubench/reference_torch/wah_torch.py)
against the NumPy reference and wah_tpu's golden model; the port's sharded
path against that reference at D = 4, as rank bodies one after another in
this process and as the cell's own run over four gloo ranks; the program's
sharded spans under a profiler, and none without one; the exchange's byte
count and the readers of the cell's per-layer metrics. Tolerance zero.
The cell's two ranks' run through the runner is in test_torch_dist.py
(configs4_trip)."""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import random_bitmap
from gpubench import harness, links
from gpubench.reference import wah
from gpubench.reference_torch import wah_torch
from gpubench.tests.cells import small_cell
from wah_tpu import golden
from wah_tpu_torch import parallel as tpar
from wah_tpu_torch.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
from wah_tpu_torch.parallel import multihost
from wah_tpu_torch.parallel._comm import all_gather
from wah_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "sharded-configs4"
SEED = 2**31 + 77


def _torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32))


def _fill_across_a_piece_edge() -> np.ndarray:
    """Zeros, then a run of ones from inside block 2 to inside block 5, and
    literals around it: with pieces of 2 blocks the run crosses a piece's
    edge (a block's edge, where the format breaks every run anyway)."""
    x = random_bitmap(7 * BLOCK_INTS + 5, density=0.01, seed=8)
    x[2 * BLOCK_INTS + 100 : 5 * BLOCK_INTS + 40] = 0xFFFFFFFF
    x[: BLOCK_INTS + 7] = 0
    return x


BITMAPS = {
    "p0.01": lambda: random_bitmap(6 * BLOCK_INTS, density=0.01, seed=1),
    "p2^-1": lambda: random_bitmap(3 * BLOCK_INTS, density=0.5, seed=2),
    "p2^-16": lambda: random_bitmap(40 * BLOCK_INTS, density=2.0**-16, seed=3),
    "all_zero": lambda: np.zeros(5 * BLOCK_INTS, np.uint32),
    "all_one": lambda: np.full(5 * BLOCK_INTS, 0xFFFFFFFF, np.uint32),
    # neither a whole number of 31 ints nor of blocks
    "odd_length": lambda: random_bitmap(3 * BLOCK_INTS + 31 * 5 + 17, density=0.01, seed=4),
    "fill_across_a_piece_edge": _fill_across_a_piece_edge,
}


@pytest.mark.parametrize("name", BITMAPS)
def test_the_plain_reference_equals_numpy_and_golden(monkeypatch, name):
    """encode and decode of gpubench/reference_torch/wah_torch.py, in pieces
    of 2 blocks and of 5 words (so that every case crosses pieces), word
    for word against gpubench/reference/wah.py and wah_tpu.golden."""
    monkeypatch.setattr(wah_torch, "PIECE_BLOCKS", 2)
    monkeypatch.setattr(wah_torch, "PIECE_WORDS", 5)
    data = BITMAPS[name]()
    want = golden.encode(data)
    np.testing.assert_array_equal(wah.encode(data), want)
    stream = wah_torch.encode(_torch(data))
    assert stream.dtype == torch.int32
    np.testing.assert_array_equal(tensor_to_words(stream), want)
    np.testing.assert_array_equal(tensor_to_words(wah_torch.decode(stream, len(data))), data)
    whole = golden.decode(want)  # ceil(31 c / 32) ints of c chunks
    np.testing.assert_array_equal(tensor_to_words(wah_torch.decode(stream, len(whole))), whole)
    longer = len(whole) + 40  # zeros past the stream's chunks, as the NumPy reference's
    np.testing.assert_array_equal(tensor_to_words(wah_torch.decode(stream, longer)),
                                  wah.decode(want, longer))


def test_the_plain_reference_in_whole_pieces_equals_its_small_pieces(monkeypatch):
    data = _fill_across_a_piece_edge()
    whole = wah_torch.encode(_torch(data))
    monkeypatch.setattr(wah_torch, "PIECE_BLOCKS", 1)
    monkeypatch.setattr(wah_torch, "COMPARE_WORDS", 7)
    pieces = wah_torch.encode_pieces(_torch(data))
    assert len(pieces) == 8
    assert torch.equal(torch.cat(pieces), whole) and torch.equal(wah_torch.encode(_torch(data)), whole)
    # the comparisons a slice and a piece at a time count what a whole one does
    assert wah_torch.stream_differing(whole, pieces) == 0
    bad = whole.clone()
    bad[[0, 9, len(bad) - 1]] ^= 1
    assert wah_torch.stream_differing(bad, pieces) == wah_torch.words_differing(bad, whole) == 3
    assert wah_torch.stream_differing(whole[:-5], pieces) == 5
    assert wah_torch.stream_differing(torch.cat([whole, whole[:4]]), pieces) == 4
    assert wah_torch.words_differing(whole[:-5], whole) == 5
    assert wah_torch.encode(torch.zeros(0, dtype=torch.int32)).shape == (0,)
    assert wah_torch.decode(torch.zeros(0, dtype=torch.int32), 3).tolist() == [0, 0, 0]


def test_the_plain_reference_imports_nothing_of_the_program():
    """Independent of the code under test: torch alone, no kernel of the
    port, no JAX."""
    for path in (ROOT / "gpubench" / "reference_torch").glob("*.py"):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops.add(node.module.split(".")[0])
        assert tops <= {"__future__", "torch"}, (path, tops)


def _rank_bodies(data: np.ndarray, D: int):
    """The cell's operation as D rank bodies one after another: encode_local,
    the payload of each rank's first stitch_word_cap words compacted,
    decode_local of every rank's span. Returns (stream, bitmap, blocks)."""
    nv = golden.chunk_count(len(data))
    nb = -(-(-(-nv // BLOCK_CHUNKS)) // D) * D
    n_l = nb // D * BLOCK_INTS
    padded = np.zeros(nb * BLOCK_INTS, np.uint32)
    padded[: len(data)] = data
    parts = [tpar.encode_local(_torch(padded[r * n_l : (r + 1) * n_l]), nv, r) for r in range(D)]
    totals = torch.cat([t for _, t in parts])
    eff = tpar.stitch_word_cap(totals)
    payload = torch.stack([w[:eff] for w, _ in parts])
    stream = tpar.compact_payload(payload, totals)
    m = int(totals.sum())
    assert not stream[m:].any()
    spans = [tpar.decode_local(stream, m, nb // D * BLOCK_CHUNKS, r) for r in range(D)]
    assert all(int(n) == nv for _, n in spans)
    bitmap = torch.cat([s for s, _ in spans])[: len(data)]
    return stream[:m], bitmap, nb


@pytest.mark.parametrize("density,seed", [(0.01, 11), (0.5, 12), (2.0**-16, 13)])
def test_four_rank_bodies_equal_the_plain_reference(density, seed):
    """D = 4 with 13 blocks of bitmap and 4 of padding, the last rank
    holding 1 block of bitmap: the stream and the ranks' spans joined ==
    the plain reference's stream and the input."""
    data = random_bitmap(12 * BLOCK_INTS + 300, density=density, seed=seed)
    stream, bitmap, nb = _rank_bodies(data, 4)
    assert nb == 16
    want = wah_torch.encode(_torch(data))
    assert torch.equal(stream, want)
    assert torch.equal(bitmap, _torch(data))
    assert torch.equal(wah_torch.decode(want, len(data)), _torch(data))


def test_the_cell_over_four_gloo_ranks_is_correct():
    """The cell at its "cpu" test sizes (its traffic file): four rank
    processes on gloo, the cell's operations, its check against the
    plain reference; the last rank holds padding."""
    cell = small_cell(CELL)
    assert cell.chips == 4
    n = cell.config["ints"]
    assert -(-(-(-n // 31) * 32) // BLOCK_CHUNKS) % 4  # blocks do not split evenly
    r = harness.run_cell(cell, SEED, 0.3, False, "cpu")
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == {"ops_failed", "total_wrong", "chunks_wrong",
                                "stream_words_wrong", "bitmap_words_wrong", "overflow"}


def _driver(rank=0, **config):
    cell = small_cell(CELL)
    mod = harness.load_module(ROOT / "gpubench" / "drivers" / "sharded_roundtrip.py")
    return mod, mod.Driver({**cell.config, **config}, cell.traffic, SEED, "cpu",
                           rank=rank, world=cell.chips)


def test_the_shards_are_drawn_from_the_seed_and_the_rank():
    mod, d = _driver(ints=40 * BLOCK_INTS)

    def draw(rank, bitmap, live):
        out = torch.full((10 * BLOCK_INTS,), -1, dtype=torch.int32)
        return mod.draw_shard(out, SEED, rank, bitmap, live, 0.01)

    a = draw(1, 0, 10 * BLOCK_INTS)
    assert torch.equal(a, draw(1, 0, 10 * BLOCK_INTS))
    assert not torch.equal(a, draw(2, 0, 10 * BLOCK_INTS))
    assert not torch.equal(a, draw(1, 1, 10 * BLOCK_INTS))
    bits = np.unpackbits(tensor_to_words(a).view(np.uint8)).mean()
    assert abs(bits - 0.01) < 4 * (0.01 / (10 * BLOCK_INTS * 32)) ** 0.5
    # live ints, then padding
    part = draw(1, 0, 300)
    assert torch.equal(part[:300], a[:300]) and not part[300:].any()
    # the check's bitmap is the ranks' shards, joined
    d.make_inputs()
    whole = d.bitmap(0)
    assert torch.equal(whole[: d.n_l], d.shards[0])
    assert whole.shape == (40 * BLOCK_INTS,) and d.nb == 40


def test_the_sharded_spans_under_a_profiler(tmp_path):
    """The cell's operation in a gloo group of one: the program's sharded
    spans close in order, each in its parent, with the gathers' bytes; the
    pipelines' spans nest inside the sharded ones."""
    data = random_bitmap(3 * BLOCK_INTS, density=0.01, seed=5)
    nv = golden.chunk_count(len(data))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0, timeout=multihost.TIMEOUT)
    try:
        profiling.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            words_l, totals = tpar.encode_sharded(_torch(data), nv)
            stream, total, _ = tpar.stitch_global(words_l, totals, tpar.stitch_word_cap(totals))
            ints_l, _ = tpar.decode_sharded(stream, int(total), 3 * BLOCK_CHUNKS)
            all_gather(ints_l)
        got = profiling.spans()
    finally:
        dist.destroy_process_group()
        profiling.clear()
    eff = tpar.stitch_word_cap(totals)
    assert [(r.name, r.parent) for r in got] == [
        ("wah.encode", "wah.sharded.encode"),
        ("wah.gather", "wah.sharded.encode"),
        ("wah.sharded.encode", None),
        ("wah.sharded.word_cap", None),
        ("wah.gather", "wah.sharded.stitch"),
        ("wah.sharded.stitch", None),
        ("wah.decode", "wah.sharded.decode"),
        ("wah.sharded.decode", None),
        ("wah.gather", None),
    ]
    gathers = [r.counts for r in got if r.name == "wah.gather"]
    assert gathers == [{"route": "host", "bytes": 4}, {"route": "host", "bytes": 4 * eff},
                       {"route": "host", "bytes": 4 * 3 * BLOCK_INTS}]
    assert got[5].counts == {"bytes": 4 * eff}
    assert tensor_to_words(stream[: int(total)]).tolist() == golden.encode(data).tolist()
    by_name = {r.name: r for r in got}
    for r in got:  # each span lies inside its parent
        if r.parent:
            assert by_name[r.parent].t0 <= r.t0 <= r.t1 <= by_name[r.parent].t1


def test_the_sharded_spans_record_nothing_without_a_profiler():
    profiling.clear()
    data = random_bitmap(2 * BLOCK_INTS, density=0.01, seed=6)
    codec = tpar.ShardedCodec("cpu")
    np.testing.assert_array_equal(codec.decompress(codec.compress(data), len(data)), data)
    assert profiling.spans() == []


def test_the_exchange_counts_what_must_reach_a_rank():
    # the other ranks' live stream words and bitmap ints, 4 B each
    assert links.exchange_bytes(2_000_000_000, 960, 2_000_000_000 // 4, 250) == (
        4 * 710 + 4 * 1_500_000_000)
    assert links.exchange_bytes(100, 10, 100, 10) == 0
    assert links.exchange_seconds(100, 10, 0, 0) == 440 / links.LINK_BYTES_PER_S


def _metric(name):
    path = ROOT / "gpubench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_program_span_metrics_stay_silent_without_their_spans(monkeypatch):
    """A program without the sharded spans (the one before them) still
    records wah.encode: sharded.stitch_ms and sharded.gathered_MB then read
    None, not 0; with the spans they read their spans."""
    from gpubench.activity import Span

    op = harness.Op(0, "roundtrip", 1.0, 2.0, {})
    ctx = harness.Context([op], [Span("sharded.encode", 0, 0.0, 1.0)], 1.0, 0.0, 1)
    rec = profiling.SpanRecord
    old = [rec("wah.encode", 1.1, 1.2, None, 1, {})]
    monkeypatch.setattr(profiling, "spans", lambda: old)
    assert _metric("sharded.stitch_ms").read(ctx) is None
    assert _metric("sharded.gathered_MB").read(ctx) is None
    new = old + [rec("wah.sharded.word_cap", 1.2, 1.3, None, 2, {}),
                 rec("wah.gather", 1.3, 1.4, "wah.sharded.stitch", 3, {"bytes": 3_000_000}),
                 rec("wah.sharded.stitch", 1.3, 1.5, None, 3, {"bytes": 3_000_000}),
                 rec("wah.gather", 1.6, 1.7, None, 4, {"bytes": 5_000_000})]
    monkeypatch.setattr(profiling, "spans", lambda: new)
    assert _metric("sharded.stitch_ms").read(ctx) == pytest.approx(300.0)
    assert _metric("sharded.gathered_MB").read(ctx) == pytest.approx(8.0)
    # no device time on the CPU: the rooflines and the idle share stay silent
    for name in ("sharded.encode.roofline", "sharded.decode.roofline",
                 "sharded.exchange.roofline", "device.idle.sharded"):
        assert _metric(name).read(ctx) is None
