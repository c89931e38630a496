"""The readers of the program's spans (gpubench/program_spans.py and the
per-layer metrics on it) on hand-built windows: the values they give, None
where no program span falls in a traced operation (a program that records
none), and the spans outside the traced operations left out."""
import dataclasses

import pytest

from gpubench import harness, program_spans
from gpubench.activity import Span
from gpubench.tests.test_gpubench_harness import ROOT, small_cell
from wah_tpu_torch.utils import profiling
from wah_tpu_torch.utils.profiling import SpanRecord

API = ["api.validate_ms", "api.count_ms", "api.pad_ms", "api.other_ms", "api.h2d_GBps",
       "api.d2h_GBps"]
DEVICE = ["device.encode_issue_us", "device.decode_issue_us"]


def reader(name):
    return harness.load_module(ROOT / "layer_metrics" / f"{name}.py").read


def rec(name, t0, t1, parent, call, **counts):
    return SpanRecord(name, t0, t1, parent, call, counts)


def api_round_trip(t, call):
    """The program's spans of one round trip starting at t (s): compress
    1.0 s, decompress 2.0 s, in the order they close."""
    c, d = call, call + 1
    return [
        rec("wah.compress.to_device", t + 0.1, t + 0.3, "wah.compress", c, bytes=4e8),
        rec("wah.encode", t + 0.3, t + 0.31, "wah.compress.kernel", c),
        rec("wah.compress.kernel", t + 0.3, t + 0.4, "wah.compress", c),
        rec("wah.compress.from_device", t + 0.4, t + 0.6, "wah.compress", c, bytes=2e8),
        rec("wah.compress", t, t + 1.0, None, c),
        rec("wah.decompress.validate", t + 1.0, t + 1.5, "wah.decompress", d, bytes=2e8),
        rec("wah.decompress.count", t + 1.5, t + 1.75, "wah.decompress", d),
        rec("wah.decompress.pad", t + 1.75, t + 1.8, "wah.decompress", d, bytes=2e8),
        rec("wah.decompress.to_device", t + 1.8, t + 1.9, "wah.decompress", d, bytes=2e8),
        rec("wah.decode", t + 1.9, t + 1.91, "wah.decompress.kernel", d),
        rec("wah.decompress.kernel", t + 1.9, t + 2.0, "wah.decompress", d),
        rec("wah.decompress.from_device", t + 2.0, t + 2.8, "wah.decompress", d, bytes=4e8),
        rec("wah.decompress", t + 1.0, t + 3.0, None, d),
    ]


# api.validate_ms .. api.d2h_GBps of every round trip above: validate 0.5 s,
# count 0.25 s, pad 0.05 s; other = (1.0 - 0.5) + (2.0 - 1.8) = 0.7 s; H2D
# 6e8 B in 0.3 s; D2H 6e8 B in 1.0 s
API_WANT = {"api.validate_ms": 500.0, "api.count_ms": 250.0, "api.pad_ms": 50.0,
            "api.other_ms": 700.0, "api.h2d_GBps": 2.0, "api.d2h_GBps": 0.6}


def window(n_ops, op_s, traced):
    """n_ops operations of op_s seconds from t = 100 s; benchmark spans
    (their trace clock is another one) on the operations `traced`."""
    ops = [harness.Op(i, "roundtrip", 100 + i * op_s, 100 + (i + 1) * op_s)
           for i in range(n_ops)]
    spans = [Span("op", i, 0.0, 1.0) for i in traced]
    return harness.Context(ops, spans, 1.0, 0.5, len(traced))


def test_api_readers_on_a_window(monkeypatch):
    ctx = window(4, 3.0, traced=[1, 2])
    records = [r for i in range(4) for r in api_round_trip(100 + 3.0 * i, 1 + 2 * i)]
    # a warm-up before the window and another run's spans later in the process
    records = api_round_trip(10.0, 100) + records + api_round_trip(500.0, 200)
    monkeypatch.setattr(profiling, "spans", lambda: records)
    got = {name: reader(name)(ctx) for name in API}
    assert got == pytest.approx(API_WANT)
    # with the six phases, the parts add up to the round trip's 3 s
    assert sum(got[n] for n in API[:4]) + 1e3 * (0.2 + 0.1 + 0.2 + 0.1 + 0.1 + 0.8) \
        == pytest.approx(3000.0)
    assert set(program_spans.by_op(ctx)) == {1, 2}


def test_device_readers_on_a_window(monkeypatch):
    ctx = window(3, 0.004, traced=[0, 1, 2])
    records = []
    for i, (enc, dec) in enumerate([(100e-6, 200e-6), (150e-6, 250e-6), (200e-6, 300e-6)]):
        t = 100 + 0.004 * i
        records += [rec("wah.encode", t + 1e-4, t + 1e-4 + enc, None, 2 * i + 1),
                    rec("wah.decode", t + 2e-3, t + 2e-3 + dec, None, 2 * i + 2)]
    monkeypatch.setattr(profiling, "spans", lambda: records)
    assert reader("device.encode_issue_us")(ctx) == pytest.approx(150.0)
    assert reader("device.decode_issue_us")(ctx) == pytest.approx(250.0)


@pytest.mark.parametrize("name", API + DEVICE)
def test_readers_are_silent_without_program_spans(monkeypatch, name):
    ctx = window(4, 3.0, traced=[1, 2])
    # only spans outside the traced operations: the warm-up, the untraced end
    monkeypatch.setattr(profiling, "spans",
                        lambda: api_round_trip(10.0, 1) + api_round_trip(109.0, 3))
    assert reader(name)(ctx) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader(name)(ctx) is None
    monkeypatch.delattr(profiling, "spans")  # a program that records no span
    assert reader(name)(ctx) is None
    assert reader(name)(None) is None


def test_a_span_across_an_operations_end_is_left_out(monkeypatch):
    ctx = window(2, 3.0, traced=[0, 1])
    records = [rec("wah.decompress.count", 102.5, 103.5, "wah.decompress", 1),
               rec("wah.decompress.count", 103.5, 104.0, "wah.decompress", 2)]
    monkeypatch.setattr(profiling, "spans", lambda: records)
    assert program_spans.by_op(ctx) == {1: records[1:]}
    assert reader("api.count_ms")(ctx) == pytest.approx(500.0)


@pytest.mark.parametrize("name,metrics", [("api-roundtrip-2e-4", API),
                                          ("device-roundtrip-sweep", DEVICE)])
def test_a_traced_cpu_run_reports_the_program_span_metrics(name, metrics):
    """A whole traced run at a test's size: the program records its spans
    under the harness's profiler, and each new metric of the cell reads
    them. The trace starts at the second operation, so that a busy CPU
    still reaches it within the window."""
    cell = small_cell(name)
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "trace_skip": 1})
    r = harness.run_cell(cell, 2**31 + 12345, 1.0, True, "cpu")
    assert r["correct"]
    assert set(metrics) <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] >= 0 for m in metrics)
    assert all(r["metrics"][m]["value"] > 0 for m in metrics if m.endswith(("GBps", "_us")))
