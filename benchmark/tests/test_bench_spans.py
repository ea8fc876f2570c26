"""The span metrics (`hscbench/spans.py`, `layer_metrics/idle_*_pct.*`) on
the CPU: the arithmetic on a hand-built trace, and traced runs of the tiny
cells of `test_bench_harness.py`.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
"""

from __future__ import annotations

import contextlib
import types

import pytest
from test_bench_harness import bench_run, tiny  # noqa: F401  (the fixture)

from hscbench import spans
from hscbench.profile import Trace

ENCODE = ["idle_gather_pct.encode", "idle_pipeline_pct.encode", "idle_pack_pct.encode", "idle_assemble_pct.encode"]
RESTORE = ["idle_unpack_pct.restore", "idle_dispatch_pct.restore", "idle_drain_pct.restore", "idle_stack_pct.restore"]


def _run(trace, cards):
    return types.SimpleNamespace(trace=trace, card_indices=cards, log=lambda msg: None)


def test_the_span_arithmetic():
    def dev(cat, ts, dur, card):
        return {"cat": cat, "name": "k", "ts": ts, "dur": dur, "args": {"device": card}}

    def span(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}

    ev = [
        dev("kernel", 10, 20, 0), dev("gpu_memcpy", 50, 10, 1), dev("kernel", 70, 10, 2),
        dev("kernel", 95, 20, 0),  # runs past the window's end: busy to 100
        span("hsc:a", 0, 40), span("hsc:a", 5, 10),  # nested: counts once
        span("hsc:a", -20, 25),  # straddles the window's start
        span("hsc:b", 55, 55),  # straddles its end
        span("hsc:d", 120, 10),  # after the window
        {"cat": "cpu_op", "name": "hsc:c", "ts": 0, "dur": 100},  # a torch op, not a span
    ]
    t = Trace(ev, (0, 100))
    # cards 0 and 1 idle on [0, 10], [30, 50], [60, 95]
    assert spans.idle_intervals(t, [0, 1]) == [(0, 10), (30, 50), (60, 95)]
    assert spans.idle_in_span_pct(_run(t, [0, 1]), "hsc:a") == pytest.approx(20.0)  # 0-10, 30-40
    assert spans.idle_in_span_pct(_run(t, [0, 1]), "hsc:b") == pytest.approx(35.0)  # 60-95
    # card 2 busy on 70-80 too
    assert spans.idle_in_span_pct(_run(t, [0, 1, 2]), "hsc:b") == pytest.approx(25.0)
    assert spans.idle_in_span_pct(_run(t, [0, 1]), "hsc:d") == 0.0
    assert spans.idle_in_span_pct(_run(t, [0, 1]), "hsc:c") is None
    assert spans.idle_in_span_pct(_run(None, [0]), "hsc:a") is None
    assert spans.overlap([(0, 2), (4, 6)], [(1, 5)]) == 2


def _with_span_metrics(tiny):  # noqa: F811
    real = bench_run.load_benchmark()
    by = {m["name"]: m for m in real["per_layer"]}
    added = [dict(by[n], workloads=["fi", "hi"]) for n in ENCODE] + [dict(by[n], workloads=["fr"]) for n in RESTORE]
    return dict(tiny, per_layer=tiny["per_layer"] + added)


@pytest.mark.parametrize("cell", ["fi", "hi", "fr"])
def test_a_traced_run_reads_its_span_metrics(tiny, cell):  # noqa: F811
    r = bench_run.execute(_with_span_metrics(tiny), cell, 2**31 + 5, 0.8, True, device="cpu")
    assert r["correct"], r["checks"]
    names, idle = (ENCODE, "device_idle_pct.encode") if cell != "fr" else (RESTORE, "device_idle_pct.restore")
    values = [r["metrics"][n]["value"] for n in names]
    assert all(0 <= v <= 100 for v in values), values
    assert sum(values) <= r["metrics"][idle]["value"] + 0.5


def test_a_program_without_the_spans_reports_none_of_them(tiny, monkeypatch):  # noqa: F811
    """The parent of the spans: its traced run reports the other metrics
    and leaves the span metrics out, without raising."""
    import hsc_torch.runtime

    monkeypatch.setattr(hsc_torch.runtime, "scope", lambda name: contextlib.nullcontext())
    r = bench_run.execute(_with_span_metrics(tiny), "fi", 17, 0.6, True, device="cpu")
    assert r["correct"]
    assert "device_idle_pct.encode" in r["metrics"]
    assert not set(ENCODE) & set(r["metrics"])
