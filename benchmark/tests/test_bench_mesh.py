"""The mesh ingest cell (`clients/ingest_mesh.py`, `hscbench/mesh_spans.py`,
`layer_metrics/idle_mesh_*_pct.mesh.py`) on the CPU: a tiny 4-shard cell
on 4 CPU shards beside `test_bench_harness.py`'s tiny cells, the judge's
draw, a gather fault, the per-card span arithmetic, and the new entries of
`BENCHMARK.json`.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
from test_bench_harness import NAME, TINY_FLAT, bench_run, committed, tiny  # noqa: F401  (the fixture)

from hscbench import mesh_spans, spans
from hscbench.profile import Trace

SHARDS = 4
BATCH = 4
STAGES = ["upload", "init", "peaks", "loop", "collect"]
METRICS = [f"idle_mesh_{s}_pct.mesh" for s in STAGES]


@pytest.fixture
def mesh_tiny(tiny, tmp_path):  # noqa: F811
    """`tiny` with a flat cell on a 4-shard mesh: 35-block calls (2
    super-batches of 16 and 3 blocks, so the last pads) of a 40-block pool,
    2 blocks judged from each shard's slice; the per-card span metrics."""
    cfg_dir = tmp_path / "configs"
    flat = committed("flat-flagship-mesh4")
    body = dict(flat, codec=dict(flat["codec"], **TINY_FLAT), batch_size=BATCH)
    (cfg_dir / "fm.json").write_text(json.dumps(body))
    (tmp_path / "traffic" / "ingm.json").write_text(
        json.dumps({"client": "ingest_mesh", "corpus_blocks": 35, "pool_blocks": 40}))
    real = bench_run.load_benchmark()
    by = {m["name"]: m for m in real["end_to_end"] + real["per_layer"]}
    e2e = [dict(m, workloads=m["workloads"] + ["fm"]) if m["name"] == "encode_mb_s" else m
           for m in tiny["end_to_end"]]
    return dict(
        tiny,
        configs=tiny["configs"] + [{"name": "fm", "file": str(cfg_dir / "fm.json")}],
        workloads=tiny["workloads"] + [{"name": "fm", "config": "fm", "traffic": "ingm", "chips": SHARDS}],
        end_to_end=e2e,
        per_layer=tiny["per_layer"] + [dict(by[n], workloads=["fm"]) for n in METRICS],
    )


def test_a_sound_mesh_run_is_correct(mesh_tiny):
    r = bench_run.execute(mesh_tiny, "fm", 2**31 + 21, 0.8, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"encode_mb_s", "setup_s"}
    assert r["device"]["count"] == SHARDS


def test_a_run_holds_the_configured_threads_and_restores_the_process_count(mesh_tiny, monkeypatch):
    import torch

    import hsc_torch.parallel.dp as dp

    before = torch.get_num_threads()
    seen = []
    real = dp.gather_blocks

    def counted(encs, b):
        seen.append(torch.get_num_threads())
        return real(encs, b)

    monkeypatch.setattr(dp, "gather_blocks", counted)
    r = bench_run.execute(mesh_tiny, "fm", 2**31 + 24, 0.4, False, device="cpu")
    assert r["correct"], r["checks"]
    assert seen and set(seen) == {committed("flat-flagship-mesh4")["intra_op_threads"]} == {1}
    assert torch.get_num_threads() == before


def test_a_traced_mesh_run_reads_its_span_metrics(mesh_tiny):
    r = bench_run.execute(mesh_tiny, "fm", 2**31 + 22, 0.8, True, device="cpu")
    assert r["correct"], r["checks"]
    values = [r["metrics"][n]["value"] for n in METRICS]
    assert all(0 <= v <= 100 for v in values), values
    # the CPU has no device events: every card idle the whole window
    assert sum(values) <= 100.0 + 1e-6


def test_a_program_without_the_mesh_spans_reports_none_of_them(mesh_tiny, monkeypatch):
    """The parent of the spans: its traced run is correct and leaves the
    span metrics out, without raising."""
    import contextlib

    import hsc_torch.parallel.dp as dp

    monkeypatch.setattr(dp, "scope", lambda name: contextlib.nullcontext())
    r = bench_run.execute(mesh_tiny, "fm", 17, 0.6, True, device="cpu")
    assert r["correct"], r["checks"]
    assert not set(METRICS) & set(r["metrics"])


def test_the_draw_holds_two_blocks_of_each_shards_slice(mesh_tiny):
    run = bench_run.Run(mesh_tiny, "fm", 9, 0.4, False, device="cpu")
    try:
        rng = np.random.default_rng(3)
        seen = set()
        for _ in range(40):
            blocks = run.client.draw(rng)
            assert len(blocks) == 8 == len(set(blocks))
            first = blocks[0] - blocks[0] % (BATCH * SHARDS)
            assert first + BATCH * SHARDS <= 35  # a whole super-batch
            shards = [(b - first) // BATCH for b in blocks]
            assert sorted(shards) == [0, 0, 1, 1, 2, 2, 3, 3]
            seen.add(first)
        assert seen == {0, BATCH * SHARDS}
    finally:
        run.close()


def test_two_shards_swapped_in_the_gather_is_not_correct(mesh_tiny, monkeypatch):
    import hsc_torch.parallel.dp as dp

    real = dp.gather_blocks

    def swapped(encs, b):
        return real([encs[1], encs[0]] + list(encs[2:]), b)

    monkeypatch.setattr(dp, "gather_blocks", swapped)
    r = bench_run.execute(mesh_tiny, "fm", 2**31 + 23, 0.4, False, device="cpu")
    assert not r["correct"], r["checks"]
    assert r["checks"]["structure_faults"]["value"] == 0  # the fault is in the order, not the format


def test_the_control_fails_the_committed_limits_in_the_mesh_cell(mesh_tiny):
    run = bench_run.Run(mesh_tiny, "fm", 2**31 + 99, 0.4, False, device="cpu")
    try:
        run.client.setup()
        run.client.window(0.4, None)
        run.client.free()
        limits = run.config["limits"]
        assert all(v <= limits[k] for k, v in run.client.judge().items())
        assert any(v > limits[k] for k, v in run.client.judge(control=True).items())
    finally:
        run.close()


def test_the_per_card_span_share_by_hand():
    def dev(ts, dur, card):
        return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur, "args": {"device": card}}

    def span(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}

    t = Trace([dev(10, 20, 0), dev(50, 10, 1), span("hsc:mesh.a", 0, 100), span("hsc:mesh.b", 20, 35)],
              (0, 100))

    def run(cards):
        return types.SimpleNamespace(trace=t, card_indices=cards, log=lambda msg: None)

    # card 0 idle 80 of 100, card 1 idle 90
    assert mesh_spans.idle_in_span_per_card_pct(run([0, 1]), "hsc:mesh.a") == pytest.approx(85.0)
    # in [20, 55]: card 0 idle on [30, 55] (25), card 1 on [20, 50] (30);
    # no card busy only on [30, 50] (20)
    assert mesh_spans.idle_in_span_per_card_pct(run([0, 1]), "hsc:mesh.b") == pytest.approx(27.5)
    assert spans.idle_in_span_pct(run([0, 1]), "hsc:mesh.b") == pytest.approx(20.0)
    # on one card the two definitions agree
    for card in (0, 1):
        assert (mesh_spans.idle_in_span_per_card_pct(run([card]), "hsc:mesh.b")
                == pytest.approx(spans.idle_in_span_pct(run([card]), "hsc:mesh.b")))
    assert mesh_spans.idle_in_span_per_card_pct(run([0, 1]), "hsc:mesh.none") is None


def test_the_new_entries_of_benchmark_json():
    bench = bench_run.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    cell = cells["flat-ingest-mesh4"]
    assert cell["config"] == "flat-flagship-mesh4" and cell["traffic"] == "ingest-mesh-4k" and cell["chips"] == 4
    names = [cell["name"], cell["config"], cell["traffic"]] + METRICS
    assert all(NAME.match(n) for n in names), names
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    by = {m["name"]: m for m in bench["per_layer"]}
    for n in METRICS:
        assert by[n]["workloads"] == ["flat-ingest-mesh4"] and by[n]["moves"] == "encode_mb_s"
        assert by[n]["unit"] == "%" and by[n]["better"] == "lower" and by[n]["source"] == "program_span"
    assert len({by[n]["layer"] for n in METRICS}) == 1
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "flat-ingest-mesh4" in e2e["encode_mb_s"]["workloads"]
    config = next(c for c in bench["configs"] if c["name"] == "flat-flagship-mesh4")
    body = committed("flat-flagship-mesh4")
    flat = committed("flat-flagship")
    assert body["codec"] == flat["codec"] and body["limits"] == flat["limits"]
    assert body["mesh"] == {"data": 4} and body["batch_size"] == 64 and body["judge"]["blocks_per_call"] == 8
    assert config["reduced"] == body["reduced"] == ["hosts", "num_levels"]
    # each cut stated, and the one level is the flat codec's
    assert set(body["cuts"]) == set(body["reduced"]) and body["num_levels"] == len(body["codec"]["counts"]) == 1
    assert "configs[1]" in config["source"] and "configs[4]" in config["source"] and len(config["source"]) <= 200
