"""The restore-levels cell (`clients/restore_levels.py`, `reference/levels.py`)
on the CPU at a tiny geometry: a sound run is correct; both controls (a
bfloat16 epilogue, every stream through the top level's representations)
and decode faults (one level's rows dropped, a value off by one ulp) are
not; the client's launches are the program's decode units; a traced run
reads the cell's two per-level metrics, and a program without the span
and the count (the parent of both) reads neither and still completes.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_bench_harness import TINY_HIER, bench_run, committed, tiny  # noqa: E402,F401

from hscbench import inputs, traffic  # noqa: E402
from hscbench.layers import load_file  # noqa: E402

METRICS = ["idle_levelsum_pct.hrestore", "host_summed_rows_per_block.hrestore"]
# the tiny writer's blocks: 1 to 23 of the 24 top events raw, so every
# block holds both levels
RAW_1_TO_23 = [0] + [1] * 23


@pytest.fixture
def levels_bench(tiny, tmp_path):  # noqa: F811
    """`tiny` with a distributed hierarchy config and its restore cell,
    ``hr``, reporting `decode_mb_s`, `setup_s` and the two metrics."""
    dist = committed("hier-flagship-dist")
    path = tmp_path / "configs" / "hd.json"
    path.write_text(json.dumps(dict(dist, codec=dict(dist["codec"], **TINY_HIER), batch_size=3,
                                    writer={"blocks_by_raw_events": RAW_1_TO_23},
                                    judge={"blocks_per_call": 6})))
    with open(os.path.join(traffic.TRAFFIC_DIR, "rl.json"), "w") as f:
        json.dump({"client": "restore_levels", "container_blocks": 24, "corpus_blocks": 11}, f)
    real = bench_run.load_benchmark()
    by = {m["name"]: m for m in real["per_layer"]}
    e2e = [dict(m, workloads=m["workloads"] + ["hr"]) if m["name"] == "decode_mb_s" else m
           for m in tiny["end_to_end"]]
    return dict(
        tiny,
        configs=tiny["configs"] + [{"name": "hd", "file": str(path)}],
        workloads=tiny["workloads"] + [{"name": "hr", "config": "hd", "traffic": "rl", "chips": 1}],
        end_to_end=e2e,
        per_layer=tiny["per_layer"] + [dict(by[n], workloads=["hr"]) for n in METRICS],
    )


def test_the_committed_cell_is_what_it_says():
    bench = bench_run.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == "hier-restore")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("hier-flagship-dist", "restore-levels-1k", 1)
    dist, hier = committed("hier-flagship-dist"), committed("hier-flagship")
    assert dist["codec"] == hier["codec"] and dist["form"] == "distributed" and dist["reduced"] == []
    counts = dist["writer"]["blocks_by_raw_events"]
    assert len(counts) <= dist["codec"]["num_coefs"][-1] + 1 and min(counts) >= 0
    assert 0 < counts[0] < sum(counts)  # blocks of level 0 only, and of both levels
    assert traffic.load_mix("restore-levels-1k")["client"] == "restore_levels"
    for name in METRICS:
        m = next(m for m in bench["per_layer"] if m["name"] == name)
        assert m["workloads"] == ["hier-restore"] and m["moves"] == "decode_mb_s"


@pytest.mark.parametrize("blocks", [[1], [0, 0, 3], [0] * 24 + [1], [2, 1, 0, 1]],
                         ids=["all_singletons", "two_raw", "all_raw", "mixed"])
def test_the_writer_draws_each_blocks_raw_events_from_the_counts(blocks):
    """A block's count of raw top events follows ``blocks_by_raw_events``,
    on top events of the configuration's count, the rest singletons."""
    client = load_file(os.path.join(bench_run.BENCH_DIR, "clients", "restore_levels.py"), "client_restore_levels")
    cfg = inputs.codec_config({"codec": TINY_HIER})
    raw = cfg.counts[1]
    _, atoms, _, _ = client.top_events(cfg, 400, {"blocks_by_raw_events": blocks}, 2**31 + 11)
    assert atoms.shape == (400, cfg.num_coefs[1])
    assert ((0 <= atoms) & (atoms < raw + cfg.channels[1])).all()
    n_raw = (atoms < raw).sum(1)
    seen = np.bincount(n_raw, minlength=len(blocks))
    assert len(seen) == len(blocks) and set(np.flatnonzero(seen)) == set(np.flatnonzero(blocks))
    share = np.asarray(blocks) / sum(blocks)
    assert np.abs(seen / 400 - share).max() < 0.1


def test_the_writer_refuses_counts_past_the_top_events():
    client = load_file(os.path.join(bench_run.BENCH_DIR, "clients", "restore_levels.py"), "client_restore_levels")
    cfg = inputs.codec_config({"codec": TINY_HIER})
    with pytest.raises(ValueError, match="blocks_by_raw_events"):
        client.top_events(cfg, 4, {"blocks_by_raw_events": [1] * (cfg.num_coefs[1] + 2)}, 1)


def test_a_sound_run_is_correct(levels_bench):
    r = bench_run.execute(levels_bench, "hr", 2**31 + 7, 0.6, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"decode_mb_s", "setup_s"}
    assert set(r["checks"]) == {"structure_faults", "rows_mismatch", "rows_unjudged"}


def test_a_configuration_not_distributed_is_refused(levels_bench, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the refused run's own directory
    path = tmp_path / "configs" / "hd.json"
    path.write_text(json.dumps({k: v for k, v in json.loads(path.read_text()).items() if k != "form"}))
    with pytest.raises(ValueError, match="distributed"):
        bench_run.execute(levels_bench, "hr", 3, 0.2, False, device="cpu")


@pytest.mark.parametrize("control", [True, "top_reps"])
def test_each_control_fails_the_committed_limits(levels_bench, control):
    run = bench_run.Run(levels_bench, "hr", 2**31 + 99, 0.4, False, device="cpu")
    try:
        run.client.setup()
        run.client.window(0.4, None)
        run.client.free()
        limits = committed("hier-flagship-dist")["limits"]
        sound = run.client.judge()
        assert all(v <= limits[k] for k, v in sound.items()), sound
        ctrl = run.client.judge(control=control)
        assert any(v > limits[k] for k, v in ctrl.items()), ctrl
    finally:
        run.client.cleanup()
        run.close()


def _level_dropped(real):
    """`_decode_chunks` with every level-0 decode unit left out."""

    def broken(self, *args, **kwargs):
        real_units = self._units

        def units(chunk, top, mode):
            out = real_units(chunk, top, mode)
            return [u for u in out if u[1] != 0] or out

        self._units = units
        try:
            yield from real(self, *args, **kwargs)
        finally:
            del self._units

    return broken


def _one_ulp(real):
    """`_decode_chunks` with one value of every chunk one ulp off."""

    def broken(self, *args, **kwargs):
        for chunk in real(self, *args, **kwargs):
            chunk = np.array(chunk)
            chunk.reshape(-1).view(np.uint32)[chunk.size // 2] += 1
            yield chunk

    return broken


@pytest.mark.parametrize("fault", [_level_dropped, _one_ulp], ids=["level_dropped", "one_ulp"])
def test_a_decode_fault_is_not_correct(levels_bench, monkeypatch, fault):
    import hsc_torch.runtime as runtime

    monkeypatch.setattr(runtime.CorpusEncoder, "_decode_chunks", fault(runtime.CorpusEncoder._decode_chunks))
    r = bench_run.execute(levels_bench, "hr", 717171, 0.4, False, device="cpu")
    assert not r["correct"], r["checks"]
    assert r["checks"]["rows_mismatch"]["value"] > 0


def test_a_traced_run_reads_both_metrics(levels_bench):
    r = bench_run.execute(levels_bench, "hr", 2**31 + 5, 0.8, True, device="cpu")
    assert r["correct"], r["checks"]
    assert 0 <= r["metrics"]["idle_levelsum_pct.hrestore"]["value"] <= 100
    # every block of the tiny writer's holds both levels: two rows summed
    # a block, one a level
    assert r["metrics"]["host_summed_rows_per_block.hrestore"]["value"] == 2.0
    assert set(r["metrics"]) == set(METRICS)


def test_the_launches_are_one_a_level_a_chunk(levels_bench):
    """The traced calls' decode launches, as the client counts them, are the
    program's decode units (one `hsc:decode.dispatch` span each), and hold
    the events of the levels the slices' records store."""
    run = bench_run.Run(levels_bench, "hr", 2**31 + 3, 0.3, True, device="cpu")
    try:
        client = run.client
        client.setup()
        client.window(0.3, 0.2)
        launches = client.launches()["int_decode"]
        dispatched = sum(1 for e in run.trace.host_ops if e["name"] == "hsc:decode.dispatch")
        assert client.traced_calls > 0 and len(launches) == dispatched
        stored = sum(int(client.per_level[s:s + client.corpus].sum()) for s in client.starts.seen[:client.traced_calls])
        assert sum(launch["events"] for launch in launches) == stored
        assert {(launch["width"], launch["atoms"]) for launch in launches} == {(16, 8), (48, 12)}
    finally:
        client.free()
        client.cleanup()
        run.close()


def test_a_program_without_the_span_and_the_count_reads_neither(levels_bench, monkeypatch):
    """The runtime as the client sees it lacks the count (a module with
    every other name of `hsc_torch.runtime`), and the span never opens."""
    import hsc_torch
    import hsc_torch.runtime as runtime

    real_scope = runtime.scope
    monkeypatch.setattr(runtime, "scope",
                        lambda name: contextlib.nullcontext() if name == "hsc:decode.levelsum" else real_scope(name))
    without = types.ModuleType(runtime.__name__)
    without.__dict__.update({k: v for k, v in vars(runtime).items() if k != "ROWS_SUMMED_BY_LEVEL"})
    monkeypatch.setattr(hsc_torch, "runtime", without)
    monkeypatch.setitem(sys.modules, runtime.__name__, without)
    r = bench_run.execute(levels_bench, "hr", 19, 0.6, True, device="cpu")
    assert r["correct"], r["checks"]
    assert not set(METRICS) & set(r["metrics"])
