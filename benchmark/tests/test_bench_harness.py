"""The benchmark harness on the CPU: its generators, `BENCHMARK.json`, the
roofline arithmetic, the reference against the port's plain paths, the
imports, and whole runs at a tiny geometry.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
The tests that need a card are marked `cuda` and skip without one.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run as bench_run  # noqa: E402
from hscbench import inputs, judge, layers, traffic  # noqa: E402
from reference import container, spec  # noqa: E402
from reference.dictionary import MultilevelDictionary  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

TINY_FLAT = dict(counts=[8], scales=[16], block_size=2048, num_coefs=[64], num_select=4)
TINY_HIER = dict(counts=[8, 4], scales=[16, 48], block_size=2048, num_coefs=[48, 24], num_select=4)


def committed(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A BENCHMARK.json of tiny cells (one of each shape the real cells
    have), with the committed configurations' limits; every container of
    a window is kept and judged, in a small store."""
    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    flat = committed("flat-flagship")
    hier = committed("hier-flagship")
    configs = {
        "f": dict(flat, codec=dict(flat["codec"], **TINY_FLAT), batch_size=4, judge={"blocks_per_call": 12}),
        "h": dict(hier, codec=dict(hier["codec"], **TINY_HIER), batch_size=4, judge={"blocks_per_call": 4}),
    }
    for name, c in configs.items():
        (cfg_dir / f"{name}.json").write_text(json.dumps(c))
    monkeypatch.setattr(bench_run, "TRACED_SECONDS", 0.5)
    monkeypatch.setattr(judge, "STORE_SHARE", 1.0)
    monkeypatch.setattr(judge, "STORE_MB", 8)
    mix_dir = tmp_path / "traffic"
    mix_dir.mkdir()
    (mix_dir / "ing.json").write_text(json.dumps({"client": "ingest", "corpus_blocks": 12, "pool_blocks": 20}))
    (mix_dir / "rst.json").write_text(json.dumps({"client": "restore", "container_blocks": 24, "corpus_blocks": 12}))
    monkeypatch.setattr(traffic, "TRAFFIC_DIR", str(mix_dir))
    real = bench_run.load_benchmark()
    by = {m["name"]: m for m in real["end_to_end"] + real["per_layer"]}
    ing = ["fi", "hi"]

    def metric(name, cells):
        return dict(by[name], workloads=cells)

    return {
        "configs": [{"name": n, "file": str(cfg_dir / f"{n}.json")} for n in configs],
        "workloads": [
            {"name": "fi", "config": "f", "traffic": "ing", "chips": 1},
            {"name": "hi", "config": "h", "traffic": "ing", "chips": 1},
            {"name": "fr", "config": "f", "traffic": "rst", "chips": 1},
        ],
        "end_to_end": [metric("encode_mb_s", ing), metric("decode_mb_s", ["fr"]), by["setup_s"]],
        "per_layer": [metric("host_pack_pct.encode", ing), metric("device_idle_pct.encode", ["fi", "hi"]),
                      metric("device_idle_pct.restore", ["fr"])],
    }


# ---- generators ------------------------------------------------------------


def test_generators_repeat_for_a_seed_and_differ_across_seeds():
    cfg = inputs.codec_config({"codec": dict(committed("hier-flagship")["codec"], **TINY_HIER)})
    big = 2**31 + 12345
    d1, d2, d3 = (MultilevelDictionary.generate(cfg, seed=inputs.derived_seed(s, 1)) for s in (big, big, big + 1))
    assert all(np.array_equal(a, b) for a, b in zip(d1.dicts, d2.dicts))
    assert not np.array_equal(d1.dicts[0], d3.dicts[0])
    sig = {"rates": 0.002, "amplitude_range": [0.25, 2.0]}
    p1, p2, p3 = (inputs.signal_pool(d1, 5, sig, s, "cpu", chunk=2) for s in (big, big, big + 1))
    assert np.array_equal(p1, p2) and not np.array_equal(p1, p3)
    assert np.abs(p1).max() > 0
    flat = inputs.codec_config({"codec": dict(committed("flat-flagship")["codec"], **TINY_FLAT)})
    r1, r2, r3 = (inputs.container_records(flat, 6, s) for s in (big, big, big + 1))
    assert np.array_equal(r1, r2) and not np.array_equal(r1, r3)
    s1, s2, s3 = ([next(g) for _ in range(20)] for g in (traffic.starts(100, s) for s in (big, big, big + 1)))
    assert s1 == s2 and s1 != s3
    assert all(0 <= v < 100 for v in s1 + s3)


# ---- BENCHMARK.json ----------------------------------------------------------


def test_benchmark_json_follows_its_rules():
    bench = bench_run.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in list(cells.values()) + list(configs.values()) + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e_cells = {
        m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]
    }
    for w in cells.values():
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
        mix = traffic.load_mix(w["traffic"])
        assert os.path.exists(os.path.join(BENCH, "clients", f"{mix['client']}.py"))
        assert w["name"] in e2e_cells["setup_s"]
        assert sum(w["name"] in v for v in e2e_cells.values()) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= e2e_cells[m["moves"]], m["name"]
        assert os.path.exists(os.path.join(BENCH, "layer_metrics", f"{m['name']}.py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
            assert os.path.exists(os.path.join(BENCH, "roofline", f"{m['name'][:-len('_roofline')]}.py"))
    for c in configs.values():
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        inputs.codec_config(body)  # a valid codec contract
        assert body["name"] == c["name"] and len(c["source"]) <= 200
        assert sum(cells[w]["config"] == c["name"] for w in cells) >= 1
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    assert 1 <= bench["run_seconds"] <= 51


# ---- the roofline arithmetic -------------------------------------------------


def test_roofline_reproduces_the_kernel_table_bounds():
    # the greedy loop, one 64-block flat-flagship batch: 268 MB of scores
    loop = dict(blocks=64, atoms=64, npos=16353, lag=63, events=64 * 512)
    assert layers.least_seconds("mp_loop", [loop]) * 1e3 == pytest.approx(0.0804, abs=5e-5)
    # the integer decode of the same batch: 4.2 MB of rows
    dec = dict(blocks=64, events=64 * 512, width=32, atoms=64, n=16384)
    assert layers.least_seconds("int_decode", [dec]) * 1e3 == pytest.approx(0.00137, abs=5e-6)
    # the int8 init of the flagship hierarchy's level 1: the 400 MB score buffer
    init = dict(blocks=64, events=64 * 512, n_raw=32, width=65, channels=64, atoms=96, npos=16289)
    assert layers.least_seconds("int8_init", [init]) * 1e3 == pytest.approx(0.1197, abs=5e-4)


def test_the_trace_arithmetic():
    from hscbench.profile import Trace

    ev = [
        {"cat": "user_annotation", "name": "bench:traced", "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "bench:encode", "ts": 0, "dur": 60},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 40, "dur": 20},
        {"cat": "kernel", "name": "void mp_encode_kernel(float*)", "ts": 10, "dur": 20, "args": {"device": 0}},
        {"cat": "kernel", "name": "void mp_encode_kernel(float*)", "ts": 20, "dur": 20, "args": {"device": 0}},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 10, "args": {"device": 1}},
    ]
    t = Trace(ev, (0, 100))
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s(0) == pytest.approx(30e-6) and t.busy_s(1) == pytest.approx(10e-6)
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.kernel_s("mp_encode_kernel") == (pytest.approx(40e-6), 2)
    gaps = dict(t.idle_gaps())
    assert gaps["bench:encode / no torch op"] == pytest.approx(10e-6)  # 0-10
    assert gaps["bench:encode / aten::copy_"] == pytest.approx(20e-6)  # 40-60
    assert gaps["outside any span / no torch op"] == pytest.approx(30e-6)  # 70-100


# ---- the reference against the port's plain paths ------------------------------


def test_reference_copies_agree_with_the_port():
    from hsc_torch.dictionary import MultilevelDictionary as PortDictionary
    from hsc_torch.io import bitstream
    from hsc_torch.oracle import mp as oracle
    from hsc_torch.params import dictionary_from_arrays
    from hsc_torch.runtime import CorpusEncoder

    for geo in (TINY_FLAT, TINY_HIER):
        cfg = inputs.codec_config({"codec": dict(committed("hier-flagship")["codec"], **geo)})
        ours = MultilevelDictionary.generate(cfg, seed=5)
        port_cfg = dictionary_from_arrays(cfg.to_json(), ours.dicts).config
        theirs = PortDictionary.generate(port_cfg, seed=5)
        assert all(np.array_equal(a, b) for a, b in zip(ours.dicts, theirs.dicts))
        for k in range(cfg.num_levels):
            assert np.array_equal(ours.representations(k), theirs.representations(k))
            assert np.array_equal(ours.augmented(k), theirs.augmented(k))
    # the port's container parsed by the frozen reader
    cfg = inputs.codec_config({"codec": dict(committed("flat-flagship")["codec"], **TINY_FLAT)})
    mld = MultilevelDictionary.generate(cfg, seed=3)
    port = dictionary_from_arrays(cfg.to_json(), mld.dicts)
    xs = inputs.signal_pool(mld, 5, {"rates": 0.002, "amplitude_range": [0.25, 2.0]}, 9, "cpu")
    blob = CorpusEncoder(port, device="cpu", batch_size=2).encode(xs, index=True)
    _, blocks = bitstream.unpack_corpus(blob)
    offsets = container.read_index(blob)
    assert np.array_equal(offsets, container.block_offsets(blob)[1])
    rep_q, step = spec.rep_quantize(mld.representations(0)[:, :, None], cfg.rep_bits)
    for b, streams in enumerate(blocks):
        ours_s = container.read_block(cfg, blob, int(offsets[b]))[0][0]
        theirs_s = streams[0][1]
        assert np.array_equal(ours_s.positions, theirs_s.positions)
        assert np.array_equal(ours_s.codes, theirs_s.codes) and ours_s.scale == theirs_s.scale
        # the integer decode, bitwise the oracle's
        got = spec.int_decode(ours_s.positions, ours_s.atoms, ours_s.codes, ours_s.scale, rep_q, step,
                              cfg.block_size)
        want = oracle.mp_decode_integer(theirs_s, rep_q, step, cfg.block_size)[:, 0]
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        # the spec's float32 loop, bitwise the oracle's given the same init
        s0 = oracle.correlate_bank(xs[b][:, None], mld.augmented(0))
        g = spec.gram(torch.as_tensor(mld.augmented(0), dtype=torch.float64)).float().numpy()
        p, a, c, scale = spec.spec_loop_f32(s0, g, np.ones(cfg.counts[0], np.float32), cfg, 0)
        o = oracle.mp_encode(xs[b][:, None], mld.augmented(0), port.gram(0), num_coefs=cfg.num_coefs[0],
                             scores0=s0, num_select=cfg.num_select)
        assert np.array_equal(p, o.positions) and np.array_equal(c, o.codes) and scale == o.scale
    # the frozen writer's records, read by the port
    recs = inputs.container_records(cfg, 3, 4)
    path_blob = bytearray()

    class Sink:
        def write(self, data):
            path_blob.extend(data)

    container.write_container(cfg, recs, Sink())
    _, theirs = bitstream.unpack_corpus(bytes(path_blob))
    assert bitstream.read_index(bytes(path_blob)) is not None
    for b in range(3):
        ours_s = container.read_block(cfg, bytes(path_blob), int(container.read_index(bytes(path_blob))[b]))[0][0]
        assert np.array_equal(ours_s.codes, theirs[b][0][1].codes)


def test_level1_exact_init_agrees_with_the_spec():
    from hsc_torch.oracle import mp as oracle

    cfg = inputs.codec_config({"codec": dict(committed("hier-flagship")["codec"], **TINY_HIER)})
    mld = MultilevelDictionary.generate(cfg, seed=2)
    xs = inputs.signal_pool(mld, 1, {"rates": 0.002, "amplitude_range": [0.25, 2.0]}, 4, "cpu")
    l0 = oracle.mp_encode(xs[0][:, None], mld.augmented(0), oracle_gram(mld, 0), num_coefs=cfg.num_coefs[0],
                          num_select=cfg.num_select)
    m_int = oracle.feature_map_int_from_events(l0, cfg.seq_len(1), cfg.counts[0])
    bank_q, step = spec.bank_quantize_int16(mld.augmented(1)[: cfg.counts[1]])
    want = oracle.int8_init_scores(m_int, bank_q, step, l0.scale).astype(np.float64)
    got = spec.level1_scores(l0.positions, l0.atoms, l0.codes, l0.scale, cfg, mld.augmented(1)[: cfg.counts[1]],
                             "cpu").numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


def oracle_gram(mld, level):
    from hsc_torch.dictionary import bank_gram

    return bank_gram(mld.augmented(level))


def test_replay_of_a_sound_encode_reads_near_zero_and_of_a_wrong_one_reads_large():
    from hsc_torch.oracle import mp as oracle

    cfg = inputs.codec_config({"codec": dict(committed("flat-flagship")["codec"], **TINY_FLAT)})
    mld = MultilevelDictionary.generate(cfg, seed=8)
    xs = inputs.signal_pool(mld, 2, {"rates": 0.002, "amplitude_range": [0.25, 2.0]}, 6, "cpu")
    bank = torch.as_tensor(mld.augmented(0), dtype=torch.float64)
    g = spec.gram(bank)
    w = torch.ones(cfg.counts[0], dtype=torch.float64)
    for x in xs:
        o = oracle.mp_encode(x[:, None], mld.augmented(0), oracle_gram(mld, 0), num_coefs=cfg.num_coefs[0],
                             num_select=cfg.num_select)
        sound = container.Stream(0, o.positions, o.atoms, o.codes, o.scale)
        r = spec.replay(spec.correlate(torch.as_tensor(x, dtype=torch.float64), bank), g, w, sound, cfg, 0)
        assert max(r["sel"], r["code"], r["skip"]) < 0.05 and r["unplaced"] == 0
        bad = container.Stream(0, o.positions, o.atoms, o.codes + (o.codes > 0) * 2 - 1, o.scale)
        r = spec.replay(spec.correlate(torch.as_tensor(x, dtype=torch.float64), bank), g, w, bad, cfg, 0)
        assert r["code"] > 0.4


# ---- imports -----------------------------------------------------------------


def test_the_harness_loads_no_jax():
    code = (
        "import sys, os, glob, importlib.util\n"
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
        "import run, calibrate\n"
        "from hscbench import inputs, traffic, judge, profile, layers, host\n"
        "from reference import spec, container, dictionary, config\n"
        f"for path in glob.glob(os.path.join({BENCH!r}, '*', '*.py')):\n"
        "    if os.path.basename(os.path.dirname(path)) not in ('clients', 'layer_metrics', 'roofline'): continue\n"
        "    spec_ = importlib.util.spec_from_file_location('m' + str(abs(hash(path))), path)\n"
        "    spec_.loader.exec_module(importlib.util.module_from_spec(spec_))\n"
        "import hsc_torch.runtime\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'hsc_tpu'}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_neither_the_program_nor_jax():
    for path in sorted(os.listdir(os.path.join(BENCH, "reference"))):
        if path.endswith(".py"):
            with open(os.path.join(BENCH, "reference", path)) as f:
                src = f.read()
            assert not re.search(r"^\s*(import|from)\s+(hsc_torch|hsc_tpu|jax|jaxlib|flax)\b", src, re.M), path


# ---- whole runs ----------------------------------------------------------------


def test_a_run_without_enough_cards_exits_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    rc = bench_run.main(["--workload", "flat-ingest", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_exits_and_prints_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "flat-ingest", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", ["fi", "hi", "fr"])
def test_a_sound_run_is_correct(tiny, cell):
    r = bench_run.execute(tiny, cell, 2**31 + 7, 0.6, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    names = {"fi": ["encode_mb_s"], "hi": ["encode_mb_s"], "fr": ["decode_mb_s"]}
    assert set(r["metrics"]) == set(names[cell]) | {"setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["host"]["work_before_ms"] > 0 and r["host"]["work_after_ms"] > 0


def test_a_traced_run_reads_its_per_layer_metrics(tiny):
    r = bench_run.execute(tiny, "fi", 11, 0.8, True, device="cpu")
    assert r["correct"]
    assert 0 <= r["metrics"]["host_pack_pct.encode"]["value"] <= 100


@pytest.mark.parametrize("cell", ["fi", "hi", "fr"])
def test_the_control_fails_the_committed_limits(tiny, cell):
    """The reference at the next precision below the configuration's
    (TF32 level-0 correlation for an encode, bfloat16 epilogue for the
    integer decode), put in the program's place, is not correct."""
    run = bench_run.Run(tiny, cell, 2**31 + 99, 0.4, False, device="cpu")
    try:
        run.client.setup()
        run.client.window(0.4, None)
        run.client.free()
        limits = run.config["limits"]
        sound = run.client.judge()
        assert all(v <= limits[k] for k, v in sound.items()), sound
        ctrl = run.client.judge(control=True)
        assert any(v > limits[k] for k, v in ctrl.items()), ctrl
    finally:
        if hasattr(run.client, "cleanup"):
            run.client.cleanup()
        run.close()


@pytest.mark.cuda
def test_the_controls_on_the_card(tiny):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the card's own conv, decode and kernels are not here")
    for cell in ("fi", "fr"):
        run = bench_run.Run(tiny, cell, 5, 0.4, False, device="cuda")
        try:
            run.client.setup()
            run.client.window(0.4, None)
            run.client.free()
            limits = run.config["limits"]
            assert all(v <= limits[k] for k, v in run.client.judge().items())
            assert any(v > limits[k] for k, v in run.client.judge(control=True).items())
        finally:
            if hasattr(run.client, "cleanup"):
                run.client.cleanup()
            run.close()
