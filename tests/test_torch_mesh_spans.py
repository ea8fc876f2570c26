"""The parallel layer's spans and shard counter (`hsc_torch/parallel/dp.py`)
on the CPU, on a 4-shard `data` mesh of CPU devices.

A ragged corpus (2 super-batches and 3 blocks, so the last super-batch
pads) goes through `CorpusEncoder(mesh=)`.  Under `torch.profiler.profile`
each `hsc:mesh.*` span is entered once a super-batch (init, peaks and loop
once a level, the hand-off once a level boundary), the spans never
overlap, and all lie inside `hsc:encode.pipeline`.  `SHARD_BATCHES` grows
by the super-batch count on every shard; containers are the same bytes
with and without a profiler; and every block of the mesh's container,
the padded tail included, replays against the benchmark's plain reference
(`benchmark/reference/spec.py`, through `hscbench.judge.EncodeJudge`).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from hsc_torch.params import dictionary_from_arrays
from hsc_torch.parallel import dp, make_mesh
from hsc_torch.runtime import CorpusEncoder

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from hscbench import inputs, judge  # noqa: E402
from reference.dictionary import MultilevelDictionary  # noqa: E402

SHARDS = 4
BATCH = 2
SUPER = BATCH * SHARDS
N_BLOCKS = 2 * SUPER + 3
SUPER_BATCHES = -(-N_BLOCKS // SUPER)
STAGES = ("upload", "init", "peaks", "loop", "collect")
SIGNALS = {"rates": 0.002, "amplitude_range": [0.25, 2.0]}

GEOMETRIES = {
    "flat": dict(counts=[8], scales=[16], num_coefs=[64], hier_init="auto"),
    "hier": dict(counts=[8, 4], scales=[16, 48], num_coefs=[48, 24], hier_init="int8"),
}


def _setup(geometry):
    """(the reference's dictionary, the mesh's codec, the corpus)."""
    codec = dict(
        GEOMETRIES[geometry], block_size=2048, tolerance_snr=None, singleton_weight=0.9, amp_bits=16,
        num_select=4, entropy="fixed", decode_mode="integer", rep_bits=12,
    )
    cfg = inputs.codec_config({"codec": codec})
    ref = MultilevelDictionary.generate(cfg, seed=13)
    port = dictionary_from_arrays(cfg.to_json(), ref.dicts)
    mesh = make_mesh({"data": SHARDS}, devices=["cpu"] * SHARDS)
    enc = CorpusEncoder(port, device="cpu", batch_size=BATCH, mesh=mesh)
    return ref, enc, inputs.signal_pool(ref, N_BLOCKS, SIGNALS, 29, "cpu")


def _traced(fn, tmp_path):
    """fn()'s result and its `hsc:` spans as (name, start, end), in order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("hsc:")
    )
    return out, [(name, lo, hi) for lo, hi, name in spans]


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_mesh_spans_once_a_super_batch_disjoint_inside_the_pipeline(geometry, tmp_path):
    _, enc, blocks = _setup(geometry)
    levels = len(GEOMETRIES[geometry]["counts"])
    plain = enc.encode(blocks, index=True)
    blob, spans = _traced(lambda: enc.encode(blocks, index=True), tmp_path)
    assert blob == plain
    mesh = [s for s in spans if s[0].startswith("hsc:mesh.")]
    counts: dict[str, int] = {}
    for name, _, _ in mesh:
        counts[name] = counts.get(name, 0) + 1
    per_level = {"init", "peaks", "loop"}
    want = {f"hsc:mesh.{s}": SUPER_BATCHES * (levels if s in per_level else 1) for s in STAGES}
    if levels > 1:
        want["hsc:mesh.handoff"] = SUPER_BATCHES * (levels - 1)
    assert counts == want
    for (a, _, a_hi), (b, b_lo, _) in zip(mesh, mesh[1:]):
        assert b_lo >= a_hi, f"{b} starts inside {a}"
    pipelines = [(lo, hi) for name, lo, hi in spans if name == "hsc:encode.pipeline"]
    assert len(pipelines) == SUPER_BATCHES
    for name, lo, hi in mesh:
        assert any(p_lo <= lo and hi <= p_hi for p_lo, p_hi in pipelines), name
    # each super-batch's stages in their order
    order = [name.split(".")[-1] for name, _, _ in mesh]
    one = ["upload"] + ["init", "peaks", "loop", "handoff"] * (levels - 1) + ["init", "peaks", "loop", "collect"]
    assert order == one * SUPER_BATCHES


def test_shard_batches_grow_by_the_super_batch_count_on_every_shard():
    _, enc, blocks = _setup("flat")
    before = dict(dp.SHARD_BATCHES)
    enc.encode(blocks, index=True)
    grown = {i: dp.SHARD_BATCHES[i] - before.get(i, 0) for i in range(SHARDS)}
    assert grown == {i: SUPER_BATCHES for i in range(SHARDS)}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_mesh_containers_are_the_same_bytes_without_a_profiler(geometry, monkeypatch, tmp_path):
    """Traced, plain, and with `record_function` forbidden: no mesh span
    reaches it while no profiler runs."""
    _, enc, blocks = _setup(geometry)
    traced, _ = _traced(lambda: enc.encode(blocks, index=True), tmp_path)

    def forbidden(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    assert enc.encode(blocks, index=True) == traced


def test_every_mesh_block_replays_against_the_reference():
    ref, enc, blocks = _setup("flat")
    blob = enc.encode(blocks, index=True)
    cfg = ref.config
    assert not judge.container_faults(cfg, blob, N_BLOCKS)
    every = list(range(N_BLOCKS))
    r = judge.EncodeJudge(ref, "cpu").judge(list(blocks), judge.top_streams(cfg, blob, every))
    # the flat flagship cell's limits: the float32 port against the float64
    # replay reads a rounding's fraction of a step, a wrong decision >= 0.5
    with open(os.path.join(BENCH, "configs", "flat-flagship.json")) as f:
        limits = json.load(f)["limits"]
    assert r["unplaced_events"] == 0
    assert r["gap_steps_l0"] <= limits["gap_steps_l0"] and r["scale_gap_rel"] <= limits["scale_gap_rel"]
    # the tail's blocks are the corpus's, not the pad's
    assert np.abs(blocks[-3:]).max() > 0


def test_upload_shard_on_the_cpu_is_the_shard_itself():
    a = np.arange(2 * 6 * 1, dtype=np.float32).reshape(2, 6, 1)
    t = dp.upload_shard(a[::-1], torch.device("cpu"))
    assert t.device.type == "cpu" and t.is_contiguous()
    assert np.array_equal(t.numpy(), a[::-1])


@pytest.mark.cuda
def test_upload_shard_stages_in_pinned_memory_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned staging runs only there")
    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 16384, 1)).astype(np.float32)
    dev = torch.device("cuda", 0)
    # the host array is overwritten at once: the upload must not read it late
    outs = []
    for i in range(4):
        outs.append(dp.upload_shard(a[i * 16 : (i + 1) * 16], dev))
    a_copy = a.copy()
    a[:] = 0
    torch.cuda.synchronize(dev)
    for i, t in enumerate(outs):
        assert t.device == dev and t.dtype == torch.float32
        assert np.array_equal(t.cpu().numpy(), a_copy[i * 16 : (i + 1) * 16])
