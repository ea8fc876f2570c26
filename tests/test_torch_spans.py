"""The runtime's spans (`hsc_torch.utils.profiling.scope`) on the CPU.

Under `torch.profiler.profile`, `CorpusEncoder.encode` (flat, 2-level, and
on a mesh of CPU shards) records `hsc:encode.gather`, `.pipeline` and
`.assemble` once a call (gather and pipeline once a super-batch on a mesh)
and `hsc:encode.pack` once a batch; a `CorpusReader` slice records
`hsc:decode.unpack` once a chunk (and once for the pull that finds the
blocks spent), `.dispatch` and `.drain` once a decode unit, `.stack` once,
and, where a chunk is summed per level (a distributed container),
`.levelsum` once for its zeroing and once a decode unit, while
`runtime.ROWS_SUMMED_BY_LEVEL` grows by the units' blocks (by none on a
top-only slice).  The spans of a path never overlap.  Containers and rows
are the same bytes with and without a profiler, and without one no span
reaches `record_function`.
"""

import json

import numpy as np
import pytest
import torch

from hsc_torch import runtime
from hsc_torch.config import make_test_config
from hsc_torch.dictionary import MultilevelDictionary
from hsc_torch.io.bitstream import iter_blocks
from hsc_torch.parallel import make_mesh
from hsc_torch.runtime import CorpusEncoder, CorpusReader
from hsc_torch.signal import SignalGenerator
from hsc_torch.utils.profiling import scope

BATCH = 2
N_BLOCKS = 5

GEOMETRIES = {
    "flat": dict(),
    "hier": dict(counts=(12, 8), scales=(16, 48), num_coefs=(96, 48)),
}


def _mld(geometry):
    return MultilevelDictionary.generate(make_test_config(**GEOMETRIES[geometry]), seed=11)


def _corpus(mld):
    cfg = mld.config
    rates = 4e-3 if cfg.num_levels == 1 else [np.full(cfg.counts[0], 4e-3), np.full(cfg.counts[1], 1e-3)]
    return SignalGenerator(mld, rates=rates).generate_signals(N_BLOCKS, cfg.block_size, seed=3)


MESH_SPANS = {f"hsc:mesh.{s}" for s in ("upload", "init", "peaks", "loop", "handoff", "collect")}


def _traced(fn, tmp_path):
    """fn()'s result and its runtime spans (`hsc:encode.*`, `hsc:decode.*`)
    as (name, start, end), in order.  Every other `hsc:` span must be one
    of the parallel layer's `hsc:mesh.*`, inside an `hsc:encode.pipeline`."""
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
    runtime = [(name, lo, hi) for lo, hi, name in spans if name.startswith(("hsc:encode.", "hsc:decode."))]
    pipelines = [(lo, hi) for name, lo, hi in runtime if name == "hsc:encode.pipeline"]
    for lo, hi, name in spans:
        if name.startswith(("hsc:encode.", "hsc:decode.")):
            continue
        assert name in MESH_SPANS, f"unknown span {name}"
        assert any(p_lo <= lo and hi <= p_hi for p_lo, p_hi in pipelines), f"{name} outside the pipeline"
    return out, runtime


def _counts(spans) -> dict:
    out: dict[str, int] = {}
    for name, _, _ in spans:
        out[name] = out.get(name, 0) + 1
    return out


def _assert_disjoint(spans):
    for (a, _, a_hi), (b, b_lo, _) in zip(spans, spans[1:]):
        assert b_lo >= a_hi, f"{b} starts inside {a}"


@pytest.mark.parametrize("geometry,shards", [("flat", 0), ("hier", 0), ("flat", 2)])
def test_encode_records_its_spans(geometry, shards, tmp_path):
    mld = _mld(geometry)
    mesh = make_mesh({"data": shards}, devices=["cpu"] * shards) if shards else None
    codec = CorpusEncoder(mld, device="cpu", batch_size=BATCH, mesh=mesh)
    blocks = _corpus(mld)
    plain = codec.encode(blocks, index=True)
    blob, spans = _traced(lambda: codec.encode(blocks, index=True), tmp_path)
    assert blob == plain
    batches = -(-N_BLOCKS // BATCH)
    per_call = -(-N_BLOCKS // (BATCH * shards)) if shards else 1
    packs = per_call if shards else batches
    assert _counts(spans) == {
        "hsc:encode.gather": per_call,
        "hsc:encode.pipeline": per_call,
        "hsc:encode.pack": packs,
        "hsc:encode.assemble": 1,
    }
    _assert_disjoint(spans)
    assert spans[-1][0] == "hsc:encode.assemble"


@pytest.mark.parametrize("geometry,distributed", [("flat", False), ("hier", True)])
def test_reader_slice_records_its_spans(geometry, distributed, tmp_path):
    mld = _mld(geometry)
    blob = CorpusEncoder(mld, device="cpu", batch_size=BATCH, distributed=distributed).encode(
        _corpus(mld), index=True
    )
    path = tmp_path / "c.hsct"
    path.write_bytes(blob)
    lo, hi = 1, N_BLOCKS
    chunks = [list(iter_blocks(blob))[b : b + BATCH] for b in range(lo, hi, BATCH)]
    # one decode unit a level present in the chunk
    units = sum(len({lv for streams in chunk for lv, _ in streams}) for chunk in chunks)
    assert units > len(chunks) or not distributed
    # a chunk is summed per level unless each block holds one top stream
    top = mld.config.num_levels - 1
    summed = [c for c in chunks if not all([lv for lv, _ in s] == [top] for s in c)]
    assert len(summed) == len(chunks) if distributed else not summed
    summed_units = sum(len({lv for streams in c for lv, _ in streams}) for c in summed)
    with CorpusReader(str(path), mld, device="cpu", batch_size=BATCH) as reader:
        plain = reader[lo:hi]
        before = runtime.ROWS_SUMMED_BY_LEVEL
        rows, spans = _traced(lambda: reader[lo:hi], tmp_path)
        grew = runtime.ROWS_SUMMED_BY_LEVEL - before
    assert rows.tobytes() == plain.tobytes()
    want = {
        "hsc:decode.unpack": len(chunks) + 1,
        "hsc:decode.dispatch": units,
        "hsc:decode.drain": units,
        "hsc:decode.stack": 1,
    }
    if summed:
        want["hsc:decode.levelsum"] = len(summed) + summed_units
    assert _counts(spans) == want
    # each unit adds its blocks' rows: one a stream of a chunk summed per level
    assert grew == sum(len(streams) for c in summed for streams in c)
    _assert_disjoint(spans)
    # the join allocates its one output first; the drains fill it
    assert spans[0][0] == "hsc:decode.stack"


@pytest.mark.parametrize("geometry", ["flat", "hier"])
def test_without_a_profiler_no_span_calls_record_function(geometry, monkeypatch, tmp_path):
    mld = _mld(geometry)
    blocks = _corpus(mld)
    codec = CorpusEncoder(mld, device="cpu", batch_size=BATCH)
    blob = codec.encode(blocks, index=True)

    def forbidden(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    assert scope("hsc:test") is scope("hsc:other")
    assert codec.encode(blocks, index=True) == blob
    path = tmp_path / "c.hsct"
    path.write_bytes(blob)
    with CorpusReader(str(path), mld, device="cpu", batch_size=BATCH) as reader:
        assert reader[0:N_BLOCKS].shape == (N_BLOCKS, mld.config.block_size)
        assert codec.decode_blocks(blob, [3, 1]).shape == (2, mld.config.block_size)
