"""The port's resumable encode against the JAX package on the CPU: the block
journal (`journal_dir`), the metrics records (`metrics_path`), per-process
shards (`encode_shard`, `encode_multihost`, `multihost_split`) and their
assembly (`assemble_container`).

Mirrors the journal and multi-host cases of tests/test_runtime.py.  With
JAX's level-0 init injected, every container equals the JAX package's
single-process encode byte for byte; a resume returns the same bytes and
runs no device work; a journal written by either package resumes in the
other.  The last test runs `encode_multihost` in two processes joined by a
`torch.distributed` gloo group (its barrier before assembly)."""

import multiprocessing
import os
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsc_tpu import SignalGenerator
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.parallel.dp import DataParallelEncoder
from hsc_tpu.runtime import CorpusEncoder as JaxCorpusEncoder
from hsc_tpu.runtime import journal_fingerprint as jax_fingerprint
from hsc_tpu.runtime import parse_journal_fingerprint as jax_parse_fingerprint
from hsc_tpu.utils.metrics import read_metrics

import hsc_torch.ops.pipeline
import hsc_torch.runtime
from hsc_torch.params import dictionary_from_arrays
from hsc_torch.runtime import (
    CorpusEncoder,
    _journal_name,
    assemble_container,
    journal_fingerprint,
    multihost_split,
    parse_journal_fingerprint,
    parse_journal_name,
)


def _port(mld):
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


@pytest.fixture
def inject(monkeypatch):
    """JAX's init where the port's pipeline looks up `encode_init_batched`."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(hsc_torch.ops.pipeline, "encode_init_batched", init)


def _corpus(mld, n, seed):
    return SignalGenerator(mld, rates=4e-3).generate_signals(n, mld.config.block_size, seed=seed)


def _no_device_work(monkeypatch):
    """Make every encode pipeline of the runtime raise if it is entered."""
    def refuse(*args, **kwargs):
        raise AssertionError("the resume ran device work")

    for name in ("encode_batches_pipelined", "encode_hierarchical_batches_pipelined"):
        monkeypatch.setattr(hsc_torch.runtime, name, refuse)


@pytest.mark.parametrize("which", ["mld1", "mld2"])
def test_resume_identical_bytes_without_device_work(tmp_path, monkeypatch, inject, request, which):
    """One and two levels: the journaled encode equals JAX's container; a
    resume into the same directory (index footer included) returns the same
    bytes and enters no encode pipeline; a half-finished journal is
    completed."""
    mld = request.getfixturevalue(which)
    xs = _corpus(mld, 5, 41)
    ref = JaxCorpusEncoder(mld, backend="jax", batch_size=2).encode(xs)
    jdir = str(tmp_path / "j")
    CorpusEncoder(_port(mld), device="cpu", batch_size=2, journal_dir=jdir).encode_shard(xs[:3])
    blob = CorpusEncoder(_port(mld), device="cpu", batch_size=2, journal_dir=jdir).encode(xs)
    assert blob == ref
    _no_device_work(monkeypatch)
    again = CorpusEncoder(_port(mld), device="cpu", batch_size=2, journal_dir=jdir)
    assert again.encode(xs) == blob
    assert again.encode(xs, index=True) == JaxCorpusEncoder(mld, backend="jax").encode(xs, index=True)


def test_journal_resumes_across_packages(tmp_path, monkeypatch, inject, mld1):
    """A journal written by the JAX package (same fingerprint) resumes in the
    port with no device work, and the port's journal assembles in JAX."""
    from hsc_tpu.runtime import assemble_container as jax_assemble

    xs = _corpus(mld1, 4, 43)
    j_jax, j_port = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = JaxCorpusEncoder(mld1, backend="jax", batch_size=2, journal_dir=j_jax, target_bps=0.5).encode(xs)
    CorpusEncoder(_port(mld1), device="cpu", batch_size=2, journal_dir=j_port, target_bps=0.5).encode(xs)
    assert jax_assemble(mld1.config, j_port, 4, 1, target_bps=0.5) == ref
    _no_device_work(monkeypatch)
    assert CorpusEncoder(_port(mld1), device="cpu", journal_dir=j_jax, target_bps=0.5).encode(xs) == ref


def test_journal_refuses_other_settings(tmp_path, mld1):
    xs = _corpus(mld1, 2, 45)
    jdir = str(tmp_path / "j")
    CorpusEncoder(_port(mld1), device="cpu", journal_dir=jdir, target_bps=0.5).encode(xs)
    for kw in (dict(target_bps=0.8), dict(target_bps=0.5, rate_mode="corpus"), dict(distributed=True)):
        with pytest.raises(ValueError, match="different codec config"):
            CorpusEncoder(_port(mld1), device="cpu", journal_dir=jdir, **kw)
    with pytest.raises(ValueError, match="journal_dir"):
        CorpusEncoder(_port(mld1), device="cpu").encode_shard(xs)


def test_multihost_split_matches_jax():
    for n_global in (0, 1, 3, 10, 13, 17):
        for n_proc in (1, 2, 3, 4, 8, 16):
            split = multihost_split(n_global, n_proc)
            assert split == DataParallelEncoder.multihost_split(n_global, n_proc)
            assert all(lo <= hi for lo, hi in split) and sum(hi - lo for lo, hi in split) == n_global
    assert multihost_split(13, 4) == [(0, 4), (4, 8), (8, 12), (12, 13)]


def test_multihost_two_process_assembly(tmp_path, inject, mld1):
    """Two simulated processes (explicit `n_processes`, ragged split 4/3),
    process 1 first: process 0's assembly equals JAX's single-process
    container; a wrong shard size and a missing shard are refused."""
    xs = _corpus(mld1, 7, 77)
    ref = JaxCorpusEncoder(mld1, backend="jax", batch_size=4).encode(xs)
    jdir = str(tmp_path / "mh")
    p0, p1 = (CorpusEncoder(_port(mld1), device="cpu", batch_size=4, journal_dir=jdir, process_index=p)
              for p in (0, 1))
    assert p1.encode_multihost(xs[4:7], 7, n_processes=2) is None
    assert p0.encode_multihost(xs[0:4], 7, n_processes=2) == ref
    with pytest.raises(ValueError, match="must pass blocks"):
        p0.encode_multihost(xs[0:3], 7, n_processes=2)
    jdir2 = str(tmp_path / "mh2")
    CorpusEncoder(_port(mld1), device="cpu", journal_dir=jdir2, process_index=1).encode_shard(xs[4:7], global_start=4)
    with pytest.raises(ValueError, match="not yet encoded"):
        assemble_container(mld1.config, jdir2, 7, 2)
    # one process with process_index 0 is a plain encode
    assert CorpusEncoder(_port(mld1), device="cpu", batch_size=4).encode_multihost(xs, 7) == ref


@pytest.mark.parametrize("rate_mode", [None, "block", "corpus"])
def test_multihost_four_process_resume(tmp_path, inject, mld2, rate_mode):
    """Four simulated processes over 13 blocks of the 2-level hierarchy
    (shards 4/4/4/1), process 2 interrupted after 2 blocks and resumed:
    `assemble_container` (with the seek index) equals JAX's single-process
    encode, plain and under each rate mode."""
    kw = {} if rate_mode is None else dict(target_bps=1.0, rate_mode=rate_mode)
    xs = _corpus(mld2, 13, 79)
    ref = JaxCorpusEncoder(mld2, backend="jax", batch_size=4, **kw).encode(xs, index=True)
    jdir = str(tmp_path / "mh4")
    split = multihost_split(13, 4)
    for p, (lo, hi) in enumerate(split):
        enc = CorpusEncoder(_port(mld2), device="cpu", batch_size=4, journal_dir=jdir, process_index=p, **kw)
        enc.encode_shard(xs[lo : lo + 2] if p == 2 else xs[lo:hi], global_start=lo)
    with pytest.raises(ValueError, match="not yet encoded"):
        assemble_container(mld2.config, jdir, 13, 4, **kw)
    CorpusEncoder(_port(mld2), device="cpu", batch_size=4, journal_dir=jdir, process_index=2, **kw).encode_shard(
        xs[8:12], global_start=8)
    assert assemble_container(mld2.config, jdir, 13, 4, index=True, **kw) == ref
    # an absent journal file is skipped, not created
    with pytest.raises(ValueError, match="not yet encoded"):
        assemble_container(mld2.config, jdir, 15, 5, **kw)
    assert not os.path.exists(os.path.join(jdir, f"{_journal_name(4)}.journal"))


def test_journal_fingerprint_and_names_match_jax(mld1):
    cfg = mld1.config
    for distributed in (False, True):
        for bps in (None, 0.5, 1, 1.0):
            for mode in ("block", "corpus"):
                fp = journal_fingerprint(cfg, distributed, bps, mode)
                assert fp == jax_fingerprint(cfg, distributed, bps, mode)
                assert parse_journal_fingerprint(fp) == jax_parse_fingerprint(fp)
    for fake in ('{"note":"x:cbr=2.0"}', '{"note":":distributed"}:distributed:cbrc=0.25'):
        assert parse_journal_fingerprint(fake) == jax_parse_fingerprint(fake)
    for p in (0, 1, 7, 23):
        assert parse_journal_name(_journal_name(p)) == p
    assert parse_journal_name("corpus.pX") is None and parse_journal_name("other") is None


def test_metrics_records(tmp_path, mld1):
    """`metrics_path` gets the JAX package's records, key for key: one per
    encode, one for the corpus allocation, one per decode."""
    xs = _corpus(mld1, 3, 47)
    paths = [str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")]
    port = CorpusEncoder(_port(mld1), device="cpu", metrics_path=paths[0], target_bps=0.5, rate_mode="corpus")
    jax_enc = JaxCorpusEncoder(mld1, backend="jax", metrics_path=paths[1], target_bps=0.5, rate_mode="corpus")
    for codec in (port, jax_enc):
        codec.decode(codec.encode(xs))
    got, want = (read_metrics(p) for p in paths)
    assert [(r["kind"], sorted(r)) for r in got] == [(r["kind"], sorted(r)) for r in want]
    assert got[0]["blocks"] == 3 and got[0]["events"] == want[0]["events"]
    assert got[1]["budget_bytes"] == want[1]["budget_bytes"]
    # a process other than 0 writes nothing
    CorpusEncoder(_port(mld1), device="cpu", metrics_path=str(tmp_path / "p1.jsonl"), process_index=1).encode(xs)
    assert not os.path.exists(tmp_path / "p1.jsonl")


def _gloo_worker(rank, port, jdir, cfg_json, dicts, xs, out):
    """One process of `test_encode_multihost_in_a_gloo_group`."""
    import torch.distributed as dist

    from hsc_torch.params import dictionary_from_arrays
    from hsc_torch.runtime import CorpusEncoder, multihost_split

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
    try:
        mld = dictionary_from_arrays(cfg_json, dicts)
        lo, hi = multihost_split(xs.shape[0], dist.get_world_size())[rank]
        codec = CorpusEncoder(mld, device="cpu", batch_size=2, journal_dir=jdir, process_index=rank)
        blob = codec.encode_multihost(xs[lo:hi], xs.shape[0])
        if rank == 0:
            with open(out, "wb") as f:
                f.write(blob)
        else:
            assert blob is None
    finally:
        dist.destroy_process_group()


def test_encode_multihost_in_a_gloo_group(tmp_path, mld1):
    """Two processes in a `torch.distributed` gloo group: `n_processes`
    defaults to the world size, each encodes its shard, both pass the
    barrier, and process 0's container equals the port's single-process
    encode."""
    xs = _corpus(mld1, 5, 49)
    ref = CorpusEncoder(_port(mld1), device="cpu", batch_size=2).encode(xs)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path / "c.hsct")
    args = (port, str(tmp_path / "j"), mld1.config.to_json(), [np.asarray(d) for d in mld1.dicts], xs, out)
    procs = [ctx.Process(target=_gloo_worker, args=(rank, *args)) for rank in (0, 1)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    with open(out, "rb") as f:
        assert f.read() == ref
