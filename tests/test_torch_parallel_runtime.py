"""The port's user surfaces with a mesh, against the port's local path and the
JAX package's mesh path on the CPU: `CorpusEncoder(mesh=)` and
`CorpusReader(mesh=)`, the learners and the trainer with a mesh, the CLI's
`--mesh`, and `DataParallelEncoder.encode_multihost` in a 2-process gloo
group.

Mirrors the mesh cases of tests/test_runtime.py, tests/test_learn.py and
tests/test_cli.py.  JAX runs on conftest's 8 virtual CPU devices, the port
on meshes of repeated CPU devices.  Containers and rows are held bitwise:
to the port's local path with its own init, and to JAX's
`CorpusEncoder(mesh=)` with JAX's level-0 init injected where the port's
data-parallel encoder and its local pipeline look it up.  Learning is held
as JAX's tests hold it: k-means dictionaries atom for atom (|cos| > 0.99),
the online step's loss to 1e-4 relative and its bank to 1e-5, and every
mesh run bitwise the same run to run."""

import multiprocessing
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsc_tpu import MultilevelDictionary as JaxMLD
from hsc_tpu import SignalGenerator, make_test_config
from hsc_tpu.learn import ConvolutionalDictionaryLearner as JaxLearner
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.parallel import make_mesh as jax_make_mesh
from hsc_tpu.runtime import CorpusEncoder as JaxCorpusEncoder
from hsc_tpu.utils.metrics import read_metrics

import hsc_torch.cli as port_cli
import hsc_torch.models.coder
import hsc_torch.ops.pipeline
from hsc_torch.learn import (
    ConvolutionalDictionaryLearner,
    MultilevelTrainer,
    OnlineConvolutionalDictionaryLearner,
)
from hsc_torch.params import dictionary_from_arrays
from hsc_torch.parallel import make_mesh
from hsc_torch.runtime import CorpusEncoder, CorpusReader


def _port(mld):
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


def _cpu_mesh(n, axis="data"):
    return make_mesh({axis: n}, devices=["cpu"] * n)


@pytest.fixture
def inject(monkeypatch):
    """JAX's level-0 init where the port's coder (the data-parallel encoder's
    and the level pipeline's init) and flat pipeline look up
    `encode_init_batched`."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    for module in (hsc_torch.models.coder, hsc_torch.ops.pipeline):
        monkeypatch.setattr(module, "encode_init_batched", init)


def _corpus(mld, n, seed):
    cfg = mld.config
    rates = 4e-3 if cfg.num_levels == 1 else [np.full(cfg.counts[0], 4e-3), np.full(cfg.counts[1], 1e-3)]
    return SignalGenerator(mld, rates=rates).generate_signals(n, cfg.block_size, seed=seed)


@pytest.mark.parametrize("which,options", [
    ("mld1", {}),
    ("mld2", {}),
    ("mld2", {"distributed": True}),
    ("mld1", {"target_bps": 0.5}),
    ("mld2", {"target_bps": 0.3, "rate_mode": "corpus", "distributed": True}),
])
def test_corpus_encoder_mesh_byte_identical(request, inject, monkeypatch, which, options):
    """10 blocks on an 8-shard mesh at batch_size 2 (one padded
    super-batch): the container equals JAX's `CorpusEncoder(mesh=)` and
    JAX's local encode (JAX's init injected), and with the port's own init
    the port's local `batch_size=4` encode; rows decode bitwise the local
    decoder's."""
    mld = request.getfixturevalue(which)
    xs = _corpus(mld, 10, 72)
    mesh = _cpu_mesh(8)
    got = CorpusEncoder(_port(mld), device="cpu", batch_size=2, mesh=mesh, **options).encode(xs)
    assert got == JaxCorpusEncoder(mld, backend="jax", batch_size=2, mesh=jax_make_mesh({"data": 8}),
                                   **options).encode(xs)
    assert got == JaxCorpusEncoder(mld, backend="jax", batch_size=4, **options).encode(xs)
    monkeypatch.undo()
    local = CorpusEncoder(_port(mld), device="cpu", batch_size=4, **options)
    sharded = CorpusEncoder(_port(mld), device="cpu", batch_size=2, mesh=mesh, **options)
    blob = sharded.encode(xs)
    assert blob == local.encode(xs)
    assert sharded.decode(blob).tobytes() == local.decode(blob).tobytes()


@pytest.mark.parametrize("mode", ["integer", "ordered"])
def test_corpus_decoder_mesh(mld1, mode):
    """Sharded decode (10 blocks on 8 shards, so the shards pad): `decode`,
    `decode_stream(indices=...)` and `decode_blocks` bitwise the local
    decoder and JAX's mesh decoder."""
    import dataclasses

    mld = JaxMLD(dataclasses.replace(mld1.config, decode_mode=mode), mld1.dicts)
    xs = _corpus(mld, 10, 73)
    local = CorpusEncoder(_port(mld), device="cpu", batch_size=4)
    blob = local.encode(xs)
    full = local.decode(blob)
    sharded = CorpusEncoder(_port(mld), device="cpu", batch_size=4, mesh=_cpu_mesh(8))
    assert sharded.decode(blob).tobytes() == full.tobytes()
    jax_rows = JaxCorpusEncoder(mld, backend="jax", batch_size=4, mesh=jax_make_mesh({"data": 8})).decode(blob)
    assert full.tobytes() == jax_rows.tobytes()
    rows = list(sharded.decode_stream(blob, indices=[9, 0, 5]))
    assert b"".join(r.tobytes() for r in rows) == full[[9, 0, 5]].tobytes()
    assert sharded.decode_blocks(blob, [3, 3, 8]).tobytes() == full[[3, 3, 8]].tobytes()


def test_corpus_decoder_mesh_distributed_container(mld2):
    """A distributed container (per-level device decodes) through the
    sharded decoder: bitwise the local path."""
    xs = _corpus(mld2, 7, 74)
    local = CorpusEncoder(_port(mld2), device="cpu", batch_size=2, distributed=True)
    blob = local.encode(xs)
    sharded = CorpusEncoder(_port(mld2), device="cpu", batch_size=2, mesh=_cpu_mesh(8))
    assert sharded.decode(blob).tobytes() == local.decode(blob).tobytes()


def test_mesh_journal_metrics_and_reader(tmp_path, mld1, monkeypatch):
    """Under a mesh: the journal resumes with the same bytes and no encode
    work, metrics records carry ``shards``, and `CorpusReader(mesh=)` serves
    the local decoder's rows."""
    xs = _corpus(mld1, 9, 75)
    mesh = _cpu_mesh(4)
    jdir, metrics = str(tmp_path / "j"), str(tmp_path / "m.jsonl")
    first = CorpusEncoder(_port(mld1), device="cpu", batch_size=2, mesh=mesh, journal_dir=jdir,
                          metrics_path=metrics)
    blob = first.encode(xs, index=True)
    recs = read_metrics(metrics)
    assert [r["blocks"] for r in recs] == [8, 1] and all(r["shards"] == 4 for r in recs)
    resumed = CorpusEncoder(_port(mld1), device="cpu", batch_size=2, mesh=mesh, journal_dir=jdir)

    def no_work(*a, **k):
        raise AssertionError("a journal resume encoded a block")

    monkeypatch.setattr(resumed.dp, "encode", no_work)
    assert resumed.encode(xs, index=True) == blob
    path = tmp_path / "c.hsct"
    path.write_bytes(blob)
    rows = CorpusEncoder(_port(mld1), device="cpu").decode(blob)
    with CorpusReader(str(path), _port(mld1), device="cpu", batch_size=3, mesh=mesh) as reader:
        assert reader.codec.dp_dec is not None
        assert np.stack(list(reader.rows())).tobytes() == rows.tobytes()
        assert reader[7].tobytes() == rows[7].tobytes()


def _learn_corpus():
    cfg = make_test_config(counts=(6,), scales=(12,), num_coefs=(16,), block_size=512)
    mld = JaxMLD.generate(cfg, seed=5)
    return SignalGenerator(mld, rates=2e-2).generate_signals(8, 512, seed=6)


def _atoms_match(a, b, k):
    """Every atom of `a` has a counterpart in `b` with |cos| > 0.99."""
    sims = np.abs(a.reshape(k, -1) @ b.reshape(k, -1).T)
    return float(np.min(np.max(sims, axis=1))) > 0.99


def test_learner_with_mesh():
    """Mesh k-means training (8 shards; 510 windows, so the learner pads to
    the shard count): atom for atom the local learner's and JAX's mesh
    learner's (tests/test_parallel.py's bound), and bitwise run to run."""
    xs = _learn_corpus()

    def learn(mesh):
        learner = ConvolutionalDictionaryLearner(6, 12, 1, num_windows=510, iterations=8, seed=0, device="cpu")
        return learner.train(xs, mesh=mesh), learner.objective_history

    mesh = _cpu_mesh(8)
    sharded, objs = learn(mesh)
    again, objs2 = learn(mesh)
    assert sharded.tobytes() == again.tobytes() and objs == objs2 and len(objs) == 8
    local, _ = learn(None)
    assert _atoms_match(local, sharded, 6)
    ref = JaxLearner(6, 12, 1, num_windows=510, iterations=8, seed=0).train(xs, mesh=jax_make_mesh({"data": 8}))
    assert _atoms_match(np.asarray(ref), sharded, 6)


def test_trainer_with_mesh(mld2):
    """`MultilevelTrainer(mesh=)`: each level's k-means sharded; the levels
    atom for atom the local trainer's, bitwise run to run."""
    port = _port(mld2)
    xs = _corpus(mld2, 4, 76)

    def train(mesh):
        return MultilevelTrainer(port.config, num_windows=256, iterations=4, seed=0, mesh=mesh,
                                 device="cpu").train(xs)

    mesh = _cpu_mesh(4)
    a, b, local = train(mesh), train(mesh), train(None)
    for da, db, dl in zip(a.dicts, b.dicts, local.dicts):
        assert da.tobytes() == db.tobytes()
        assert _atoms_match(dl, da, da.shape[0])


def test_online_learner_with_mesh():
    """Sharded online step (8 shards): loss within 1e-4 relative and bank
    within 1e-5 of the local step (tests/test_learn.py's bounds), bitwise
    run to run; a minibatch that does not divide the axis raises."""
    cfg = make_test_config(counts=(6,), scales=(12,), num_coefs=(16,), block_size=256)
    mld = JaxMLD.generate(cfg, seed=5)
    xs = SignalGenerator(mld, rates=2e-2).generate_signals(8, 256, seed=4)
    bank0 = mld.dicts[0]
    mesh = _cpu_mesh(8)

    def learner(m):
        return OnlineConvolutionalDictionaryLearner(bank0, num_coefs=16, learning_rate=1e-2, mesh=m, device="cpu")

    a, b, c = learner(None), learner(mesh), learner(mesh)
    for _ in range(2):
        la, lb, lc = a.step(xs), b.step(xs), c.step(xs)
        assert abs(la - lb) < 1e-4 * max(1.0, abs(la))
        np.testing.assert_allclose(a.bank.detach().numpy(), b.bank.detach().numpy(), atol=1e-5)
        assert lb == lc and torch.equal(b.bank, c.bank)
    with pytest.raises(ValueError, match="must divide"):
        b.step(xs[:6])


def test_cli_mesh_round_trip(mld1, tmp_path, capsys):
    """`--mesh 8 --device cpu`: the container and the decoded rows are
    byte-identical to the CLI's encode and decode with no mesh."""
    mld1.save(str(tmp_path / "d.npz"))
    x = _corpus(mld1, 5, 77)
    np.save(tmp_path / "sig.npy", x.reshape(-1))
    common = ["--dict", str(tmp_path / "d.npz"), "--device", "cpu", "--batch-size", "2"]
    for tag, extra in (("", []), ("m", ["--mesh", "8"])):
        port_cli.main(["encode", "--input", str(tmp_path / "sig.npy"), "--output", str(tmp_path / f"c{tag}.hsct"),
                       *common, *extra])
        port_cli.main(["decode", "--input", str(tmp_path / "c.hsct"), "--output", str(tmp_path / f"r{tag}.npy"),
                       *common, *extra])
    assert (tmp_path / "cm.hsct").read_bytes() == (tmp_path / "c.hsct").read_bytes()
    assert np.load(tmp_path / "rm.npy").tobytes() == np.load(tmp_path / "r.npy").tobytes()


def _gloo_worker(rank, port, cfg_json, dicts, xs, out):
    """One process of `test_dp_encode_multihost_in_a_gloo_group`."""
    import torch.distributed as dist

    from hsc_torch.models import ConvolutionalSparseCoder
    from hsc_torch.parallel import DataParallelEncoder, initialize_distributed, make_mesh

    initialize_distributed(f"localhost:{port}", 2, rank)
    try:
        mld = dictionary_from_arrays(cfg_json, dicts)
        dp = DataParallelEncoder(make_mesh({"data": 2}, devices=["cpu"] * 2),
                                 ConvolutionalSparseCoder(mld, device="cpu").mp)
        lo, hi = dp.multihost_split(xs.shape[0], dist.get_world_size())[rank]
        enc = dp.encode_multihost(xs[lo:hi], xs.shape[0])
        if rank == 1:
            np.savez(out, *enc)
    finally:
        dist.destroy_process_group()


def test_dp_encode_multihost_in_a_gloo_group(tmp_path, mld1):
    """Two processes joined by `initialize_distributed` (gloo), each with a
    2-shard CPU mesh and a ragged share of 5 blocks: every field gathered
    by `encode_multihost` equals the single-process `encode`."""
    from hsc_torch.models import ConvolutionalSparseCoder
    from hsc_torch.parallel import DataParallelEncoder

    xs = _corpus(mld1, 5, 49)
    ref = DataParallelEncoder(_cpu_mesh(2), ConvolutionalSparseCoder(_port(mld1), device="cpu").mp).encode(xs)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path / "enc.npz")
    args = (port, mld1.config.to_json(), [np.asarray(d) for d in mld1.dicts], xs, out)
    procs = [ctx.Process(target=_gloo_worker, args=(rank, *args)) for rank in (0, 1)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    with np.load(out) as z:
        got = [z[f"arr_{i}"] for i in range(len(ref))]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.tobytes() == r.tobytes()
