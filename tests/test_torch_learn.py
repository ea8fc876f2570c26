"""The port's dictionary learning (`hsc_torch.learn`) against the JAX package
on the CPU: window extraction, k-means, the multilevel trainer and its
resume journal, the online learner, and checkpoints.

Mirrors tests/test_learn.py and tests/test_checkpoint.py.  Tolerances:
  * `extract_windows`, the 'samples' learner and the 'samples' trainer are
    host NumPy (and, for the trainer's level encodes, the greedy loop given
    JAX's level-0 init): bitwise JAX's;
  * k-means products are float32 sums in another order than XLA's: sums and
    centroids to 1e-5, objectives to 1e-5 relative, assignments (counts)
    exact on well-separated data;
  * the online step (JAX's init injected, so the events are JAX's): the
    loss to 1e-5 relative and the bank to 1e-5 — the ordered decode rounds
    each product where XLA may fuse a multiply-add, and torch's Adam rounds
    otherwise than optax's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsc_tpu import MultilevelDictionary as JaxMLD
from hsc_tpu import SignalGenerator as JaxSignalGenerator
from hsc_tpu import make_test_config as jax_make_test_config
from hsc_tpu.learn import ConvolutionalDictionaryLearner as JaxLearner
from hsc_tpu.learn import MultilevelTrainer as JaxTrainer
from hsc_tpu.learn import extract_windows as jax_extract_windows
from hsc_tpu.learn.kmeans import kmeans_assign_update as jax_assign_update
from hsc_tpu.learn.kmeans import kmeans_refine_device as jax_refine
from hsc_tpu.learn.online import OnlineConvolutionalDictionaryLearner as JaxOnline
from hsc_tpu.ops.encode import encode_init_batched as jax_init

import hsc_torch.models.coder
from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
from hsc_torch.learn import (
    ConvolutionalDictionaryLearner,
    DictionaryCheckpointer,
    MultilevelTrainer,
    OnlineConvolutionalDictionaryLearner,
    extract_windows,
    kmeans_assign_update,
    kmeans_refine_device,
)
from hsc_torch.learn.online import _OverlapAdd
from hsc_torch.ops.decode import mp_decode_batch_torch
from hsc_torch.params import dictionary_from_arrays


def _port(mld):
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


@pytest.fixture
def inject(monkeypatch):
    """JAX's level-0 init where the port's coder looks up
    `encode_init_batched` (the trainer's and the online learner's encodes)."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(hsc_torch.models.coder, "encode_init_batched", init)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("mode", ["random", "energy"])
@pytest.mark.parametrize("channels", [1, 3])
def test_extract_windows_bitwise_jax(mld1, mode, channels):
    xs = JaxSignalGenerator(mld1, rates=5e-3).generate_signals(4, 512, seed=0)
    if channels > 1:
        xs = np.stack([xs, 0.5 * xs, -xs], axis=2)
    got = extract_windows(xs, 16, 64, mode=mode, seed=1)
    assert got.shape == (64, 16, channels) and got.dtype == np.float32
    assert _same(got, jax_extract_windows(xs, 16, 64, mode=mode, seed=1))
    assert _same(extract_windows(xs, 16, 32, mode=mode, seed=5), extract_windows(xs, 16, 32, mode=mode, seed=5))
    with pytest.raises(ValueError):
        extract_windows(xs, 16, 8, mode="peaks")


def test_samples_learner_bitwise_jax():
    cfg = jax_make_test_config(counts=(6,), scales=(12,), num_coefs=(16,), block_size=256)
    xs = JaxSignalGenerator(JaxMLD.generate(cfg, seed=1), rates=2e-2).generate_signals(8, 256, seed=2)
    got = ConvolutionalDictionaryLearner(6, 12, 1, algorithm="samples", num_windows=256, seed=0,
                                         device="cpu").train(xs)
    want = JaxLearner(6, 12, 1, algorithm="samples", num_windows=256, seed=0).train(xs)
    assert got.shape == (6, 12, 1) and _same(got, want)
    np.testing.assert_allclose(np.linalg.norm(got.reshape(6, -1), axis=1), 1.0, atol=1e-5)


def test_kmeans_assign_update_vs_jax():
    """Windows planted around 8 unit centroids with either sign: the same
    assignment counts as JAX, sums to 1e-5."""
    rng = np.random.default_rng(3)
    cents = rng.standard_normal((8, 24)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    labels = rng.integers(0, 7, 500)  # centroid 7 stays empty
    signs = rng.choice([-1.0, 1.0], 500).astype(np.float32)
    flat = (signs[:, None] * cents[labels] * rng.uniform(0.5, 2.0, (500, 1))
            + 0.01 * rng.standard_normal((500, 24))).astype(np.float32)
    got = kmeans_assign_update(torch.from_numpy(flat), torch.from_numpy(cents))
    want = jax_assign_update(jnp.asarray(flat), jnp.asarray(cents))
    assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert np.array_equal(got.counts.numpy(), np.bincount(labels, minlength=8).astype(np.float32))
    np.testing.assert_allclose(got.sums.numpy(), np.asarray(want.sums), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.best_abs.numpy(), np.asarray(want.best_abs), rtol=1e-6)
    np.testing.assert_allclose(float(got.objective), float(want.objective), rtol=1e-6)


def test_kmeans_refine_device_vs_jax():
    """The fixture of tests/test_learn.py's device-vs-host test (a silent
    window that must never reseed, a centroid that dies at once): JAX's
    centroids to 1e-5, its objectives to 1e-5 relative."""
    rng = np.random.default_rng(4)
    flat = rng.standard_normal((256, 16)).astype(np.float32)
    flat[17] = 0
    cents0 = rng.standard_normal((6, 16)).astype(np.float32)
    cents0 /= np.linalg.norm(cents0, axis=1, keepdims=True)
    cents0[3] = 0
    got_c, got_o = kmeans_refine_device(torch.from_numpy(flat), torch.from_numpy(cents0), iterations=7)
    want_c, want_o = jax_refine(jnp.asarray(flat), jnp.asarray(cents0), iterations=7)
    assert got_o.shape == (7,)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-5)
    assert not np.allclose(got_c.numpy()[3], 0)  # the dead slot was reseeded
    np.testing.assert_allclose(np.linalg.norm(got_c.numpy(), axis=1), 1.0, atol=1e-5)


def test_kmeans_recovers_planted_atoms():
    """Signals built from a known dictionary: learned atoms must correlate
    strongly with the truth, and the objective never falls."""
    cfg = make_test_config(counts=(8,), scales=(12,), num_coefs=(32,), block_size=512)
    mld = MultilevelDictionary.generate(cfg, seed=3)
    xs = SignalGenerator(mld, rates=2e-2, amplitude_range=(0.8, 1.2)).generate_signals(32, 512, seed=9)
    learner = ConvolutionalDictionaryLearner(8, 12, 1, algorithm="kmean", num_windows=2048, iterations=25,
                                             seed=0, device="cpu")
    learned = learner.train(xs)
    assert learned.shape == (8, 12, 1)
    np.testing.assert_allclose(np.linalg.norm(learned.reshape(8, -1), axis=1), 1.0, atol=1e-5)
    hist = learner.objective_history
    assert len(hist) == 25 and all(b >= a - 1e-3 for a, b in zip(hist, hist[1:]))
    true = mld.dicts[0][:, :, 0]
    matched = 0
    for i in range(8):
        best = max(np.max(np.abs(np.correlate(true[i], learned[j, :, 0], mode="full"))) for j in range(8))
        matched += best > 0.75
    assert matched >= 6, f"only {matched}/8 atoms recovered"


def test_dead_atom_reset():
    """A centroid orthogonal to all data gets reseeded from data windows."""
    rng = np.random.default_rng(0)
    flat = np.zeros((64, 8), np.float32)
    flat[:, :4] = rng.standard_normal((64, 4)).astype(np.float32)
    learner = ConvolutionalDictionaryLearner(4, 8, 1, algorithm="kmean", num_windows=64, iterations=5,
                                             extraction="random", seed=0, device="cpu")
    learned = learner.train(flat.reshape(8, 64)[:, :, None])
    assert learned.shape == (4, 8, 1)
    np.testing.assert_allclose(np.linalg.norm(learned.reshape(4, -1), axis=1), 1.0, atol=1e-5)


def test_unknown_algorithm():
    with pytest.raises(ValueError):
        ConvolutionalDictionaryLearner(4, 8, algorithm="bogus", device="cpu")


def _trainer_corpus(mld2):
    gen = JaxSignalGenerator(mld2, rates=[np.full(12, 8e-3), np.full(8, 2e-3)])
    return gen.generate_signals(6, mld2.config.block_size, seed=13)


def test_samples_trainer_bitwise_jax_and_cross_resume(inject, tmp_path, mld2):
    """A 'samples' MultilevelTrainer over mld2's config, JAX's level-0 init
    injected: bitwise JAX's dictionaries.  Its trainer_state.npz holds JAX's
    keys, and each package resumes from the other's journal halfway (level 0
    learned) to the same result."""
    cfg = mld2.config
    xs = _trainer_corpus(mld2)
    kw = dict(algorithm="samples", num_windows=256, iterations=5, seed=0)
    want = JaxTrainer(cfg, checkpoint_dir=str(tmp_path / "jax"), **kw).train(xs)
    port_cfg = _port(mld2).config
    got = MultilevelTrainer(port_cfg, checkpoint_dir=str(tmp_path / "port"), device="cpu", **kw).train(xs)
    assert got.config == port_cfg and len(got.dicts) == 2
    assert all(_same(a, b) for a, b in zip(got.dicts, want.dicts))
    with np.load(tmp_path / "port" / "trainer_state.npz") as zp, np.load(tmp_path / "jax" / "trainer_state.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files) == ["dict_0", "dict_1", "level"]
        assert all(_same(zp[k], zj[k]) for k in zj.files)
    for src, dst in (("port", "jax"), ("jax", "port")):
        half = tmp_path / f"{src}_half"
        half.mkdir()
        with np.load(tmp_path / src / "trainer_state.npz") as z:
            np.savez(half / "trainer_state.npz", level=np.int64(1), dict_0=z["dict_0"])
        if dst == "port":
            resumed = MultilevelTrainer(port_cfg, checkpoint_dir=str(half), device="cpu", **kw).train(xs)
        else:
            resumed = JaxTrainer(cfg, checkpoint_dir=str(half), **kw).train(xs)
        assert all(_same(a, b) for a, b in zip(resumed.dicts, want.dicts)), (src, dst)


def test_multilevel_trainer_and_resume(tmp_path, mld2):
    """The kmean trainer (mirror of tests/test_learn.py): shapes, unit-norm
    atoms, and a resume that skips learning and returns the same arrays."""
    cfg = _port(mld2).config
    xs = _trainer_corpus(mld2)
    ck = str(tmp_path / "ck")
    learned = MultilevelTrainer(cfg, num_windows=512, iterations=5, seed=0, checkpoint_dir=ck,
                                device="cpu").train(xs)
    assert learned.config == cfg
    assert [d.shape for d in learned.dicts] == [d.shape for d in mld2.dicts]
    for d in learned.dicts:
        np.testing.assert_allclose(np.linalg.norm(d.reshape(d.shape[0], -1), axis=1), 1.0, atol=1e-5)
    again = MultilevelTrainer(cfg, num_windows=512, iterations=5, seed=0, checkpoint_dir=ck,
                              device="cpu").train(xs)
    assert all(_same(a, b) for a, b in zip(learned.dicts, again.dicts))


def _online_fixture():
    cfg = make_test_config(counts=(8,), scales=(12,), num_coefs=(48,), block_size=512)
    mld = MultilevelDictionary.generate(cfg, seed=3)
    xs = SignalGenerator(mld, rates=2e-2, amplitude_range=(0.8, 1.2)).generate_signals(8, 512, seed=11)
    rng = np.random.default_rng(0)
    bank0 = rng.standard_normal((8, 12, 1)).astype(np.float32)
    bank0 /= np.linalg.norm(bank0.reshape(8, -1), axis=1)[:, None, None]
    return xs, bank0


def test_online_step_vs_jax(inject):
    """Two steps from the same bank on JAX's events (JAX's init injected):
    JAX's losses to 1e-5 relative and its bank to 1e-5 after each."""
    xs, bank0 = _online_fixture()
    port = OnlineConvolutionalDictionaryLearner(bank0, num_coefs=48, learning_rate=5e-2, device="cpu")
    ref = JaxOnline(bank0, num_coefs=48, learning_rate=5e-2)
    for _ in range(2):
        lp, lj = port.step(xs), ref.step(xs)
        assert abs(lp - lj) <= 1e-5 * abs(lj), (lp, lj)
        np.testing.assert_allclose(port.bank.detach().numpy(), np.asarray(ref.bank), rtol=0, atol=1e-5)
    assert port.step_count == 2 and port.loss_history == [pytest.approx(v, rel=1e-5) for v in ref.loss_history]


def _frozen_events(rng, b=3, m=40, k=5, w=7, n=90):
    pos = rng.integers(0, n - w + 1, (b, m)).astype(np.int32)
    pos[0, :6] = 11  # several events on one window
    atm = rng.integers(0, k, (b, m)).astype(np.int32)
    cds = rng.integers(-300, 301, (b, m)).astype(np.int32)
    cnt = np.array([m, m // 2, 0], np.int32)[:b]
    scl = rng.uniform(1e-3, 1e-2, b).astype(np.float32)
    return [torch.from_numpy(a) for a in (pos, atm, cds, cnt, scl)], (k, w, n)


def test_overlap_add_gradcheck():
    """`_OverlapAdd`'s backward against finite differences in float64."""
    rng = np.random.default_rng(8)
    events, (k, w, n) = _frozen_events(rng, b=2, m=12, k=3, w=4, n=30)
    events[3][1] = 7
    bank = torch.from_numpy(rng.standard_normal((k, w, 2))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda b_: _OverlapAdd.apply(b_, *events, n), (bank,))


def test_overlap_add_forward_and_backward():
    """Forward bitwise the plain ordered decode; backward equal (to float32
    rounding) to autograd through the plain decode in float64, and
    bitwise the same in two calls."""
    rng = np.random.default_rng(9)
    events, (k, w, n) = _frozen_events(rng)
    bank = torch.from_numpy(rng.standard_normal((k, w, 1)).astype(np.float32)).requires_grad_(True)
    out = _OverlapAdd.apply(bank, *events, n)
    assert torch.equal(out, mp_decode_batch_torch(*events, bank.detach(), n=n))
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    (grad,) = torch.autograd.grad(out, bank, g)
    (grad2,) = torch.autograd.grad(_OverlapAdd.apply(bank, *events, n), bank, g)
    assert torch.equal(grad, grad2)
    b64 = bank.detach().double().requires_grad_(True)
    (want,) = torch.autograd.grad(mp_decode_batch_torch(*events, b64, n=n), b64, g.double())
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert grad.abs().sum() > 0


def test_online_learner_improves_reconstruction():
    """Loss decreases on a fixed minibatch from a noisy starting bank, atoms
    stay unit-norm (mirror of tests/test_learn.py)."""
    xs, bank0 = _online_fixture()
    learner = OnlineConvolutionalDictionaryLearner(bank0, num_coefs=48, learning_rate=5e-2, device="cpu")
    losses = [learner.step(xs) for _ in range(12)]
    assert losses[-1] < losses[0] * 0.9, losses
    np.testing.assert_allclose(np.linalg.norm(learner.bank.detach().numpy().reshape(8, -1), axis=1), 1.0,
                               atol=1e-5)
    custom = OnlineConvolutionalDictionaryLearner(
        bank0, num_coefs=48, optimizer=lambda p: torch.optim.SGD(p, lr=1.0), device="cpu")
    assert isinstance(custom.opt, torch.optim.SGD)
    custom.step(xs)


def test_checkpoint_roundtrip(tmp_path, mld2):
    """Mirror of tests/test_checkpoint.py, plus: a leftover temporary file of
    a torn write is not a step, and `restore` of an empty directory is None."""
    ck = DictionaryCheckpointer(str(tmp_path / "ck"))
    assert ck.latest_step() is None and ck.restore() is None
    state = {"centroid_sums": np.ones((8, 16), np.float32), "iteration": np.int64(5)}
    port = _port(mld2)
    ck.save(3, port, learner_state=state)
    ck.save(7, port)
    (tmp_path / "ck" / "step_00000009.npz.tmp.1").write_bytes(b"torn")
    assert ck.latest_step() == 7
    assert sorted(os.listdir(tmp_path / "ck"))[:2] == ["step_00000003.npz", "step_00000007.npz"]
    step, mld, learner = ck.restore(3)
    assert step == 3 and mld.config == port.config
    assert all(_same(a, b) for a, b in zip(mld.dicts, mld2.dicts))
    np.testing.assert_array_equal(learner["centroid_sums"], state["centroid_sums"])
    assert int(learner["iteration"]) == 5
    step, mld, learner = DictionaryCheckpointer(str(tmp_path / "ck")).restore()  # latest
    assert step == 7 and learner == {}
