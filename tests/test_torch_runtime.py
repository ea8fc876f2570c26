"""The port's slice end to end (`hsc_torch.runtime.CorpusEncoder`) against the
JAX package's `CorpusEncoder` on the CPU.

With JAX's init injected where the port's pipeline looks it up, the port's
container is byte-identical to the JAX package's; both decoders give
byte-identical rows from it.  Without injection the init agrees only to a
tolerance (README "Determinism contract"), so bytes are compared injected."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hsc_tpu import MultilevelDictionary, SignalGenerator, make_test_config
from hsc_tpu.models.coder import HierarchicalConvolutionalSparseCoder as JaxCoder
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.runtime import CorpusEncoder as JaxCorpusEncoder

import hsc_torch.models.coder
import hsc_torch.ops.pipeline
from hsc_torch.models import HierarchicalConvolutionalSparseCoder
from hsc_torch.params import dictionary_from_arrays, level_params_from_mld, level_params_from_numpy
from hsc_torch.runtime import CorpusEncoder


def _port(mld):
    """The port's copy of a JAX package dictionary."""
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


def _inject_jax_init(monkeypatch, module=hsc_torch.ops.pipeline):
    """Make `module` call JAX's init where it looks up `encode_init_batched`."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(module, "encode_init_batched", init)


@pytest.mark.parametrize("ns", [1, 4])
def test_container_byte_identical_to_jax(monkeypatch, ns):
    cfg = make_test_config(num_select=ns)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(5, cfg.block_size, seed=61)
    xs[3] = 0.0
    ref = JaxCorpusEncoder(mld, backend="jax", batch_size=2).encode(xs)
    _inject_jax_init(monkeypatch)
    codec = CorpusEncoder(_port(mld), device="cpu", batch_size=2)
    blob = codec.encode(xs)
    assert blob == ref
    rows = codec.decode(blob)
    jax_rows = JaxCorpusEncoder(mld, backend="jax", batch_size=2).decode(blob)
    assert rows.shape == (5, cfg.block_size) and rows.dtype == np.float32
    assert rows.tobytes() == jax_rows.tobytes()
    assert b"".join(r.tobytes() for r in codec.decode_stream(blob)) == rows.tobytes()


def test_coder_classes_match_jax(monkeypatch, mld1):
    """`encode_batch` / `reconstruct_batch` of the port's coder equal the
    JAX coder's (JAX's init injected)."""
    cfg = mld1.config
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(3, cfg.block_size, seed=65)
    jc = JaxCoder(mld1, backend="jax")
    ref = [s[0] for s in jc.encode_batch(xs)]
    _inject_jax_init(monkeypatch, hsc_torch.models.coder)
    tc = HierarchicalConvolutionalSparseCoder(_port(mld1), device="cpu")
    got = [s[0] for s in tc.encode_batch(xs)]
    for a, b in zip(got, ref):
        for f in ("positions", "atoms", "codes"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
        assert a.scale == b.scale
    assert tc.reconstruct_batch(got).tobytes() == jc.reconstruct_batch(ref).tobytes()


def test_uninjected_encode_roundtrip(mld1):
    """The port's own init: a valid container, decoded bitwise by the JAX
    decoder, with the codec's usual reconstruction quality."""
    cfg = mld1.config
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(3, cfg.block_size, seed=63)
    codec = CorpusEncoder(_port(mld1), device="cpu", backend="torch")
    blob = codec.encode(xs)
    rows = codec.decode(blob)
    assert rows.tobytes() == JaxCorpusEncoder(mld1, backend="jax").decode(blob).tobytes()
    err = np.sum((xs - rows) ** 2, axis=1) / np.sum(xs**2, axis=1)
    assert (err < 0.5).all()
    empty = codec.encode(np.zeros((0, cfg.block_size), np.float32))
    assert codec.decode(empty).shape == (0, cfg.block_size)


def test_level_params_from_jax_arrays(mld1):
    """`level_params_from_numpy` on a JAX coder's own arrays equals
    `level_params_from_mld`."""
    cfg = mld1.config
    coder = JaxCoder(mld1, backend="jax")
    rep_q, step = coder._rep_q(0, cfg.rep_bits)
    a = level_params_from_numpy(
        np.asarray(coder.coders[0].mp.bank), np.asarray(coder.coders[0].mp.gram_t),
        rep_q=np.asarray(rep_q), rep_step=step, n_raw=cfg.counts[0],
        singleton_weight=1.0, device="cpu",
    )
    b = level_params_from_mld(_port(mld1), 0, "cpu")
    for f in ("bank", "gram_t", "weights", "rep_q"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), f
    assert a.bank.dtype == torch.float32 and a.rep_q.dtype == torch.int32
    assert a.rep_step == b.rep_step and a.rep_step.dtype == np.float32
