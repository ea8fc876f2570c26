"""The port's encode (`hsc_torch.ops`) against the JAX package on the CPU.

The init correlation is held to a tolerance (its reduction order is the
backend's choice — README "Determinism contract"); the greedy loop, given
JAX's own init, is held bitwise to the XLA path, to the Pallas kernel in
interpret mode and to the NumPy oracle."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hsc_tpu import SignalGenerator
from hsc_tpu.ops.encode import batched_loop_for
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.ops.mp_kernels import mp_encode_pallas, pallas_num_select_options

from hsc_torch.ops import mp_kernels
from hsc_torch.ops.encode import (
    encode_init_batched,
    mp_encode_from_init_torch,
    quantizer_steps,
)
from hsc_torch.params import level_params_from_mld
from pinned import oracle_encode_pinned

# energy_res is held to the oracle, the spec: the XLA path's differs from it
# by a few ulps on the CPU (ROADMAP Queue 3), and it is never serialized
FIELDS = ("positions", "atoms", "codes", "count", "scale", "energy0")


def _blocks(mld, n, seed):
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(n, mld.config.block_size, seed=seed)
    xs[-1] = 0.0  # an all-zero block emits nothing
    return xs


def _jax_init(mld, xs):
    s0, e0, peak = jax_init(jnp.asarray(xs)[:, :, None], jnp.asarray(mld.augmented(0)))
    return np.asarray(s0), np.asarray(e0), np.asarray(peak)


def test_init_within_tolerance_of_jax(mld1):
    xs = _blocks(mld1, 3, seed=21)
    s0_j, e0_j, peak_j = _jax_init(mld1, xs)
    params = level_params_from_mld(mld1, 0, "cpu")
    s0, e0, peak = encode_init_batched(torch.from_numpy(xs[:, :, None]), params.bank)
    for b in range(3):
        np.testing.assert_allclose(s0[b].numpy(), s0_j[b], rtol=0, atol=1e-5 * max(peak_j[b], 1e-30))
    np.testing.assert_allclose(e0.numpy(), e0_j, rtol=1e-5)
    np.testing.assert_allclose(peak.numpy(), peak_j, rtol=1e-5)


@pytest.mark.parametrize(
    "ns,tol",
    [(1, None), (4, None), (8, None), (3, None), (1, 12.0), (8, 12.0)],
)
def test_loop_bitwise_vs_xla_pallas_oracle(mld1, ns, tol):
    """Greedy loop with JAX's init injected: bitwise the XLA path, the Pallas
    kernel (interpret mode, for the num_select it supports) and the oracle."""
    cfg = mld1.config
    xs = _blocks(mld1, 3, seed=31)
    s0, e0, peak = _jax_init(mld1, xs)
    scale, inv = quantizer_steps(peak, cfg.amp_bits)
    params = level_params_from_mld(mld1, 0, "cpu")
    got = mp_encode_from_init_torch(
        *(torch.tensor(a) for a in (s0, e0, scale, inv)), params, num_coefs=cfg.num_coefs[0],
        amp_bits=cfg.amp_bits, tolerance_snr=tol, num_select=ns,
    )
    got = {f: getattr(got, f).numpy() for f in FIELDS + ("energy_res",)}
    assert got["count"][-1] == 0 and (got["positions"][-1] == 0).all()

    settings = dict(
        num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, tolerance_snr=tol,
        singleton_weight=1.0, n_raw=cfg.counts[0], num_select=ns,
    )
    bank = jnp.asarray(mld1.augmented(0))
    gram_t = jnp.asarray(np.ascontiguousarray(mld1.gram(0).transpose(1, 0, 2)))
    xla = batched_loop_for(tuple(sorted(settings.items())))(
        jnp.asarray(s0), jnp.asarray(e0), jnp.asarray(scale), jnp.asarray(inv), bank, gram_t
    )
    for f in FIELDS:
        assert got[f].tobytes() == np.asarray(getattr(xla, f)).tobytes(), f

    if ns in pallas_num_select_options(s0.shape[2], bank.shape[1]):
        pk = mp_encode_pallas(jnp.asarray(xs)[:, :, None], bank, gram_t, interpret=True, **settings)
        for f in FIELDS:
            assert got[f].tobytes() == np.asarray(getattr(pk, f)).tobytes(), f

    for b in range(3):
        ref = oracle_encode_pinned(xs[b][:, None], mld1, tolerance_snr=tol, num_select=ns)
        n = got["count"][b]
        assert n == ref.positions.shape[0]
        assert got["positions"][b, :n].tobytes() == ref.positions.tobytes()
        assert got["atoms"][b, :n].tobytes() == ref.atoms.tobytes()
        assert got["codes"][b, :n].tobytes() == ref.codes.tobytes()
        assert got["scale"][b] == ref.scale
        assert got["energy_res"][b] == np.float32(ref.energy_res)


def test_pallas_options_cover_the_loop_cases():
    # the Pallas kernel takes num_select in {1, fold, 2*fold} at cfg1's
    # geometry; the port's kernel takes every num_select
    assert pallas_num_select_options(1009, 16) == (1, 4, 8)


def test_loop_leaves_scores0_intact_and_dispatch_on_cpu(mld1):
    """`mp_loop` on CPU tensors is the plain loop (no kernel launch), and
    neither touches the caller's init."""
    cfg = mld1.config
    xs = _blocks(mld1, 2, seed=41)
    s0, e0, peak = _jax_init(mld1, xs)
    scale, inv = quantizer_steps(peak, cfg.amp_bits)
    params = level_params_from_mld(mld1, 0, "cpu")
    args = [torch.tensor(a) for a in (s0, e0, scale, inv)]
    kw = dict(num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, num_select=4)
    before = mp_kernels.LAUNCHES
    a = mp_kernels.mp_loop(*args, params, **kw)
    b = mp_encode_from_init_torch(*args, params, **kw)
    assert mp_kernels.LAUNCHES == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert args[0].numpy().tobytes() == s0.tobytes()
