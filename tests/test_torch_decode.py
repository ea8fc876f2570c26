"""The port's integer decode (`hsc_torch.ops.decode`) against the JAX package
on the CPU: bitwise the XLA path, the Pallas kernel in interpret mode and the
NumPy oracle — including the spec's mod-2^32 wraparound."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hsc_tpu import SignalGenerator
from hsc_tpu.ops.decode import mp_decode_integer_batch_jax
from hsc_tpu.ops.decode_integer_kernel import mp_decode_integer_pallas
from hsc_tpu.oracle.mp import LevelStream, mp_decode_integer, mp_encode, rep_quantize

from hsc_torch.ops import decode_integer_kernel
from hsc_torch.ops.decode import mp_decode_integer_batch_torch, mp_decode_integer_torch


def _arrays(streams, step, cap):
    nb = len(streams)
    pos = np.zeros((nb, cap), np.int32)
    atm = np.zeros((nb, cap), np.int32)
    cds = np.zeros((nb, cap), np.int32)
    cnt = np.zeros(nb, np.int32)
    amp = np.zeros(nb, np.float32)
    for b, s in enumerate(streams):
        n = s.positions.shape[0]
        pos[b, :n], atm[b, :n], cds[b, :n], cnt[b] = s.positions, s.atoms, s.codes, n
        amp[b] = np.float32(np.float32(s.scale) * np.float32(step))
    return pos, atm, cds, cnt, amp


def _encoded_streams(mld, n_blocks, seed):
    cfg = mld.config
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(n_blocks, cfg.block_size, seed=seed)
    return [
        mp_encode(x[:, None], mld.augmented(0), mld.gram(0), num_coefs=cfg.num_coefs[0], num_select=4)
        for x in xs
    ]


def _wrap_streams():
    """Max codes x max rep codes piled onto a few positions: sums far past
    2^31, so int32 wraps (the spec's mod 2^32)."""
    m = 512
    s0 = LevelStream(
        positions=np.zeros(m, np.int32), atoms=np.zeros(m, np.int32),
        codes=np.full(m, 32767, np.int32), scale=np.float32(1e-4),
        energy0=1.0, energy_res=1.0,
    )
    s1 = LevelStream(
        positions=(np.arange(m) % 7).astype(np.int32), atoms=(np.arange(m) % 2).astype(np.int32),
        codes=np.where(np.arange(m) % 3 == 0, -32767, 32767).astype(np.int32),
        scale=np.float32(3e-5), energy0=1.0, energy_res=1.0,
    )
    rep_q = np.full((2, 16, 1), 4095, np.int32)
    rep_q[1, ::2] = -4095
    return [s0, s1], rep_q, np.float32(2e-4), 64


@pytest.mark.parametrize("case", ["encoded", "wraparound"])
def test_integer_decode_bitwise(mld1, case):
    if case == "encoded":
        cfg = mld1.config
        streams = _encoded_streams(mld1, 3, seed=51)
        streams[1] = LevelStream(  # a count-masked, partly empty block
            positions=streams[1].positions[:5], atoms=streams[1].atoms[:5],
            codes=streams[1].codes[:5], scale=streams[1].scale, energy0=0.0, energy_res=0.0,
        )
        rep_q, step = rep_quantize(mld1.representations(0)[:, :, None], cfg.rep_bits)
        n, cap = cfg.block_size, cfg.num_coefs[0]
    else:
        streams, rep_q, step, n = _wrap_streams()
        cap = 512
    arrs = _arrays(streams, step, cap)
    got = mp_decode_integer_batch_torch(
        *[torch.from_numpy(a) for a in arrs], torch.from_numpy(rep_q), n=n
    ).numpy()
    jargs = [jnp.asarray(a) for a in arrs]
    xla = np.asarray(mp_decode_integer_batch_jax(*jargs, jnp.asarray(rep_q), n=n))
    pk = np.asarray(mp_decode_integer_pallas(*jargs, jnp.asarray(rep_q), n=n, interpret=True))
    assert got.tobytes() == xla.tobytes()
    assert got.tobytes() == pk.tobytes()
    for b, s in enumerate(streams):
        assert got[b].tobytes() == mp_decode_integer(s, rep_q, step, n).tobytes()
    if case == "wraparound":
        assert (got < 0).any()  # the wrap really happened


def test_single_block_form_and_cpu_dispatch(mld1):
    """The single-block form equals the batch form, and the dispatcher on
    CPU tensors is the plain version (no kernel launch)."""
    cfg = mld1.config
    streams = _encoded_streams(mld1, 2, seed=53)
    rep_q, step = rep_quantize(mld1.representations(0)[:, :, None], cfg.rep_bits)
    args = [torch.from_numpy(a) for a in _arrays(streams, step, cfg.num_coefs[0])]
    rq = torch.from_numpy(rep_q)
    before = decode_integer_kernel.LAUNCHES
    batch = decode_integer_kernel.mp_decode_integer_batch(*args, rq, n=cfg.block_size)
    assert decode_integer_kernel.LAUNCHES == before
    assert torch.equal(batch, mp_decode_integer_batch_torch(*args, rq, n=cfg.block_size))
    one = mp_decode_integer_torch(
        args[0][1], args[1][1], args[2][1], args[3][1], args[4][1], rq, n=cfg.block_size
    )
    assert torch.equal(one, batch[1])
