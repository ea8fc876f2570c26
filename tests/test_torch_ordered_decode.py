"""The port's ordered decode (decode_mode='ordered', format v1) against the
JAX package on the CPU: `hsc_torch.ops.decode.mp_decode_batch_torch` is
bitwise the XLA scan, the Pallas kernel in interpret mode and the NumPy
oracle (`oracle.mp.mp_decode`, `oracle.hierarchical_decode`).  Stream order
matters here: overlapping events add in the order they were emitted."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hsc_tpu import MultilevelDictionary, SignalGenerator
from hsc_tpu.models.coder import HierarchicalConvolutionalSparseCoder as JaxCoder
from hsc_tpu.ops.decode import mp_decode_batch_jax
from hsc_tpu.ops.decode_kernel import mp_decode_pallas
from hsc_tpu.oracle import hierarchical_decode
from hsc_tpu.oracle.mp import LevelStream, mp_decode

from hsc_torch.models import HierarchicalConvolutionalSparseCoder
from hsc_torch.ops import decode_kernel
from hsc_torch.ops.decode import mp_decode_batch_torch
from hsc_torch.params import dictionary_from_arrays


def _random_batch(rng, b, m, n, k, w):
    """Events piled onto a few positions (so adds overlap and order
    matters), full-range codes, ragged counts and one empty block."""
    pos = rng.choice(rng.integers(0, n - w + 1, size=8), size=(b, m)).astype(np.int32)
    atm = rng.integers(0, k, size=(b, m)).astype(np.int32)
    cds = rng.integers(-32767, 32768, size=(b, m)).astype(np.int32)
    cnt = rng.integers(1, m + 1, size=b).astype(np.int32)
    cnt[-1] = 0
    scale = rng.uniform(1e-6, 1e-2, size=b).astype(np.float32)
    return pos, atm, cds, cnt, scale


@pytest.mark.parametrize("seed,b,m,n,k,w,c", [
    (0, 4, 60, 300, 7, 16, 1),
    (1, 3, 200, 1024, 20, 48, 1),
    (2, 2, 5, 40, 3, 40, 1),     # an atom as wide as the block
    (3, 3, 30, 200, 5, 9, 3),    # multichannel bank (plain version only)
])
def test_ordered_decode_bitwise(seed, b, m, n, k, w, c):
    rng = np.random.default_rng(seed)
    pos, atm, cds, cnt, scale = _random_batch(rng, b, m, n, k, w)
    bank = rng.standard_normal((k, w, c)).astype(np.float32)
    args = (pos, atm, cds, cnt, scale, bank)
    got = mp_decode_batch_torch(*(torch.from_numpy(a) for a in args), n=n).numpy()
    assert got.shape == (b, n, c) and got.dtype == np.float32
    assert got.tobytes() == np.asarray(mp_decode_batch_jax(*(jnp.asarray(a) for a in args), n=n)).tobytes()
    if c == 1:
        pallas = mp_decode_pallas(*(jnp.asarray(a) for a in args), n=n, interpret=True)
        assert got.tobytes() == np.asarray(pallas).tobytes()
    for j in range(b):
        st = LevelStream(pos[j, :cnt[j]], atm[j, :cnt[j]], cds[j, :cnt[j]], scale[j], 0.0, 0.0)
        assert got[j].tobytes() == mp_decode(st, bank, n).tobytes()
    assert not got[-1].any()
    # the kernel wrapper takes the plain version for CPU tensors
    before = decode_kernel.LAUNCHES
    if c == 1:
        wrapped = decode_kernel.mp_decode_batch(*(torch.from_numpy(a) for a in args), n=n)
        assert wrapped.numpy().tobytes() == got.tobytes() and decode_kernel.LAUNCHES == before


def test_order_matters():
    """Two events on one sample in either order give the oracle's two
    different roundings, not one of them twice."""
    bank = np.array([[[1.0]], [[3.0e-8]]], np.float32)
    pos = np.zeros((2, 3), np.int32)
    atm = np.array([[0, 1, 1], [1, 1, 0]], np.int32)
    cds = np.ones((2, 3), np.int32)
    cnt = np.array([3, 3], np.int32)
    scale = np.ones(2, np.float32)
    got = mp_decode_batch_torch(
        *(torch.from_numpy(a) for a in (pos, atm, cds, cnt, scale, bank)), n=1
    ).numpy()
    for j in range(2):
        st = LevelStream(pos[j], atm[j], cds[j], np.float32(1), 0.0, 0.0)
        assert got[j].tobytes() == mp_decode(st, bank, 1).tobytes()
    assert got[0, 0, 0] != got[1, 0, 0]


@pytest.mark.parametrize("levels", [1, 2])
def test_coder_ordered_reconstruct_matches_jax_and_oracle(mld1, mld2, levels):
    """`reconstruct_batch(mode='ordered')` on real top streams == the JAX
    coder's == `oracle.hierarchical_decode` per block."""
    mld = MultilevelDictionary.generate(
        dataclasses.replace((mld1, mld2)[levels - 1].config, decode_mode="ordered"), seed=11
    )
    cfg = mld.config
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(4, cfg.block_size, seed=51)
    tc = HierarchicalConvolutionalSparseCoder(
        dictionary_from_arrays(cfg.to_json(), mld.dicts), device="cpu"
    )
    top = [s[-1] for s in tc.encode_batch(xs)]
    got = tc.reconstruct_batch(top)
    assert got.tobytes() == JaxCoder(mld, backend="jax").reconstruct_batch(top).tobytes()
    for b in range(4):
        assert got[b].tobytes() == hierarchical_decode(top[b], mld).tobytes()
    if levels == 2:  # a level-0 stream decodes through the level-0 bank
        low = [s[0] for s in tc.encode_batch(xs)]
        rows = tc.reconstruct_batch(low, level=0)
        for b in range(4):
            assert rows[b].tobytes() == hierarchical_decode(low[b], mld, level=0).tobytes()


@pytest.mark.parametrize("n", [65536])
def test_ordered_decode_large_block_vs_jax(n):
    """A 65536-sample block: the plain ordered decode bitwise the JAX
    package's XLA scan on random events piled onto a few positions (adds
    overlap, so stream order decides the bits), ragged counts and an empty
    block."""
    rng = np.random.default_rng(n)
    b, m, k, w = 3, 500, 24, 96
    pos, atm, cds, cnt, scale = _random_batch(rng, b, m, n, k, w)
    bank = rng.standard_normal((k, w, 1)).astype(np.float32)
    args = (pos, atm, cds, cnt, scale, bank)
    got = mp_decode_batch_torch(*(torch.from_numpy(a) for a in args), n=n).numpy()
    assert got.shape == (b, n, 1)
    assert got.tobytes() == np.asarray(mp_decode_batch_jax(*(jnp.asarray(a) for a in args), n=n)).tobytes()
    assert got[0].any() and not got[-1].any()
