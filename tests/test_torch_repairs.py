"""The two kernel shapes the card used to refuse, on the CPU against the JAX
package: the int8 init of a block with more than 8192 events (the cell
kernel now sorts past shared memory in a global workspace) and the ordered
decode of a multichannel bank (the level-space decode of a level >= 1).
On the CPU the wrappers run their plain versions, which the card's kernels
are held to bitwise (tests/test_torch_kernels.py, chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hsc_tpu.ops.decode import mp_decode_batch_jax
from hsc_tpu.ops.encode import EncodedBlock as JaxEncodedBlock
from hsc_tpu.ops.encode import encode_init_int_batched as jax_init_int
from hsc_tpu.ops.encode import feature_map_int_jax
from hsc_tpu.oracle.mp import LevelStream, balanced_digits, bank_quantize_int16, mp_decode

from hsc_torch.ops import decode_kernel, init_kernels


@pytest.mark.parametrize("m", [9000, 20000])
def test_int8_init_many_events_bitwise_jax(m):
    """Blocks of 9000 and 20000 events (dense duplicates: a map of 400 x 6
    cells), with events past `count` and off the map: `int8_init` (the
    plain event route on the CPU) gives the score buffer and the peak of
    JAX's dense hand-off and int8 init bitwise, e0 within 1e-6."""
    rng = np.random.default_rng(m)
    b, n, c, n_raw, w = 2, 400, 6, 5, 13
    positions = rng.integers(0, n, size=(b, m)).astype(np.int32)
    atoms = rng.integers(0, c, size=(b, m)).astype(np.int32)
    codes = rng.integers(-32767, 32768, size=(b, m)).astype(np.int32)
    count = np.array([m, m - 1234], np.int32)
    positions[0, 7], positions[1, 8], atoms[0, 9] = -1, n, c  # off the map
    bq, step = bank_quantize_int16(rng.standard_normal((n_raw, w, c)).astype(np.float32))
    planes = balanced_digits(bq, 2).astype(np.int8)
    prev_scale = rng.uniform(1e-6, 1e-3, size=b).astype(np.float32)

    t = [torch.from_numpy(a) for a in (positions, atoms, codes, count, prev_scale, planes)]
    s0, e0, peak = init_kernels.int8_init(*t, step, n_map=n)
    m_j = jnp.stack([
        feature_map_int_jax(
            JaxEncodedBlock(jnp.asarray(positions[j]), jnp.asarray(atoms[j]), jnp.asarray(codes[j]),
                            jnp.int32(count[j]), jnp.float32(0), jnp.float32(0), jnp.float32(0)),
            npos=n, k=c,
        )
        for j in range(b)
    ])
    s0_j, e0_j, peak_j = jax_init_int(m_j, jnp.asarray(prev_scale), jnp.asarray(planes), jnp.float32(step))
    assert s0.shape == (b, n_raw + c, n - w + 1)
    assert s0.numpy().tobytes() == np.asarray(s0_j).tobytes()
    assert peak.numpy().tobytes() == np.asarray(peak_j).tobytes()
    np.testing.assert_allclose(e0.numpy(), np.asarray(e0_j), rtol=1e-6)


@pytest.mark.parametrize("c", [2, 7, 12])
def test_ordered_decode_multichannel_bitwise_jax(c):
    """`mp_decode_batch` on a bank of C channels (the plain version on the
    CPU), with events piled onto a few positions, an empty block and a
    ragged count: bitwise JAX's batched ordered decode and
    `oracle.mp.mp_decode`."""
    rng = np.random.default_rng(50 + c)
    b, k, w, n, m = 3, 9, 17, 700, 120
    bank = rng.standard_normal((k, w, c)).astype(np.float32)
    hot = rng.integers(0, n - w + 1, size=12)
    pos = rng.choice(hot, size=(b, m)).astype(np.int32)
    atm = rng.integers(0, k, size=(b, m)).astype(np.int32)
    cds = rng.integers(-32767, 32768, size=(b, m)).astype(np.int32)
    cnt = np.array([m, 0, m - 17], np.int32)
    scale = rng.uniform(1e-6, 1e-3, size=b).astype(np.float32)
    got = decode_kernel.mp_decode_batch(
        *(torch.from_numpy(a) for a in (pos, atm, cds, cnt, scale, bank)), n=n
    ).numpy()
    assert got.shape == (b, n, c)
    want = np.asarray(mp_decode_batch_jax(*(jnp.asarray(a) for a in (pos, atm, cds, cnt, scale, bank)), n=n))
    assert got.tobytes() == want.tobytes()
    for j in range(b):
        st = LevelStream(pos[j, :cnt[j]], atm[j, :cnt[j]], cds[j, :cnt[j]], scale[j], 0.0, 0.0)
        assert got[j].tobytes() == mp_decode(st, bank, n).tobytes()
