"""The port's kernels against their plain PyTorch versions and the NumPy
oracle, on each device.

Every test runs twice: on the CPU, where the kernel wrappers take the plain
versions (so the plain versions meet the oracle on every geometry here), and
on the card, where they launch the CUDA kernels.  The card's cases need an
NVIDIA GPU and the CUDA toolkit (`nvcc`): they are marked `cuda` and skip on
a host without a card.  This file imports no JAX, so it also runs on a
machine that has none:

    python -m pytest tests/test_torch_kernels.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from hsc_tpu import MultilevelDictionary, SignalGenerator, make_test_config
from hsc_tpu.dictionary import bank_gram
from hsc_tpu.oracle.mp import LevelStream, mp_decode_integer, mp_encode

from hsc_torch.ops import decode_integer_kernel, mp_kernels
from hsc_torch.ops.decode import mp_decode_integer_batch_torch
from hsc_torch.ops.encode import encode_init_batched, mp_encode_from_init_torch, quantizer_steps
from hsc_torch.params import level_params_from_mld, level_params_from_numpy
from hsc_torch.runtime import CorpusEncoder


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device(request.param)


def _launches():
    return mp_kernels.LAUNCHES, decode_integer_kernel.LAUNCHES


def _init(mld, n_blocks, seed, device):
    cfg = mld.config
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(n_blocks, cfg.block_size, seed=seed)
    xs[0] = 0.0  # an all-zero block emits nothing
    params = level_params_from_mld(mld, 0, device)
    s0, e0, peak = encode_init_batched(torch.from_numpy(xs[:, :, None]).to(device), params.bank)
    scale, inv = quantizer_steps(peak.cpu().numpy(), cfg.amp_bits)
    return xs, params, (s0, e0, torch.from_numpy(scale).to(device), torch.from_numpy(inv).to(device))


# assorted geometries: (counts, scales, block_size, num_coefs, num_select,
# tolerance_snr) — K below and above a warp, odd widths, odd num_select
GEOMETRIES = [
    ((16,), (16,), 1024, (64,), 1, None),
    ((16,), (16,), 1024, (64,), 8, 12.0),
    ((7,), (33,), 777, (50,), 3, None),
    ((12,), (8,), 3000, (300,), 5, None),
    ((64,), (59,), 4096, (200,), 2, 9.0),
    ((40,), (48,), 4096, (200,), 7, None),
    ((4,), (4,), 130, (40,), 1, None),
]


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_mp_kernel_bitwise_plain_and_oracle(device, geom):
    counts, scales, n, nc, ns, tol = geom
    cfg = make_test_config(counts=counts, scales=scales, block_size=n, num_coefs=nc)
    mld = MultilevelDictionary.generate(cfg, seed=5)
    xs, params, init = _init(mld, 5, 9, device)
    kw = dict(num_coefs=nc[0], amp_bits=cfg.amp_bits, tolerance_snr=tol, num_select=ns)
    s0_before = init[0].clone()
    got = mp_kernels.mp_loop(*init, params, **kw)
    ref = mp_encode_from_init_torch(*init, params, **kw)
    assert torch.equal(init[0], s0_before)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert int(got.count[0]) == 0
    b = 1
    o = mp_encode(
        xs[b][:, None], mld.augmented(0), mld.gram(0), scores0=init[0][b].cpu().numpy(),
        energy0=float(init[1][b]), num_coefs=nc[0], tolerance_snr=tol, num_select=ns,
    )
    n_ev = int(got.count[b])
    assert n_ev == o.positions.shape[0]
    assert np.array_equal(got.positions[b, :n_ev].cpu().numpy(), o.positions)
    assert np.array_equal(got.codes[b, :n_ev].cpu().numpy(), o.codes)


@pytest.mark.parametrize("seed", range(12))
def test_mp_kernel_random_geometry(device, seed):
    """Random bank shape, block length, budget, num_select, amplitude bits,
    selection weights and SNR stop: kernel bitwise the plain loop, and one
    block bitwise the oracle."""
    rng = np.random.default_rng(1000 + seed)
    k, w = int(rng.integers(1, 97)), int(rng.integers(1, 65))
    n, m = int(rng.integers(w, 12000)), int(rng.integers(0, 400))
    ns, amp_bits = int(rng.integers(1, 13)), int(rng.integers(4, 17))
    tol = None if rng.random() < 0.5 else float(rng.uniform(3.0, 20.0))
    n_raw = int(rng.integers(1, k + 1))
    sw = float(rng.choice([1.0, 0.5, 2.0]))
    bank = rng.standard_normal((k, w, 1)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=(1, 2), keepdims=True)
    gram = bank_gram(bank)
    params = level_params_from_numpy(
        bank, np.ascontiguousarray(gram.transpose(1, 0, 2)), n_raw=n_raw,
        singleton_weight=sw, device=device,
    )
    xs = rng.standard_normal((4, n)).astype(np.float32)
    xs[2] = 0.0
    s0, e0, peak = encode_init_batched(torch.from_numpy(xs[:, :, None]).to(device), params.bank)
    scale, inv = quantizer_steps(peak.cpu().numpy(), amp_bits)
    init = (s0, e0, torch.from_numpy(scale).to(device), torch.from_numpy(inv).to(device))
    kw = dict(num_coefs=m, amp_bits=amp_bits, tolerance_snr=tol, num_select=ns)
    got = mp_kernels.mp_loop(*init, params, **kw)
    ref = mp_encode_from_init_torch(*init, params, **kw)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    o = mp_encode(
        xs[0][:, None], bank, gram, scores0=s0[0].cpu().numpy(), energy0=float(e0[0]),
        num_coefs=m, amp_bits=amp_bits, tolerance_snr=tol, singleton_weight=sw,
        n_raw=n_raw, num_select=ns,
    )
    n_ev = int(got.count[0])
    assert n_ev == o.positions.shape[0]
    assert np.array_equal(got.positions[0, :n_ev].cpu().numpy(), o.positions)
    assert np.array_equal(got.atoms[0, :n_ev].cpu().numpy(), o.atoms)
    assert np.array_equal(got.codes[0, :n_ev].cpu().numpy(), o.codes)


@pytest.mark.parametrize("seed", range(6))
def test_int_decode_kernel_random_events(device, seed):
    """Random table shape, block length and events (positions up to the
    last placement, full-range codes and reps, ragged counts)."""
    rng = np.random.default_rng(2000 + seed)
    k, w = int(rng.integers(1, 97)), int(rng.integers(1, 65))
    n, m, b = int(rng.integers(w, 40000)), int(rng.integers(1, 700)), 5
    rep = rng.integers(-4095, 4096, size=(k, w, 1)).astype(np.int32)
    pos = rng.integers(0, n - w + 1, size=(b, m)).astype(np.int32)
    atm = rng.integers(0, k, size=(b, m)).astype(np.int32)
    cds = rng.integers(-32767, 32768, size=(b, m)).astype(np.int32)
    cnt = rng.integers(0, m + 1, size=b).astype(np.int32)
    amp = rng.uniform(1e-9, 1e-3, size=b).astype(np.float32)
    args = [torch.from_numpy(a).to(device) for a in (pos, atm, cds, cnt, amp, rep)]
    got = decode_integer_kernel.mp_decode_integer_batch(*args, n=n)
    assert torch.equal(got, mp_decode_integer_batch_torch(*args, n=n))
    for j in range(b):
        c = cnt[j]
        st = LevelStream(pos[j, :c], atm[j, :c], cds[j, :c], np.float32(1), 0.0, 0.0)
        assert got[j].cpu().numpy().tobytes() == mp_decode_integer(st, rep, amp[j], n).tobytes()


def test_int_decode_kernel_bitwise_plain_and_oracle(device):
    cfg = make_test_config(counts=(9,), scales=(21,), block_size=2000, num_coefs=(120,))
    mld = MultilevelDictionary.generate(cfg, seed=3)
    _, params, init = _init(mld, 6, 11, device)
    enc = mp_kernels.mp_loop(*init, params, num_coefs=120, num_select=4)
    amp = (init[2] * torch.tensor(params.rep_step, device=device)).contiguous()
    args = (enc.positions, enc.atoms, enc.codes, enc.count, amp, params.rep_q)
    got = decode_integer_kernel.mp_decode_integer_batch(*args, n=cfg.block_size)
    assert torch.equal(got, mp_decode_integer_batch_torch(*args, n=cfg.block_size))
    rep = params.rep_q.cpu().numpy()
    for b in range(6):
        n_ev = int(enc.count[b])
        st = LevelStream(
            enc.positions[b, :n_ev].cpu().numpy(), enc.atoms[b, :n_ev].cpu().numpy(),
            enc.codes[b, :n_ev].cpu().numpy(), np.float32(init[2][b].item()), 0.0, 0.0,
        )
        ref = mp_decode_integer(st, rep, params.rep_step, cfg.block_size)
        assert got[b].cpu().numpy().tobytes() == ref.tobytes()


def test_int_decode_kernel_wraparound(device):
    m, w, n = 512, 16, 64
    rep = np.full((1, w, 1), 4095, np.int32)
    args = [
        torch.from_numpy(a).to(device)
        for a in (np.zeros((1, m), np.int32), np.zeros((1, m), np.int32),
                  np.full((1, m), 32767, np.int32), np.array([m], np.int32),
                  np.array([2e-8], np.float32), rep)
    ]
    got = decode_integer_kernel.mp_decode_integer_batch(*args, n=n)
    assert torch.equal(got, mp_decode_integer_batch_torch(*args, n=n))
    st = LevelStream(np.zeros(m, np.int32), np.zeros(m, np.int32), np.full(m, 32767, np.int32),
                     np.float32(1), 0.0, 0.0)
    assert got[0].cpu().numpy().tobytes() == mp_decode_integer(st, rep, np.float32(2e-8), n).tobytes()
    assert bool((got < 0).any())


def test_corpus_encoder_kernels_equal_plain(device):
    cfg = make_test_config(num_select=4)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(9, cfg.block_size, seed=13)
    before = _launches()
    codec = CorpusEncoder(mld, device=device, batch_size=4)
    blob = codec.encode(xs)
    rows = codec.decode(blob)
    # three batches: one launch of each kernel per batch on the card, none
    # on the CPU (plain versions)
    n = 3 if device.type == "cuda" else 0
    assert _launches() == (before[0] + n, before[1] + n)
    plain = CorpusEncoder(mld, device=device, backend="torch", batch_size=4)
    assert plain.encode(xs) == blob
    assert plain.decode(blob).tobytes() == rows.tobytes()
