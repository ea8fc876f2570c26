"""The port's kernels against their plain PyTorch versions and the NumPy
oracle, on each device.

Every test runs twice: on the CPU, where the kernel wrappers take the plain
versions (so the plain versions meet the oracle on every geometry here), and
on the card, where they launch the CUDA kernels.  The card's cases need an
NVIDIA GPU and the CUDA toolkit (`nvcc`): they are marked `cuda` and skip on
a host without a card.  The oracle is the port's own copy
(`hsc_torch.oracle`); this file imports no JAX and nothing of the JAX
package, so it also runs on a machine that has neither:

    python -m pytest tests/test_torch_kernels.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
from hsc_torch.dictionary import bank_gram
from hsc_torch.io import unpack_corpus
from hsc_torch.oracle.mp import (
    LevelStream,
    balanced_digits,
    bank_quantize_int16,
    int8_init_scores,
    mp_decode,
    mp_decode_integer,
    mp_encode,
    rep_quantize,
)

from hsc_torch.ops import decode_integer_kernel, decode_kernel, init_kernels, mp_kernels
from hsc_torch.ops.decode import mp_decode_batch_torch, mp_decode_integer_batch_torch
from hsc_torch.ops.decode_kernel import TILE
from hsc_torch.ops.encode import (
    encode_init_batched,
    feature_map_int,
    int8_init_from_events_torch,
    mp_encode_from_init_torch,
    quantizer_steps,
)
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
    s0_kernel = init[0].clone()  # the kernel updates its scores in place
    got = mp_kernels.mp_loop(s0_kernel, *init[1:], params, **kw)
    ref = mp_encode_from_init_torch(*init, params, **kw)
    assert torch.equal(init[0], s0_before)  # the plain loop works on a copy
    assert torch.equal(s0_kernel, s0_before) == (device.type == "cpu")
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
    got = mp_kernels.mp_loop(s0.clone(), *init[1:], params, **kw)
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


def _loop_vs_plain_and_oracle(device, bank, n_raw, sw, s0, e0, amp_bits=16, **kw):
    """Run the loop kernel (on a copy of `s0`) and the plain loop on one
    init, hold them bitwise, and every block bitwise the oracle; returns
    the kernel's result on the host."""
    k, w = bank.shape[0], bank.shape[1]
    gram = bank_gram(bank)
    params = level_params_from_numpy(
        bank, np.ascontiguousarray(gram.transpose(1, 0, 2)), n_raw=n_raw,
        singleton_weight=sw, device=device,
    )
    s0 = torch.as_tensor(s0, dtype=torch.float32).to(device)
    e0 = torch.as_tensor(e0, dtype=torch.float32).to(device)
    scale, inv = quantizer_steps(s0.abs().amax(dim=(1, 2)).cpu().numpy(), amp_bits)
    init = (s0, e0, torch.from_numpy(scale).to(device), torch.from_numpy(inv).to(device))
    kw = dict(kw, amp_bits=amp_bits)
    got = mp_kernels.mp_loop(s0.clone(), *init[1:], params, **kw)
    ref = mp_encode_from_init_torch(*init, params, **kw)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    got = [a.cpu().numpy() for a in got]
    for b in range(s0.shape[0]):
        o = mp_encode(
            np.zeros((s0.shape[2] + w - 1, 1), np.float32), bank, gram,
            scores0=s0[b].cpu().numpy(), energy0=float(e0[b]), singleton_weight=sw,
            n_raw=n_raw, **kw,
        )
        n_ev = int(got[3][b])
        assert n_ev == o.positions.shape[0]
        for a, want in zip(got[:3], (o.positions, o.atoms, o.codes)):
            assert np.array_equal(a[b, :n_ev], want)
        assert got[6][b] == np.float32(o.energy_res)
    return got


def _peaked_scores(rng, k, npos, peaks, noise=0.01):
    """Small noise scores with `peaks` ``{position: value}`` on atom 1."""
    s0 = (rng.standard_normal((1, k, npos)) * noise).astype(np.float32)
    for t, v in peaks.items():
        s0[0, 1, t] = v
    return s0


# the sweep's edge cases: S candidates decided in one pass (guard, budget
# and SNR stop mid-sweep), S past the 32 lanes that take the candidates,
# npos not a multiple of 128, K above 64, and the flagship hierarchy's
# level-1 geometry
SWEEP_CASES = ["guard", "budget", "snr", "S1", "S3", "S8", "S16", "S32", "S48", "level1"]


@pytest.mark.parametrize("case", SWEEP_CASES)
def test_mp_kernel_sweep_edge_cases(device, case):
    rng = np.random.default_rng(SWEEP_CASES.index(case))
    if case in ("guard", "budget", "snr"):
        k, w, npos, ns = 6, 16, 8 * 128 - 40, 8
        bank = rng.standard_normal((k, w, 1)).astype(np.float32)
        bank /= np.linalg.norm(bank, axis=(1, 2), keepdims=True)
        if case == "guard":
            # segment 0's peak and segment 1's lie 3 apart (< 2W-1 = 31):
            # the guard rejects the second, and segment 2's comes next
            peaks = {125: 2.0, 128: 1.9, 300: 1.5, 700: 1.4}
            got = _loop_vs_plain_and_oracle(
                device, bank, k, 1.0, _peaked_scores(rng, k, npos, peaks), [50.0],
                num_coefs=40, num_select=ns,
            )
            assert list(got[0][0, :2]) == [125, 300]
        elif case == "budget":
            peaks = {64 + 128 * j: 1.0 + 0.1 * j for j in range(8)}
            got = _loop_vs_plain_and_oracle(
                device, bank, k, 1.0, _peaked_scores(rng, k, npos, peaks), [50.0],
                num_coefs=5, num_select=ns,
            )
            assert got[3][0] == 5 and list(got[0][0]) == [64 + 128 * j for j in range(5)]
        else:
            # e_res falls by ~s^2 = 2.25 per accept from 20: past the
            # threshold 20 * 10^(-tol/10) = 12 at the 4th of 8 candidates
            peaks = {64 + 128 * j: 1.5 for j in range(8)}
            got = _loop_vs_plain_and_oracle(
                device, bank, k, 1.0, _peaked_scores(rng, k, npos, peaks, noise=1e-4), [20.0],
                num_coefs=40, num_select=ns, tolerance_snr=float(-10 * np.log10(0.6)),
            )
            assert got[3][0] == 4
        return
    if case == "level1":
        k, w, n_raw, sw, n, nc, ns = 96, 65, 32, 0.9, 16353, 192, 8
    else:
        k, w, n_raw, sw, n, nc, ns = 80, 16, 48, 0.5, 3001, 300, int(case[1:])
    bank = rng.standard_normal((k, w, 1)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=(1, 2), keepdims=True)
    xs = rng.standard_normal((2, n)).astype(np.float32)
    s0, e0, _ = encode_init_batched(torch.from_numpy(xs[:, :, None]).to(device), torch.from_numpy(bank).to(device))
    npos = n - w + 1
    assert npos % 128 != 0
    got = _loop_vs_plain_and_oracle(device, bank, n_raw, sw, s0, e0, num_coefs=nc, num_select=ns)
    assert (got[3] > 0).all()


# seeds 6-11 of the random decode tests: the tiled decode kernels' edges (a
# tile is decode_kernel.TILE = 1024 samples, a staging chunk 512 events).
# (K, W, N, M, piled, counts): `piled` draws every position from 8 in one
# tile, so positions
# repeat and stream order decides the ordered decode's bits; counts "0M"
# gives one block no events and one all M
DECODE_EDGES = {
    6: (40, 33, 70001, 700, False, None),   # N > 65536, N % 4 != 0
    7: (5, 2500, 9002, 300, False, None),   # W wider than a tile
    8: (17, 64, 16384, 1500, True, None),   # one tile, M > chunk
    9: (96, 96, 20000, 3001, False, "0M"),  # count 0 and M, M > chunk, M % 4 != 0
    10: (3, 1, 65537, 2048, True, "0M"),    # W = 1, N > 65536, one tile
    11: (8, 2100, 70000, 600, True, None),  # wide events piled into one tile
}


def _edge_events(rng, seed, b):
    """An edge batch of `DECODE_EDGES`: (k, w, n, pos, atm, cds, cnt)."""
    k, w, n, m, piled, counts = DECODE_EDGES[seed]
    if piled:
        lo = min(TILE * int(rng.integers(0, n // TILE + 1)), n - w)
        hot = rng.integers(lo, min(lo + TILE, n - w + 1), size=8)
        pos = rng.choice(hot, size=(b, m))
    else:
        pos = rng.integers(0, n - w + 1, size=(b, m))
    atm = rng.integers(0, k, size=(b, m)).astype(np.int32)
    cds = rng.integers(-32767, 32768, size=(b, m)).astype(np.int32)
    cnt = rng.integers(0, m + 1, size=b).astype(np.int32)
    if counts == "0M":
        cnt[:2] = 0, m
    return k, w, n, pos.astype(np.int32), atm, cds, cnt


@pytest.mark.parametrize("seed", range(12))
def test_int_decode_kernel_random_events(device, seed):
    """Random table shape, block length and events (positions up to the
    last placement, full-range codes and reps, ragged counts); seeds 6-11
    draw the edges of `DECODE_EDGES`."""
    rng = np.random.default_rng(2000 + seed)
    b = 5
    if seed in DECODE_EDGES:
        k, w, n, pos, atm, cds, cnt = _edge_events(rng, seed, b)
        rep = rng.integers(-4095, 4096, size=(k, w, 1)).astype(np.int32)
    else:
        k, w = int(rng.integers(1, 97)), int(rng.integers(1, 65))
        n, m = int(rng.integers(w, 40000)), int(rng.integers(1, 700))
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


def test_corpus_encoder_large_block(device):
    """A 65536-sample block, past what the greedy loop's selection cache
    fits in shared memory (it then lives in a global workspace) and past the
    old integer decode's shared-memory ceiling: the single-level codec with
    backend 'cuda' gives the container and rows of backend 'torch', the rows
    are bitwise the oracle's integer decode, and on the card both kernels
    ran."""
    cfg = make_test_config(counts=(16,), scales=(32,), block_size=65536, num_coefs=(512,), num_select=8)
    assert cfg.decode_mode == "integer"
    mld = MultilevelDictionary.generate(cfg, seed=21)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(3, cfg.block_size, seed=23)
    if device.type == "cuda":
        from hsc_torch import _build

        assert _build.load().hsc_mp_encode_workspace(mld.num_atoms(0), cfg.num_positions(0), cfg.num_select) > 0
    before = _launches()
    codec = CorpusEncoder(mld, device=device)
    blob = codec.encode(xs)
    rows = codec.decode(blob)
    n = int(device.type == "cuda")
    assert _launches() == (before[0] + n, before[1] + n)
    plain = CorpusEncoder(mld, device=device, backend="torch")
    assert plain.encode(xs) == blob
    assert plain.decode(blob).tobytes() == rows.tobytes()
    hdr, blocks = unpack_corpus(blob)
    rep_q, step = rep_quantize(mld.representations(0)[:, :, None], hdr.rep_bits)
    for b, ((_, st),) in enumerate(blocks):
        assert st.positions.shape[0] > 0
        assert rows[b].tobytes() == mp_decode_integer(st, rep_q, step, cfg.block_size)[:, 0].tobytes()


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits, so that equality is bitwise (+0.0 != -0.0)."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("seed", range(12))
def test_sparse_init_kernel_random_geometry(device, seed):
    """Random raw-atom count, width (up to 129), channels, map length and
    event density (3000 events per block at seed 11), with duplicate cells,
    cells at the four-digit bound made by large event codes, events past
    `count`, at N - W < pos < N and off the map, and an all-zero block: the
    int8-init kernels' whole score buffer and peak bitwise the plain event
    route, e0 within 1e-6 of it, and block 0 bitwise
    `oracle.int8_init_scores`."""
    rng = np.random.default_rng(3000 + seed)
    n_raw, w, c = int(rng.integers(1, 34)), int(rng.integers(1, 130)), int(rng.integers(1, 17))
    n, b = int(rng.integers(w, 1200)), 3
    m = 3000 if seed == 11 else int(rng.integers(13, max(14, n * c // int(rng.choice([4, 40, 400])))))
    pos = rng.integers(0, n, size=(b, m)).astype(np.int32)
    atm = rng.integers(0, c, size=(b, m)).astype(np.int32)
    cds = rng.integers(-32767, 32768, size=(b, m)).astype(np.int32)
    pos[:, 1:4], atm[:, 1:4] = pos[:, :1], atm[:, :1]  # duplicate cells
    # three cells of block 0 hold the bound exactly: no other event adds to them
    bound = 2139062143
    cds[0, 4:7] = (bound, -bound, bound - 255)
    for j in range(4, 7):
        clash = (pos[0] == pos[0, j]) & (atm[0] == atm[0, j])
        clash[4:7] = False
        cds[0, clash] = 0
    pos[:, 7] = n - 1 - rng.integers(0, w, size=b)  # N - W < pos < N
    pos[:, 8], pos[:, 9], atm[:, 10], atm[:, 11] = -1, n, c, -1  # off the map
    cnt = np.array([m, rng.integers(12, m), 0], np.int32)  # past count; block 2 empty
    events = [torch.from_numpy(a).to(device) for a in (pos, atm, cds, cnt)]
    bq, step = bank_quantize_int16(rng.standard_normal((n_raw, w, c)).astype(np.float32))
    planes = torch.from_numpy(balanced_digits(bq, 2).astype(np.int8)).to(device)
    prev_scale = torch.from_numpy(rng.uniform(1e-6, 2.0, size=b).astype(np.float32)).to(device)

    before = init_kernels.LAUNCHES
    s0, e0, peak = init_kernels.int8_init(*events, prev_scale, planes, step, n_map=n)
    assert init_kernels.LAUNCHES == before + (device.type == "cuda")
    s0_p, e0_p, peak_p = int8_init_from_events_torch(*events, prev_scale, planes, step, n_map=n)
    assert s0.shape == (b, n_raw + c, n - w + 1)
    assert torch.equal(_bits(s0), _bits(s0_p)) and torch.equal(_bits(peak), _bits(peak_p))
    torch.testing.assert_close(e0, e0_p, rtol=1e-6, atol=0)
    assert float(peak[2]) == 0.0 and not s0[2].any() and float(e0[2]) == 0.0
    m_int = feature_map_int(*(torch.from_numpy(a) for a in (pos, atm, cds, cnt)), npos=n, k=c).numpy()
    assert {bound, -bound, bound - 255} <= set(m_int[0].ravel().tolist())
    want = int8_init_scores(m_int[0], bq, step, prev_scale[0].cpu().numpy())
    assert s0[0].cpu().numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", range(12))
def test_ordered_decode_kernel_random_events(device, seed):
    """Random bank shape (widths past a CTA's 256 threads included), block
    length and events piled onto few positions so adds overlap; seeds 6-11
    draw the edges of `DECODE_EDGES`: the kernel bitwise the plain version
    and `oracle.mp.mp_decode`."""
    rng = np.random.default_rng(4000 + seed)
    b = 4
    if seed in DECODE_EDGES:
        k, w, n, pos, atm, cds, cnt = _edge_events(rng, seed, b)
        bank = rng.standard_normal((k, w, 1)).astype(np.float32)
    else:
        k, w = int(rng.integers(1, 97)), int(rng.integers(1, 300))
        n, m = int(rng.integers(w, 20000)), int(rng.integers(1, 600))
        bank = rng.standard_normal((k, w, 1)).astype(np.float32)
        hot = rng.integers(0, n - w + 1, size=int(rng.integers(1, 40)))
        pos = rng.choice(hot, size=(b, m)).astype(np.int32)
        atm = rng.integers(0, k, size=(b, m)).astype(np.int32)
        cds = rng.integers(-32767, 32768, size=(b, m)).astype(np.int32)
        cnt = rng.integers(0, m + 1, size=b).astype(np.int32)
    scale = rng.uniform(1e-7, 1e-2, size=b).astype(np.float32)
    args = [torch.from_numpy(a).to(device) for a in (pos, atm, cds, cnt, scale, bank)]
    got = decode_kernel.mp_decode_batch(*args, n=n)
    assert torch.equal(got, mp_decode_batch_torch(*args, n=n))
    for j in range(b):
        st = LevelStream(pos[j, :cnt[j]], atm[j, :cnt[j]], cds[j, :cnt[j]], scale[j], 0.0, 0.0)
        assert got[j].cpu().numpy().tobytes() == mp_decode(st, bank, n).tobytes()


@pytest.mark.parametrize("mode", ["integer", "ordered"])
def test_hier_corpus_encoder_kernels_equal_plain(device, mode):
    """The 2-level codec (int8 level-1 init) with backend 'cuda' gives the
    container and rows of backend 'torch'; on the card each batch launches
    the greedy loop once per level and the sparse init once, and each
    decoded chunk launches its mode's decode kernel once."""
    cfg = make_test_config(counts=(12, 8), scales=(16, 48), num_coefs=(96, 48), block_size=1024,
                           num_select=4, decode_mode=mode)
    mld = MultilevelDictionary.generate(cfg, seed=11)
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(9, cfg.block_size, seed=17)
    counters = (mp_kernels, init_kernels, decode_integer_kernel, decode_kernel)
    before = [c.LAUNCHES for c in counters]
    codec = CorpusEncoder(mld, device=device, batch_size=4)
    blob = codec.encode(xs)
    rows = codec.decode(blob)
    on = device.type == "cuda"
    dec = (3, 0) if mode == "integer" else (0, 3)
    assert [c.LAUNCHES - x for c, x in zip(counters, before)] == [6 * on, 3 * on, dec[0] * on, dec[1] * on]
    plain = CorpusEncoder(mld, device=device, backend="torch", batch_size=4)
    assert plain.encode(xs) == blob
    assert plain.decode(blob).tobytes() == rows.tobytes()


@pytest.mark.parametrize("m", [8193, 16384, 20000, 65281])
def test_sparse_init_kernel_many_events(device, m):
    """Past the 8192 events per block that the cell kernel once sorted: up
    to 16384 it sorts in shared memory, past that in a global workspace
    (65281 is the most `CodecConfig` admits for hier_init='int8' at
    amp_bits=16).  Dense duplicate cells, events past `count` and off the
    map: the whole score buffer and the peak bitwise the plain event route,
    e0 within 1e-6 of it, and block 0 bitwise `oracle.int8_init_scores`."""
    rng = np.random.default_rng(m)
    b, n, c, n_raw, w = 2, 700, 9, 7, 21
    pos = rng.integers(0, n, size=(b, m)).astype(np.int32)
    atm = rng.integers(0, c, size=(b, m)).astype(np.int32)
    cds = rng.integers(-32767, 32768, size=(b, m)).astype(np.int32)
    pos[:, 3], pos[:, 4], atm[:, 5] = -1, n, c  # off the map
    cnt = np.array([m, m // 3], np.int32)
    events = [torch.from_numpy(a).to(device) for a in (pos, atm, cds, cnt)]
    bq, step = bank_quantize_int16(rng.standard_normal((n_raw, w, c)).astype(np.float32))
    planes = torch.from_numpy(balanced_digits(bq, 2).astype(np.int8)).to(device)
    prev_scale = torch.from_numpy(rng.uniform(1e-6, 1e-3, size=b).astype(np.float32)).to(device)
    if device.type == "cuda":
        from hsc_torch import _build

        # an H100's opt-in shared memory holds the sort of 16384 events (3 x
        # 16384 ints), not of 32768
        assert (_build.load().hsc_int8_init_workspace(m) > 0) == (m > 16384)
    before = init_kernels.LAUNCHES
    s0, e0, peak = init_kernels.int8_init(*events, prev_scale, planes, step, n_map=n)
    assert init_kernels.LAUNCHES == before + (device.type == "cuda")
    s0_p, e0_p, peak_p = int8_init_from_events_torch(*events, prev_scale, planes, step, n_map=n)
    assert torch.equal(_bits(s0), _bits(s0_p)) and torch.equal(_bits(peak), _bits(peak_p))
    torch.testing.assert_close(e0, e0_p, rtol=1e-6, atol=0)
    m_int = feature_map_int(*(torch.from_numpy(a) for a in (pos, atm, cds, cnt)), npos=n, k=c).numpy()
    want = int8_init_scores(m_int[0], bq, step, prev_scale[0].cpu().numpy())
    assert s0[0].cpu().numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("c", [2, 7, 64])
def test_ordered_decode_kernel_channels(device, c):
    """A bank of C > 1 channels (the level-space decode of a level >= 1):
    random bank shape, block length and events piled onto few positions,
    with an empty block, a ragged count and dead events (past the last
    placement, atoms out of range): the kernel bitwise the plain version,
    and the live blocks bitwise `oracle.mp.mp_decode`."""
    rng = np.random.default_rng(5000 + c)
    b = 4
    k, w = int(rng.integers(1, 40)), int(rng.integers(1, 80))
    n, m = int(rng.integers(w, 3000)), int(rng.integers(1, 200))
    bank = rng.standard_normal((k, w, c)).astype(np.float32)
    hot = rng.integers(0, n - w + 1, size=int(rng.integers(1, 30)))
    pos = rng.choice(hot, size=(b, m)).astype(np.int32)
    atm = rng.integers(0, k, size=(b, m)).astype(np.int32)
    cds = rng.integers(-32767, 32768, size=(b, m)).astype(np.int32)
    cnt = np.array([m, 0, rng.integers(0, m + 1), m], np.int32)
    pos[3, 0], atm[3, m // 2] = n - w + 1, k  # dead events in block 3
    scale = rng.uniform(1e-7, 1e-2, size=b).astype(np.float32)
    args = [torch.from_numpy(a).to(device) for a in (pos, atm, cds, cnt, scale, bank)]
    before = decode_kernel.LAUNCHES
    got = decode_kernel.mp_decode_batch(*args, n=n)
    assert decode_kernel.LAUNCHES == before + (device.type == "cuda")
    assert got.shape == (b, n, c)
    assert torch.equal(_bits(got), _bits(mp_decode_batch_torch(*args, n=n)))
    for j in range(3):
        st = LevelStream(pos[j, :cnt[j]], atm[j, :cnt[j]], cds[j, :cnt[j]], scale[j], 0.0, 0.0)
        assert got[j].cpu().numpy().tobytes() == mp_decode(st, bank, n).tobytes()


def test_overlap_add_on_device(device):
    """The online learner's `_OverlapAdd`: its forward is the ordered decode
    (the kernel on the card, one launch) bitwise the plain version, and its
    backward gives the same bank gradient bitwise in two calls, within
    float32 rounding (1e-5) of the CPU's."""
    from hsc_torch.learn.online import _OverlapAdd

    rng = np.random.default_rng(61)
    b, m, k, w, n = 4, 300, 9, 24, 2000
    pos = rng.integers(0, n - w + 1, (b, m)).astype(np.int32)
    pos[0, :40] = 77
    atm = rng.integers(0, k, (b, m)).astype(np.int32)
    cds = rng.integers(-32767, 32768, (b, m)).astype(np.int32)
    cnt = np.array([m, 0, m // 3, m], np.int32)
    scale = rng.uniform(1e-6, 1e-3, b).astype(np.float32)
    bank_np = rng.standard_normal((k, w, 1)).astype(np.float32)
    g_np = rng.standard_normal((b, n, 1)).astype(np.float32)
    events = [torch.from_numpy(a).to(device) for a in (pos, atm, cds, cnt, scale)]
    bank = torch.from_numpy(bank_np).to(device).requires_grad_(True)
    g = torch.from_numpy(g_np).to(device)
    before = decode_kernel.LAUNCHES
    out = _OverlapAdd.apply(bank, *events, n)
    assert decode_kernel.LAUNCHES == before + (device.type == "cuda")
    assert torch.equal(_bits(out.detach()), _bits(mp_decode_batch_torch(*events, bank.detach(), n=n)))
    grads = [torch.autograd.grad(_OverlapAdd.apply(bank, *events, n), bank, g)[0] for _ in range(2)]
    assert torch.equal(_bits(grads[0]), _bits(grads[1]))
    cpu_bank = torch.from_numpy(bank_np).requires_grad_(True)
    (want,) = torch.autograd.grad(
        _OverlapAdd.apply(cpu_bank, *(t.cpu() for t in events), n), cpu_bank, torch.from_numpy(g_np))
    torch.testing.assert_close(grads[0].cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fixture", ["reseed", "planted"])
def test_kmeans_refine_on_device(device, fixture):
    """`kmeans_refine_device` on the device within 1e-5 of the CPU's
    centroids and 1e-5 relative of its objectives: a silent window and a
    centroid that dies at once, and windows planted around 12 atoms."""
    from hsc_torch.learn import kmeans_refine_device

    rng = np.random.default_rng(4)
    if fixture == "reseed":
        flat = rng.standard_normal((256, 16)).astype(np.float32)
        flat[17] = 0
        cents0 = rng.standard_normal((6, 16)).astype(np.float32)
        cents0[3] = 0
    else:
        atoms = rng.standard_normal((12, 40)).astype(np.float32)
        flat = (atoms[rng.integers(0, 12, 3000)] * rng.choice([-1.0, 1.0], (3000, 1))
                + 0.05 * rng.standard_normal((3000, 40))).astype(np.float32)
        cents0 = flat[:12].copy()
    cents0 /= np.maximum(np.linalg.norm(cents0, axis=1, keepdims=True), 1e-8)
    got_c, got_o = kmeans_refine_device(torch.from_numpy(flat).to(device), torch.from_numpy(cents0).to(device),
                                        iterations=8)
    assert got_c.device.type == device.type and got_o.shape == (8,)
    want_c, want_o = kmeans_refine_device(torch.from_numpy(flat), torch.from_numpy(cents0), iterations=8)
    torch.testing.assert_close(got_c.cpu(), want_c, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_o.cpu(), want_o, rtol=1e-5, atol=0)


def test_online_step_on_device(device, monkeypatch):
    """`OnlineConvolutionalDictionaryLearner.step` on the device within 1e-4
    of the CPU's loss (relative) and bank.  The level-0 init of both is
    computed on the CPU, so both encode the same events (the loop is
    bitwise given its init); the rest — the loop, the kernel forward, the
    gradient product, Adam — runs on the device."""
    import hsc_torch.models.coder
    from hsc_torch.learn import OnlineConvolutionalDictionaryLearner

    def cpu_init(xb, bank):
        return tuple(t.to(xb.device) for t in encode_init_batched(xb.cpu(), bank.cpu()))

    monkeypatch.setattr(hsc_torch.models.coder, "encode_init_batched", cpu_init)
    cfg = make_test_config(counts=(8,), scales=(12,), num_coefs=(48,), block_size=512)
    mld = MultilevelDictionary.generate(cfg, seed=3)
    xs = SignalGenerator(mld, rates=2e-2, amplitude_range=(0.8, 1.2)).generate_signals(8, 512, seed=11)
    bank0 = np.random.default_rng(0).standard_normal((8, 12, 1)).astype(np.float32)
    bank0 /= np.linalg.norm(bank0.reshape(8, -1), axis=1)[:, None, None]
    learners = [OnlineConvolutionalDictionaryLearner(bank0, num_coefs=48, learning_rate=1e-2, device=dev)
                for dev in (device, "cpu")]
    for _ in range(2):
        before = mp_kernels.LAUNCHES, decode_kernel.LAUNCHES
        got, want = (lr.step(xs) for lr in learners)
        if device.type == "cuda":
            assert mp_kernels.LAUNCHES > before[0] and decode_kernel.LAUNCHES > before[1]
        assert abs(got - want) <= 1e-4 * abs(want)
        torch.testing.assert_close(learners[0].bank.detach().cpu(), learners[1].bank.detach(), rtol=0, atol=1e-4)


def _repeated_mesh(device, axis: str, n: int):
    """A mesh of `n` shards on one device (the card's first, or the CPU)."""
    from hsc_torch.parallel import make_mesh

    return make_mesh({axis: n}, devices=["cuda:0" if device.type == "cuda" else "cpu"] * n)


@pytest.mark.parametrize("mode", ["integer", "ordered"])
def test_mesh_codec_equals_local(device, mode):
    """The 2-level codec on a 4-shard mesh of one device (2 blocks a shard;
    9 blocks, so the last super-batch pads): the container and rows of the
    local batch-2 path, byte for byte; on the card every shard of every
    level launches the greedy loop, the int8 level launches the int8 init,
    and the sharded decode its mode's decode kernel."""
    cfg = make_test_config(counts=(12, 8), scales=(16, 48), num_coefs=(96, 48), block_size=1024,
                           num_select=4, decode_mode=mode)
    mld = MultilevelDictionary.generate(cfg, seed=11)
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(9, cfg.block_size, seed=19)
    local = CorpusEncoder(mld, device=device, batch_size=2)
    blob = local.encode(xs)
    rows = local.decode(blob)
    counters = (mp_kernels, init_kernels, decode_integer_kernel, decode_kernel)
    before = [c.LAUNCHES for c in counters]
    sharded = CorpusEncoder(mld, device=device, batch_size=2, mesh=_repeated_mesh(device, "data", 4))
    assert sharded.encode(xs) == blob
    assert sharded.decode(blob).tobytes() == rows.tobytes()
    on = device.type == "cuda"
    got = [c.LAUNCHES - x for c, x in zip(counters, before)]
    # 2 super-batches x 4 shards: 16 loops (both levels), 8 int8 inits; the
    # decode's 5 chunks of 2 blocks x 4 shards
    assert got == [16 * on, 8 * on, 20 * on * (mode == "integer"), 20 * on * (mode == "ordered")], got


@pytest.mark.parametrize("mode", ["sp", "tp"])
@pytest.mark.parametrize("num_select,tol", [(1, None), (4, None), (1, 6.0)])
def test_sharded_loop_equals_local_kernel_loop(device, mode, num_select, tol):
    """`sp_loop` on 4 'seq' shards and `tp_loop` on 4 'model' shards of one
    device, given the local init of one block, emit the local greedy loop's
    stream bit for bit (on the card: the CUDA kernel's)."""
    from hsc_torch.parallel.sp import sp_loop, sp_shard_scores
    from hsc_torch.parallel.tp import tp_loop, tp_shard_scores

    cfg = make_test_config(num_select=num_select, tolerance_snr=tol)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs, params, (s0, e0, scale, inv) = _init(mld, 2, 61, device)
    kw = dict(num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, num_select=num_select, tolerance_snr=tol)
    b = 1  # block 0 is all zero
    want = mp_kernels.mp_loop(s0[b : b + 1].clone(), e0[b : b + 1], scale[b : b + 1], inv[b : b + 1], params, **kw)
    sc, iv = scale[b].cpu().numpy(), inv[b].cpu().numpy()
    if mode == "sp":
        mesh = _repeated_mesh(device, "seq", 4)
        got = sp_loop(mesh, sp_shard_scores(mesh, s0[b], cfg.block_size), e0[b], sc, iv, params.gram_t, **kw)
    else:
        mesh = _repeated_mesh(device, "model", 4)
        gram = torch.from_numpy(mld.gram(0)).to(device)
        got = tp_loop(mesh, tp_shard_scores(mesh, s0[b]), e0[b], sc, iv, gram, **kw)
    assert got.positions.device.type == device.type
    n = int(want.count[0])
    assert int(got.count) == n > 0
    for f in ("positions", "atoms", "codes"):
        assert torch.equal(getattr(got, f)[:n], getattr(want, f)[0, :n]), f
    assert got.scale.item() == scale[b].item() and got.energy_res.item() == want.energy_res[0].item()


def test_init_is_batch_invariant(device):
    """A block's level-0 init (scores, e0 and peak) is the same bits in a
    batch of 33, 16, 5 or 1 blocks: a mesh shard's batch is not the local
    path's where a corpus is ragged.  e0 is `block_energy`'s fixed pairwise
    tree, equal to the same tree summed in NumPy float32 (a reduction
    kernel's order on the card depends on the batch)."""
    from hsc_torch.ops.encode import block_energy

    cfg = make_test_config(counts=(64,), scales=(32,), block_size=16384)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(33, cfg.block_size, seed=3)
    bank = level_params_from_mld(mld, 0, device).bank
    x = torch.from_numpy(xs[:, :, None]).to(device)
    want = encode_init_batched(x, bank)
    for bs in (16, 5, 1):
        parts = [encode_init_batched(x[i : i + bs], bank) for i in range(0, 33, bs)]
        for j in range(3):
            got = torch.cat([p[j] for p in parts])
            assert torch.equal(got.view(torch.int32), want[j].view(torch.int32)), (bs, j)
    tree = np.square(xs[:3].reshape(3, -1)).astype(np.float32)
    while tree.shape[1] > 1:
        m, h = tree.shape[1], tree.shape[1] // 2
        half = tree[:, :h] + tree[:, h : 2 * h]
        if m % 2:
            half[:, 0] += tree[:, m - 1]
        tree = half
    assert block_energy(x[:3]).cpu().numpy().tobytes() == tree[:, 0].tobytes()


def test_tf32_flags_change_no_output(device):
    """The caller's TF32 flags (`cudnn.conv.fp32_precision = 'tf32'` and
    `torch.set_float32_matmul_precision('high')`, set after the codec is
    built) move neither the container bytes of a fresh encode, nor the init
    correlation of a 64-channel map (cuDNN takes TF32 there; it takes none
    for the single-channel level-0 conv), nor k-means' centroids, and read
    what the caller set afterwards: the init conv and the k-means products
    run under `device.spec_numerics`.  On the CPU the TF32 flags act on
    nothing; tests/test_torch_numerics.py flips the oneDNN ones there."""
    from hsc_torch.learn import kmeans_refine_device
    from hsc_torch.ops.correlate import correlate_bank_torch

    b = torch.backends
    cfg = make_test_config(counts=(16,), scales=(32,), block_size=2048, num_coefs=(64,), num_select=4)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs = SignalGenerator(mld, rates=2e-2).generate_signals(8, cfg.block_size, seed=3)
    rng = np.random.default_rng(4)
    flat = torch.from_numpy(rng.standard_normal((4096, 32)).astype(np.float32)).to(device)
    cents0 = flat[:16] / torch.linalg.vector_norm(flat[:16], dim=1, keepdim=True)

    fmap = torch.from_numpy(rng.standard_normal((2, 1024, 64)).astype(np.float32)).to(device)
    fbank = torch.from_numpy(rng.standard_normal((24, 65, 64)).astype(np.float32)).to(device)

    def run(codec):
        return (codec.encode(xs), correlate_bank_torch(fmap, fbank).cpu(),
                kmeans_refine_device(flat, cents0, iterations=5)[0].cpu())

    codec = CorpusEncoder(mld, device=device)
    want_blob, want_s, want_c = run(codec)
    legacy, conv = torch.get_float32_matmul_precision(), b.cudnn.conv.fp32_precision
    try:
        b.cudnn.conv.fp32_precision = "tf32"
        torch.set_float32_matmul_precision("high")
        flags = (b.cudnn.conv.fp32_precision, b.cuda.matmul.fp32_precision, b.mkldnn.matmul.fp32_precision)
        for c in (codec, CorpusEncoder(mld, device=device)):
            blob, scores, cents = run(c)
            assert blob == want_blob
            assert torch.equal(scores, want_s)
            assert torch.equal(cents, want_c)
            assert (b.cudnn.conv.fp32_precision, b.cuda.matmul.fp32_precision,
                    b.mkldnn.matmul.fp32_precision) == flags == ("tf32", "tf32", "tf32")
    finally:
        torch.set_float32_matmul_precision(legacy)
        b.cudnn.conv.fp32_precision = conv
