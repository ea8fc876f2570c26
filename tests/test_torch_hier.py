"""The port's hierarchy (`hsc_torch`) against the JAX package on the CPU: the
level hand-off maps, the int8 level >= 1 init, the multi-level coder, the
level pipeline and the multi-level corpus codec.

The hand-off and the int8 init are integer arithmetic plus a fixed f32
recombination, so they are held bitwise with no injection (e0 aside: it is
an f32 reduction in the backend's order).  Only the level-0 init — and,
under hier_init='f32', every level's init — is injected from JAX, as for
the single-level codec (README "Determinism contract")."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hsc_tpu import CodecConfig, MultilevelDictionary, SignalGenerator, make_test_config
from hsc_tpu.models.coder import HierarchicalConvolutionalSparseCoder as JaxCoder
from hsc_tpu.ops.encode import (
    EncodedBlock as JaxEncodedBlock,
    encode_init_int_batched as jax_init_int,
    encode_init_int_raw,
    feature_map_int_jax,
    feature_map_jax,
)
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.ops.init_kernels import (
    aggregate_codes,
    build_bank_rev,
    sparse_init_raw_pallas,
    sparse_init_supported,
)
from hsc_tpu.io import unpack_corpus
from hsc_tpu.oracle import hierarchical_decode
from hsc_tpu.oracle.mp import (
    LevelStream,
    balanced_digits,
    bank_quantize_int16,
    feature_map_int_from_events,
    int8_init_scores,
    mp_decode_integer,
    rep_quantize,
    to_distributed,
)
from hsc_tpu.runtime import CorpusEncoder as JaxCorpusEncoder

import hsc_torch.models.coder
import hsc_torch.ops.pipeline
from hsc_torch.models import HierarchicalConvolutionalSparseCoder
from hsc_torch.ops.encode import (
    EncodedBlock,
    encode_init_int_batched,
    encode_init_int_raw_torch,
    feature_map,
    feature_map_int,
    int8_init_from_events_torch,
)
from hsc_torch.ops.pipeline import encode_batches_pipelined, encode_hierarchical_batches_pipelined
from hsc_torch.params import dictionary_from_arrays, level_params_from_mld, level_params_from_numpy
from hsc_torch.runtime import CorpusEncoder
from pinned import oracle_hierarchical_pinned

# the 3-level geometry of tests/test_three_level.py
CFG3 = CodecConfig(counts=(10, 6, 4), scales=(12, 36, 90), num_coefs=(96, 48, 24), block_size=1024)


def _port(mld):
    """The port's copy of a JAX package dictionary."""
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


def _inject_jax_init(monkeypatch, module):
    """Make `module` call JAX's f32 init where it looks up
    `encode_init_batched` (level 0, and every level under hier_init='f32')."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(module, "encode_init_batched", init)


def _signals(mld, n, seed):
    cfg = mld.config
    rates = [np.full(c, 4e-3 / (1 + 2 * k)) for k, c in enumerate(cfg.counts)]
    xs = SignalGenerator(mld, rates=rates).generate_signals(n, cfg.block_size, seed=seed)
    xs[1] = 0.0  # an all-zero block emits nothing at any level
    return xs


def _random_events(rng, b, m, npos, k):
    """Padded event buffers with duplicate cells in every block's prefix."""
    count = rng.integers(m // 2, m + 1, size=b).astype(np.int32)
    positions = rng.integers(0, npos, size=(b, m)).astype(np.int32)
    atoms = rng.integers(0, k, size=(b, m)).astype(np.int32)
    codes = rng.integers(-32767, 32768, size=(b, m)).astype(np.int32)
    positions[:, 1:4] = positions[:, :1]
    atoms[:, 1:4] = atoms[:, :1]
    count[:] = np.maximum(count, min(m, 4))
    return positions, atoms, codes, count


def _stream(positions, atoms, codes, count, j, scale=1.0):
    n = int(count[j])
    return LevelStream(positions[j, :n], atoms[j, :n], codes[j, :n], np.float32(scale), 0.0, 0.0)


# ---- the hand-off ----------------------------------------------------------


@pytest.mark.parametrize("seed,b,m,npos,k", [(0, 3, 40, 60, 7), (1, 2, 300, 500, 20), (2, 4, 1, 9, 1)])
def test_feature_map_int_bitwise(seed, b, m, npos, k):
    """`feature_map_int` / `feature_map` == the JAX hand-offs == the oracle,
    duplicate cells included."""
    rng = np.random.default_rng(seed)
    pos, atm, cds, cnt = _random_events(rng, b, m, npos, k)
    scale = rng.uniform(1e-4, 1.0, size=b).astype(np.float32)
    t = [torch.from_numpy(a) for a in (pos, atm, cds, cnt)]
    got = feature_map_int(*t, npos=npos, k=k).numpy()
    got_f = feature_map(EncodedBlock(*t, torch.from_numpy(scale), None, None), npos=npos, k=k).numpy()
    assert got.dtype == np.int32 and got.shape == (b, npos, k)
    for j in range(b):
        enc = JaxEncodedBlock(
            jnp.asarray(pos[j]), jnp.asarray(atm[j]), jnp.asarray(cds[j]), jnp.int32(cnt[j]),
            jnp.float32(scale[j]), jnp.float32(0), jnp.float32(0),
        )
        assert np.array_equal(got[j], np.asarray(feature_map_int_jax(enc, npos=npos, k=k)))
        assert got_f[j].tobytes() == np.asarray(feature_map_jax(enc, npos=npos, k=k)).tobytes()
        assert np.array_equal(got[j], feature_map_int_from_events(_stream(pos, atm, cds, cnt, j), npos, k))


def test_feature_map_int_wraps_past_2_31():
    """70000 maximal codes on one cell sum past 2^31 and wrap mod 2^32, as
    in the JAX hand-off and the oracle; events past `count` add nothing."""
    m, npos, k = 70000, 50, 5
    pos = np.full((2, m), 7, np.int32)
    atm = np.full((2, m), 3, np.int32)
    cds = np.full((2, m), 32767, np.int32)
    cds[1] = -32767
    cnt = np.array([m, m - 100], np.int32)
    got = feature_map_int(*(torch.from_numpy(a) for a in (pos, atm, cds, cnt)), npos=npos, k=k).numpy()
    for j in range(2):
        want = feature_map_int_from_events(_stream(pos, atm, cds, cnt, j), npos, k)
        assert np.array_equal(got[j], want)
        enc = JaxEncodedBlock(
            jnp.asarray(pos[j]), jnp.asarray(atm[j]), jnp.asarray(cds[j]), jnp.int32(cnt[j]),
            jnp.float32(1), jnp.float32(0), jnp.float32(0),
        )
        assert np.array_equal(got[j], np.asarray(feature_map_int_jax(enc, npos=npos, k=k)))
    assert got[0, 7, 3] < 0 and got[1, 7, 3] > 0  # both wrapped
    assert np.count_nonzero(got) == 2


# ---- the int8 init ---------------------------------------------------------

INIT_GEOMETRIES = [
    # (seed, n_raw, w, c, n, m)
    (0, 6, 7, 12, 501, 40),      # the 2-level test config's level 1
    (1, 3, 2, 4, 130, 16),       # minimal window
    (2, 16, 32, 17, 1000, 96),   # flagship-like level 1, scaled down
    (3, 9, 128, 5, 700, 32),     # the Pallas kernel's widest window
    (4, 1, 5, 2, 64, 8),         # one raw atom
]


@pytest.mark.parametrize("seed,n_raw,w,c,n,m", INIT_GEOMETRIES)
def test_int8_init_plain_bitwise(seed, n_raw, w, c, n, m):
    """The plain int8 init: raw rows and peak bitwise the dense XLA
    producer and the Pallas kernel (interpret mode); the whole score buffer
    bitwise `oracle.int8_init_scores`; e0 within 1e-6 of JAX's."""
    rng = np.random.default_rng(seed)
    positions, atoms, codes, count = _random_events(rng, 2, m, n, c)
    m_int = feature_map_int(*(torch.from_numpy(a) for a in (positions, atoms, codes, count)), npos=n, k=c)
    m_np = m_int.numpy()
    bank = rng.standard_normal((n_raw, w, c)).astype(np.float32)
    bq, step = bank_quantize_int16(bank)
    planes = balanced_digits(bq, 2).astype(np.int8)
    prev_scale = rng.uniform(1e-5, 2.0, size=2).astype(np.float32)
    npos = n - w + 1

    raw, peak_raw = encode_init_int_raw_torch(m_int, torch.from_numpy(prev_scale), torch.from_numpy(planes), step)
    raw_j, peak_j = encode_init_int_raw(
        jnp.asarray(m_np), jnp.asarray(prev_scale), jnp.asarray(planes), jnp.float32(step)
    )
    assert raw.numpy().tobytes() == np.asarray(raw_j).tobytes()
    assert peak_raw.numpy().tobytes() == np.asarray(peak_j).tobytes()
    assert sparse_init_supported(n_raw, w, c, npos)
    agg = aggregate_codes(*(jnp.asarray(a) for a in (positions, atoms, codes, count)), c_in=c)
    raw_k, peak_k = sparse_init_raw_pallas(
        jnp.asarray(positions), jnp.asarray(atoms), agg,
        jnp.asarray(prev_scale) * jnp.float32(step), jnp.asarray(build_bank_rev(planes)),
        npos=npos, n_raw=n_raw, interpret=True,
    )
    assert raw.numpy().tobytes() == np.asarray(raw_k[:, :n_raw, :npos]).tobytes()
    assert peak_raw.numpy().tobytes() == np.asarray(peak_k).tobytes()

    s0, e0, peak = encode_init_int_batched(m_int, torch.from_numpy(prev_scale), torch.from_numpy(planes), step)
    s0_j, e0_j, peak_jj = jax_init_int(
        jnp.asarray(m_np), jnp.asarray(prev_scale), jnp.asarray(planes), jnp.float32(step)
    )
    assert s0.numpy().tobytes() == np.asarray(s0_j).tobytes()
    assert peak.numpy().tobytes() == np.asarray(peak_jj).tobytes()
    np.testing.assert_allclose(e0.numpy(), np.asarray(e0_j), rtol=1e-6)
    for j in range(2):
        want = int8_init_scores(m_np[j], bq, step, prev_scale[j])
        assert s0[j].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("seed,n_raw,w,c,n,m", INIT_GEOMETRIES)
def test_int8_init_from_events_bitwise_jax(seed, n_raw, w, c, n, m):
    """The event route (`int8_init_from_events_torch`: what the CPU runs,
    and what the int8-init kernels are held to on the card) with events past
    `count`, at N - W < pos < N and off the map: the score buffer and the
    peak bitwise JAX's hand-off and int8 init (`feature_map_int_jax`,
    `encode_init_int_batched`), the raw rows bitwise the Pallas kernel
    (interpret mode) on `aggregate_codes` of the events the map takes, e0
    within 1e-6."""
    rng = np.random.default_rng(100 + seed)
    positions, atoms, codes, count = _random_events(rng, 2, m, n, c)
    count[:] = (m, m - 2)
    positions[0, 4] = n - 1  # past the last score position
    positions[1, 5], atoms[0, 6], atoms[1, 7] = -3, c, -1  # off the map
    bank = rng.standard_normal((n_raw, w, c)).astype(np.float32)
    bq, step = bank_quantize_int16(bank)
    planes = balanced_digits(bq, 2).astype(np.int8)
    prev_scale = rng.uniform(1e-5, 2.0, size=2).astype(np.float32)
    npos = n - w + 1

    t = [torch.from_numpy(a) for a in (positions, atoms, codes, count, prev_scale, planes)]
    s0, e0, peak = int8_init_from_events_torch(*t, step, n_map=n)
    m_j = jnp.stack([
        feature_map_int_jax(
            JaxEncodedBlock(jnp.asarray(positions[j]), jnp.asarray(atoms[j]), jnp.asarray(codes[j]),
                            jnp.int32(count[j]), jnp.float32(0), jnp.float32(0), jnp.float32(0)),
            npos=n, k=c,
        )
        for j in range(2)
    ])
    s0_j, e0_j, peak_j = jax_init_int(m_j, jnp.asarray(prev_scale), jnp.asarray(planes), jnp.float32(step))
    assert s0.numpy().tobytes() == np.asarray(s0_j).tobytes()
    assert peak.numpy().tobytes() == np.asarray(peak_j).tobytes()
    np.testing.assert_allclose(e0.numpy(), np.asarray(e0_j), rtol=1e-6)
    # the Pallas kernel takes only events on the map: compact them per block
    live = (np.arange(m)[None, :] < count[:, None]) & (positions >= 0) & (positions < n)
    live &= (atoms >= 0) & (atoms < c)
    packed = [np.zeros((2, m), np.int32) for _ in range(3)]
    for j in range(2):
        for dst, src in zip(packed, (positions, atoms, codes)):
            dst[j, : live[j].sum()] = src[j, live[j]]
    pk_pos, pk_atm, pk_cds = (jnp.asarray(a) for a in packed)
    agg = aggregate_codes(pk_pos, pk_atm, pk_cds, jnp.asarray(live.sum(1).astype(np.int32)), c_in=c)
    raw_k, _ = sparse_init_raw_pallas(
        pk_pos, pk_atm, agg, jnp.asarray(prev_scale) * jnp.float32(step),
        jnp.asarray(build_bank_rev(planes)), npos=npos, n_raw=n_raw, interpret=True,
    )
    assert s0[:, :n_raw].numpy().tobytes() == np.asarray(raw_k[:, :n_raw, :npos]).tobytes()


def test_int8_init_digit_bound_and_zero_block():
    """Cells at ±FMAP4_DIGIT_BOUND (every digit extreme) and an all-zero
    block: bitwise the oracle and the XLA producer."""
    rng = np.random.default_rng(7)
    n, c, n_raw, w = 90, 3, 4, 9
    m_np = np.zeros((2, n, c), np.int32)
    m_np[0, 5, 0], m_np[0, 5, 1], m_np[0, 40, 2] = 2139062143, -2139062143, -2139062143
    m_np[0, 41, 2], m_np[0, 80:, 1] = 2139062143, rng.integers(-2**31 + 1, 2**31 - 1, 10) // 2
    bq, step = bank_quantize_int16(rng.standard_normal((n_raw, w, c)).astype(np.float32))
    planes = balanced_digits(bq, 2).astype(np.int8)
    prev_scale = np.array([1e-6, 0.5], np.float32)
    s0, _, peak = encode_init_int_batched(
        torch.from_numpy(m_np), torch.from_numpy(prev_scale), torch.from_numpy(planes), step
    )
    s0_j, _, peak_j = jax_init_int(jnp.asarray(m_np), jnp.asarray(prev_scale), jnp.asarray(planes), jnp.float32(step))
    assert s0.numpy().tobytes() == np.asarray(s0_j).tobytes()
    assert peak.numpy().tobytes() == np.asarray(peak_j).tobytes()
    for j in range(2):
        assert s0[j].numpy().tobytes() == int8_init_scores(m_np[j], bq, step, prev_scale[j]).tobytes()
    assert float(peak[1]) == 0.0 and not s0[1].any()


# ---- the coder -------------------------------------------------------------


def _level_fields_equal(got, want, exact_energy: bool):
    for f in ("positions", "atoms", "codes"):
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    assert np.float32(got.scale) == np.float32(want.scale)
    if exact_energy:
        assert np.float32(got.energy0) == np.float32(want.energy0)
    else:
        np.testing.assert_allclose(got.energy0, want.energy0, rtol=1e-6)


@pytest.mark.parametrize("ns", [1, 4])
def test_hier_coder_matches_jax_and_pinned_oracle(monkeypatch, mld2, ns):
    """2-level `encode_batch` (int8 level-1 init, only level 0's init
    injected) equals the JAX coder per level and the pinned oracle; the
    top streams decode to the JAX coder's rows in both modes."""
    cfg = dataclasses.replace(mld2.config, num_select=ns)
    mld = MultilevelDictionary.generate(cfg, seed=11)
    assert cfg.hier_init == "int8"
    xs = _signals(mld, 4, seed=31)
    jc = JaxCoder(mld, backend="jax")
    ref = jc.encode_batch(xs)
    _inject_jax_init(monkeypatch, hsc_torch.models.coder)
    tc = HierarchicalConvolutionalSparseCoder(_port(mld), device="cpu")
    got = tc.encode_batch(xs)
    for b in range(4):
        pinned = oracle_hierarchical_pinned(xs[b], mld)
        for level in range(2):
            _level_fields_equal(got[b][level], ref[b][level], exact_energy=level == 0)
            _level_fields_equal(got[b][level], pinned[level], exact_energy=level == 0)
    assert all(s.positions.shape[0] == 0 for s in got[1])
    assert sum(s.positions.shape[0] for s in got[0]) > 0
    top = [s[1] for s in got]
    for mode in ("integer", "ordered"):
        assert tc.reconstruct_batch(top, mode=mode).tobytes() == jc.reconstruct_batch(top, mode=mode).tobytes()


def test_hier_coder_f32_hier_init(monkeypatch, mld2):
    """hier_init='f32': the f32 hand-off and the multichannel f32 init at
    level 1 (injected from JAX there too) give the pinned oracle's streams.
    They are held to the oracle, the spec: at this seed JAX's XLA loop
    emits code 9759 where the oracle and the port emit 9760 (level 0,
    block 0, event 40; ROADMAP Queue 3)."""
    cfg = dataclasses.replace(mld2.config, hier_init="f32")
    mld = MultilevelDictionary.generate(cfg, seed=11)
    xs = _signals(mld, 3, seed=33)
    _inject_jax_init(monkeypatch, hsc_torch.models.coder)
    tc = HierarchicalConvolutionalSparseCoder(_port(mld), device="cpu")
    assert not tc.coders[1].mp.int8_init
    got = tc.encode_batch(xs)
    for b in range(3):
        pinned = oracle_hierarchical_pinned(xs[b], mld)
        for level in range(2):
            _level_fields_equal(got[b][level], pinned[level], exact_energy=True)


def test_three_level_coder_matches_jax(monkeypatch):
    mld = MultilevelDictionary.generate(CFG3, seed=17)
    xs = _signals(mld, 2, seed=19)
    jc = JaxCoder(mld, backend="jax")
    ref = jc.encode_batch(xs)
    _inject_jax_init(monkeypatch, hsc_torch.models.coder)
    tc = HierarchicalConvolutionalSparseCoder(_port(mld), device="cpu")
    got = tc.encode_batch(xs)
    for b in range(2):
        for level in range(3):
            _level_fields_equal(got[b][level], ref[b][level], exact_energy=level == 0)
    top = [s[2] for s in got]
    for mode in ("integer", "ordered"):
        assert tc.reconstruct_batch(top, mode=mode).tobytes() == jc.reconstruct_batch(top, mode=mode).tobytes()


def test_level_params_int8_tables_from_jax_arrays(mld2):
    """`level_params_from_numpy` on a JAX coder's own int8 planes, step and
    representation bank equals `level_params_from_mld`."""
    cfg = mld2.config
    jc = JaxCoder(mld2, backend="jax")
    mp = jc.coders[1].mp
    a = level_params_from_numpy(
        np.asarray(mp.bank), np.asarray(mp.gram_t), bank_planes=np.asarray(mp.bank_planes),
        bank_step=np.asarray(mp.bank_step), rep_bank=np.asarray(jc._rep_banks[1]),
        n_raw=cfg.counts[1], singleton_weight=cfg.singleton_weight, device="cpu",
    )
    b = level_params_from_mld(_port(mld2), 1, "cpu")
    for f in ("bank", "gram_t", "weights", "bank_planes", "rep_bank"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), f
    assert a.bank_planes.dtype == torch.int8 and a.bank_planes.shape == (cfg.counts[1], 33, 12, 2)
    assert a.bank_step == b.bank_step and a.bank_step.dtype == np.float32
    assert level_params_from_mld(_port(mld2), 0, "cpu").bank_planes is None


# ---- the level pipeline ----------------------------------------------------


@pytest.mark.parametrize(
    "window,levels",
    [(1, 2), (2, 2), (4, 2), (1, 1), (2, 1), (None, 1)],
    ids=["1", "2", "4", "flat-1", "flat-2", "flat-None"],
)
def test_pipeline_equals_serial(mld2, window, levels):
    """The level-pipelined encode (levels 2) gives every level's streams
    bitwise as the serial per-batch encode, whatever the window; so does
    the single-level pipeline (levels 1, `encode_batches_pipelined` on
    level 0, window None = every batch's init dispatched first) against
    the serial `compute_coefficients_batch`."""
    xs = _signals(mld2, 7, seed=37)
    batches = [xs[i : i + 2][:, :, None] for i in range(0, 7, 2)]
    coder = HierarchicalConvolutionalSparseCoder(_port(mld2), device="cpu")
    if levels == 1:
        mp = coder.coders[0].mp
        outs = [encode_batches_pipelined(
            batches, mp.params, device="cpu", backend=mp.backend, window=window, **mp.settings
        )]
    else:
        outs = encode_hierarchical_batches_pipelined(batches, coder, window=window)
    assert [len(o) for o in outs] == [4] * levels
    for i, xb in enumerate(batches):
        serial = coder.encode_batch_device(xb)
        for level in range(levels):
            for x, y in zip(outs[level][i], serial[level]):
                assert torch.equal(x, y)


# ---- the corpus codec ------------------------------------------------------


@pytest.mark.parametrize("ns", [1, 4])
@pytest.mark.parametrize("distributed", [False, True])
@pytest.mark.parametrize("mode", ["integer", "ordered"])
def test_hier_container_byte_identical_to_jax(monkeypatch, mld2, ns, distributed, mode):
    """The 2-level container (top-only or distributed) is byte-identical to
    the JAX package's with level 0's init injected; both decoders give the
    same rows, and `decode_stream` gives `decode`'s."""
    cfg = dataclasses.replace(mld2.config, num_select=ns, decode_mode=mode)
    mld = MultilevelDictionary.generate(cfg, seed=11)
    xs = _signals(mld, 5, seed=41)
    ref = JaxCorpusEncoder(mld, backend="jax", batch_size=2, distributed=distributed).encode(xs)
    _inject_jax_init(monkeypatch, hsc_torch.ops.pipeline)
    codec = CorpusEncoder(_port(mld), device="cpu", batch_size=2, distributed=distributed)
    blob = codec.encode(xs)
    assert blob == ref
    rows = codec.decode(blob)
    assert rows.shape == (5, cfg.block_size) and rows.dtype == np.float32
    assert rows.tobytes() == JaxCorpusEncoder(mld, backend="jax", batch_size=2).decode(blob).tobytes()
    assert b"".join(r.tobytes() for r in codec.decode_stream(blob)) == rows.tobytes()


def test_distributed_decodes_like_top_only(mld2):
    """Uninjected: a distributed container decodes bitwise to the oracle's
    per-level decodes summed in level order, and to the top-only rows up
    to float association across levels."""
    xs = _signals(mld2, 5, seed=43)
    for mode in ("integer", "ordered"):
        mld = MultilevelDictionary.generate(dataclasses.replace(mld2.config, decode_mode=mode), seed=11)
        cfg = mld.config
        codec = CorpusEncoder(_port(mld), device="cpu", batch_size=3)
        top = codec.encode(xs)
        dist = CorpusEncoder(_port(mld), device="cpu", batch_size=3, distributed=True).encode(xs)
        rows, rows_d = codec.decode(top), codec.decode(dist)
        _, blocks = unpack_corpus(dist)
        assert any(len(streams) > 1 for streams in blocks)
        for b, streams in enumerate(blocks):
            want = np.zeros(cfg.block_size, np.float32)
            for level, st in streams:
                if mode == "integer":
                    rep_q, step = rep_quantize(mld.representations(level)[:, :, None], cfg.rep_bits)
                    want += mp_decode_integer(st, rep_q, step, cfg.block_size)[:, 0]
                else:
                    want += hierarchical_decode(st, mld, level=level)
            assert rows_d[b].tobytes() == want.tobytes()
        np.testing.assert_allclose(rows_d, rows, rtol=0, atol=1e-5 * float(np.abs(rows).max()))


def test_decode_chunks_mixed_and_repeated_levels(mld2):
    """Chunks of every shape (top-only, distributed, and a block holding two
    streams of one level) decode as the JAX package's chunked decoder."""
    cfg = mld2.config
    xs = _signals(mld2, 4, seed=47)
    port_mld = _port(mld2)
    streams = HierarchicalConvolutionalSparseCoder(port_mld, device="cpu").encode_batch(xs)
    blocks = [
        [(1, streams[0][1])],
        to_distributed(cfg, streams[2][1]),
        [(0, streams[3][0]), (0, streams[0][0]), (1, streams[3][1])],
        [(1, streams[1][1])],
    ]
    jax_codec = JaxCorpusEncoder(mld2, backend="jax", batch_size=2)
    codec = CorpusEncoder(port_mld, device="cpu", batch_size=2)
    for mode in ("integer", "ordered"):
        want = list(jax_codec._decode_chunks(cfg, blocks, mode, cfg.rep_bits))
        got = list(codec._decode_chunks(port_mld.config, iter(blocks), mode, cfg.rep_bits))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.tobytes() == np.asarray(w).tobytes()
