"""The port's parallel layer (`hsc_torch.parallel`) against the JAX package on
the CPU: the mesh, the data-parallel encoders and decoder, the sequence- and
tensor-parallel single-block encode and distributed k-means.

Mirrors tests/test_parallel.py.  JAX runs on conftest's 8 virtual CPU
devices; the port on meshes of repeated CPU devices.  Tolerances:
  * the data-parallel codec: streams and rows bitwise the port's local path
    (the same per-block arithmetic), and bitwise JAX's data-parallel path
    with JAX's level-0 init injected where the coder looks it up;
  * `sp_loop` / `tp_loop` given JAX's single-device init
    (`encode_init_jax`): positions, atoms, codes, count and scale bitwise
    JAX's single-device stream, the port's local loop and JAX's
    `sp_encode` / `tp_encode` (on the seeds where tests/test_parallel.py
    shows those equal to the single-device stream);
  * k-means: float32 sums in another order than XLA's psum, so centroids to
    1e-5 and objectives to 1e-5 relative against JAX; bitwise run to run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsc_tpu import MultilevelDictionary as JaxMLD
from hsc_tpu import SignalGenerator, make_test_config
from hsc_tpu.learn.kmeans import kmeans_refine_device as jax_refine
from hsc_tpu.models import ConvolutionalSparseCoder as JaxSparseCoder
from hsc_tpu.models.coder import HierarchicalConvolutionalSparseCoder as JaxCoder
from hsc_tpu.ops import mp_encode_jax
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.ops.encode import encode_init_jax
from hsc_tpu.parallel import DataParallelDecoder as JaxDPDecoder
from hsc_tpu.parallel import DataParallelEncoder as JaxDPEncoder
from hsc_tpu.parallel import HierarchicalDataParallelEncoder as JaxHierDP
from hsc_tpu.parallel import distributed_kmeans as jax_dist_kmeans
from hsc_tpu.parallel import distributed_kmeans_step as jax_dist_step
from hsc_tpu.parallel import make_mesh as jax_make_mesh
from hsc_tpu.parallel import sp_encode as jax_sp_encode
from hsc_tpu.parallel import tp_encode as jax_tp_encode

import hsc_torch.models.coder
from hsc_torch.learn.kmeans import kmeans_refine_device
from hsc_torch.models import ConvolutionalSparseCoder, HierarchicalConvolutionalSparseCoder
from hsc_torch.ops.encode import mp_encode_from_init_torch, quantizer_steps
from hsc_torch.params import dictionary_from_arrays, level_params_from_mld
from hsc_torch.parallel import (
    DataParallelDecoder,
    DataParallelEncoder,
    HierarchicalDataParallelEncoder,
    distributed_kmeans,
    distributed_kmeans_step,
    make_mesh,
    sp_encode,
    tp_encode,
)
from hsc_torch.parallel.sp import sp_init, sp_loop, sp_shard_scores
from hsc_torch.parallel.tp import tp_init, tp_loop, tp_shard_scores


def _port(mld):
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


def _cpu_mesh(axes):
    return make_mesh(axes, devices=["cpu"] * int(np.prod(list(axes.values()))))


@pytest.fixture
def inject(monkeypatch):
    """JAX's level-0 init where the port's data-parallel encoder looks up
    `encode_init_batched` (`ConvolutionalMatchingPursuit.init_stage`)."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(hsc_torch.models.coder, "encode_init_batched", init)


def _fields_equal(a, b, n_blocks):
    """Host batched `EncodedBlock`s: every field of every block bitwise."""
    for f in ("positions", "atoms", "codes", "count", "scale"):
        x, y = np.asarray(getattr(a, f))[:n_blocks], np.asarray(getattr(b, f))[:n_blocks]
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def _stream_equal(a, b):
    """Unbatched streams (port or JAX): count, scale and the event prefix."""
    n = int(b.count)
    assert int(a.count) == n
    for f in ("positions", "atoms", "codes"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f))[:n], np.asarray(getattr(b, f))[:n], err_msg=f)
    assert np.float32(a.scale) == np.float32(b.scale)


# -- the mesh -----------------------------------------------------------------


@pytest.mark.parametrize("axes", [{"data": 4, "model": 2}, {"data": 8}, {"seq": 2, "data": 2, "model": 2}])
def test_make_mesh_shapes(axes):
    m = _cpu_mesh(axes)
    assert m.shape == axes and m.axis_names == tuple(axes) and m.devices.size == 8
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    first = next(iter(axes))
    assert len(m.axis_devices(first)) == axes[first]


def test_make_mesh_errors():
    with pytest.raises(ValueError, match="needs 5 devices"):
        make_mesh({"data": 5}, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="no axis"):
        _cpu_mesh({"data": 2}).axis_devices("seq")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh({"data": 1})
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh({"data": 2}, devices=["cuda:0"] * 2)
    # a CPU caller with a mesh of another type, or the reverse, is refused
    coder = ConvolutionalSparseCoder(_port(JaxMLD.generate(make_test_config(), seed=7)), device="cpu")
    fake = make_mesh({"data": 2}, devices=["cpu"] * 2)
    fake.devices[:] = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="device type"):
        DataParallelEncoder(fake, coder.mp)


# -- data parallel --------------------------------------------------------------


@pytest.mark.parametrize("n_blocks,num_select", [(16, 1), (5, 1), (11, 3)])
def test_dp_encode_matches_local_and_jax(mld1, inject, monkeypatch, n_blocks, num_select):
    """DP encode on 8 CPU shards: the port's local encode bitwise (own init),
    and JAX's `DataParallelEncoder` bitwise (JAX's init injected), in
    original block order, a ragged batch padded and trimmed."""
    import dataclasses

    cfg = dataclasses.replace(mld1.config, num_select=num_select)
    mld = JaxMLD(cfg, mld1.dicts)
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(n_blocks, cfg.block_size, seed=51)
    xs[2] = 0.0
    coder = ConvolutionalSparseCoder(_port(mld), device="cpu")
    dp = DataParallelEncoder(_cpu_mesh({"data": 8}), coder.mp)
    got = dp.encode(xs)
    assert got.count.shape == (n_blocks,) and int(got.count[2]) == 0
    ref = JaxDPEncoder(jax_make_mesh({"data": 8}), JaxSparseCoder(mld, backend="jax").mp).encode(xs)
    _fields_equal(got, ref, n_blocks)
    monkeypatch.undo()  # the port's own init from here
    local = coder.mp.compute_coefficients_batch(xs)
    _fields_equal(dp.encode(xs), type(got)(*(f.numpy() for f in local)), n_blocks)


def test_dp_encode_multihost_single_process(mld1):
    """Without a process group `encode_multihost` is `encode`."""
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(8, mld1.config.block_size, seed=53)
    dp = DataParallelEncoder(_cpu_mesh({"data": 8}), ConvolutionalSparseCoder(_port(mld1), device="cpu").mp)
    _fields_equal(dp.encode_multihost(xs, n_global=8), dp.encode(xs), 8)
    assert dp.multihost_split(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]


def test_dp_on_a_mesh_with_more_axes(mld1):
    """On {'data': 4, 'seq': 2} DP shards over 'data' only, bitwise the
    8-way 'data' mesh."""
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(7, mld1.config.block_size, seed=54)
    mp = ConvolutionalSparseCoder(_port(mld1), device="cpu").mp
    two = DataParallelEncoder(_cpu_mesh({"data": 4, "seq": 2}), mp)
    assert two.num_shards == 4 and len(two.devices) == 4
    _fields_equal(two.encode(xs), DataParallelEncoder(_cpu_mesh({"data": 8}), mp).encode(xs), 7)


@pytest.mark.parametrize("hier_init", ["int8", "f32"])
def test_hierarchical_dp_matches_local_and_jax(mld2, inject, monkeypatch, hier_init):
    """Every level on every shard, hand-offs on the shard (events for an int8
    level, `feature_map` for an f32 one): bitwise JAX's hierarchical DP with
    JAX's init injected, and bitwise the port's local coder with its own."""
    import dataclasses

    cfg = dataclasses.replace(mld2.config, hier_init=hier_init)
    mld = JaxMLD(cfg, mld2.dicts)
    xs = SignalGenerator(mld, rates=[np.full(12, 4e-3), np.full(8, 1e-3)]).generate_signals(
        6, cfg.block_size, seed=74)
    coder = HierarchicalConvolutionalSparseCoder(_port(mld), device="cpu")
    dp = HierarchicalDataParallelEncoder(_cpu_mesh({"data": 4}), coder)
    got = dp.encode(xs)
    ref = JaxHierDP(jax_make_mesh({"data": 4}, devices=jax.devices()[:4]), JaxCoder(mld, backend="jax")).encode(xs)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _fields_equal(g, r, 6)
    monkeypatch.undo()
    local = coder.encode_batch_device(xs)
    for g, loc in zip(dp.encode(xs), local):
        _fields_equal(g, type(g)(*(f.numpy() for f in loc)), 6)


@pytest.mark.parametrize("mode", ["integer", "ordered"])
def test_dp_decoder_pads_and_matches(mld2, mode):
    """10 blocks on 8 shards (padded with empty streams): rows bitwise the
    local `reconstruct_batch_device` and JAX's `DataParallelDecoder`."""
    import dataclasses

    cfg = dataclasses.replace(mld2.config, decode_mode=mode)
    mld = JaxMLD(cfg, mld2.dicts)
    xs = SignalGenerator(mld, rates=2e-2).generate_signals(10, cfg.block_size, seed=73)
    coder = HierarchicalConvolutionalSparseCoder(_port(mld), device="cpu")
    streams = [s[-1] for s in coder.encode_batch(xs)]
    dec = DataParallelDecoder(_cpu_mesh({"data": 8}), coder)
    rows = dec.decode_batch_device(streams)
    assert rows.shape == (10, cfg.block_size, 1)
    assert rows.numpy().tobytes() == coder.reconstruct_batch_device(streams).numpy().tobytes()
    jax_rows = JaxDPDecoder(jax_make_mesh({"data": 8}), JaxCoder(mld, backend="jax")).decode_batch_device(streams)
    assert rows.numpy().tobytes() == np.asarray(jax_rows).tobytes()
    lvl0 = [s[0] for s in coder.encode_batch(xs)]
    assert (dec.decode_batch_device(lvl0, level=0).numpy().tobytes()
            == coder.reconstruct_batch_device(lvl0, level=0).numpy().tobytes())


def _numpy_tree(sq):
    """`block_energy`'s pairwise tree in NumPy float32."""
    while sq.shape[1] > 1:
        m, h = sq.shape[1], sq.shape[1] // 2
        half = sq[:, :h] + sq[:, h : 2 * h]
        if m % 2:
            half[:, 0] += sq[:, m - 1]
        sq = half
    return sq[:, 0]


@pytest.mark.parametrize("shape", [(1, 1), (7, 1), (4096, 1), (1021, 3), (509, 64)])
def test_block_energy_pairwise_tree(shape):
    """e0 (`ops.encode.block_energy`) at power-of-two and odd widths: bitwise
    the same tree summed in NumPy, bitwise the same for a block alone as in
    its batch (a ragged shard's batch is not the local path's), and within
    1e-6 relative of the float64 sum."""
    from hsc_torch.ops.encode import block_energy

    xs = np.random.default_rng(sum(shape)).standard_normal((5,) + shape).astype(np.float32)
    got = block_energy(torch.from_numpy(xs)).numpy()
    assert got.dtype == np.float32 and got.shape == (5,)
    assert got.tobytes() == _numpy_tree(np.square(xs.reshape(5, -1))).tobytes()
    for i in range(5):
        assert block_energy(torch.from_numpy(xs[i : i + 1])).numpy().tobytes() == got[i : i + 1].tobytes()
    want = np.square(xs.astype(np.float64)).sum(axis=(1, 2))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("mode", ["integer", "ordered"])
def test_dp_replicas_on_distinct_devices(mld2, mode):
    """A mesh of four distinct devices (cpu:0..cpu:3, as four cards would
    be): every shard but the first runs on a replica of the coder made by
    `parallel.dp.replica` (once per device, its `device` attributes and
    decode tables moved); the hierarchical DP streams and the decoded rows
    are bitwise the local path's."""
    import dataclasses

    from hsc_torch.parallel.dp import replica

    cfg = dataclasses.replace(mld2.config, decode_mode=mode)
    mld = JaxMLD(cfg, mld2.dicts)
    xs = SignalGenerator(mld, rates=[np.full(12, 4e-3), np.full(8, 1e-3)]).generate_signals(
        6, cfg.block_size, seed=75)
    coder = HierarchicalConvolutionalSparseCoder(_port(mld), device="cpu")
    mesh = make_mesh({"data": 4}, devices=[f"cpu:{i}" for i in range(4)])
    got = HierarchicalDataParallelEncoder(mesh, coder).encode(xs)
    for g, loc in zip(got, coder.encode_batch_device(xs)):
        _fields_equal(g, type(g)(*(f.numpy() for f in loc)), 6)
    streams = [s[-1] for s in coder.encode_batch(xs)]
    rows = DataParallelDecoder(mesh, coder).decode_batch_device(streams)
    assert rows.numpy().tobytes() == coder.reconstruct_batch_device(streams).numpy().tobytes()
    rep = replica(coder, "cpu:2")
    assert rep is not coder and rep is replica(coder, torch.device("cpu", 2))
    assert replica(coder, "cpu") is coder
    assert {str(m.device) for m in (rep, *(c.mp for c in rep.coders))} == {"cpu:2"}


# -- sequence and tensor parallel ---------------------------------------------------


def _single_device(mld, x, **kw):
    """JAX's single-device init and stream of one block, and the port's
    local loop on that init."""
    cfg = mld.config
    bank, gram = mld.augmented(0), mld.gram(0)
    gram_t = np.ascontiguousarray(gram.transpose(1, 0, 2))
    s0, e0, peak = encode_init_jax(jnp.asarray(x)[:, None], jnp.asarray(bank))
    scale, inv = quantizer_steps(np.asarray(peak), cfg.amp_bits)
    single = mp_encode_jax(jnp.asarray(x)[:, None], jnp.asarray(bank), jnp.asarray(gram_t),
                           num_coefs=cfg.num_coefs[0], **kw)
    params = level_params_from_mld(_port(mld), 0, "cpu")
    local = mp_encode_from_init_torch(
        torch.from_numpy(np.array(s0))[None], torch.tensor(np.array(e0))[None],
        torch.from_numpy(scale)[None], torch.from_numpy(inv)[None], params,
        num_coefs=cfg.num_coefs[0], **kw)
    local = type(local)(*(f[0] for f in local))
    return dict(s0=torch.from_numpy(np.array(s0)), e0=torch.tensor(np.array(e0)), scale=scale, inv=inv,
                bank=bank, gram=gram, gram_t=gram_t, single=single, local=local)


SP_CASES = [(61, 1, None), (62, 1, 6.0), (65, 3, None), (67, 3, 4.0), (65, 1, 4.0), (68, 3, 6.0)]


@pytest.mark.parametrize("seed,num_select,tol", SP_CASES)
def test_sp_loop_bitwise_single_device_and_jax(mld1, seed, num_select, tol):
    """`sp_loop` on 4 'seq' shards given JAX's single-device init: bitwise
    JAX's single-device stream, the port's local loop and JAX's
    `sp_encode`; `sp_encode` with the port's own init equals it here too."""
    cfg = mld1.config
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(1, cfg.block_size, seed=seed)[0]
    kw = dict(num_select=num_select, tolerance_snr=tol)
    ref = _single_device(mld1, x, **kw)
    mesh = _cpu_mesh({"seq": 4})
    got = sp_loop(mesh, sp_shard_scores(mesh, ref["s0"], cfg.block_size), ref["e0"], ref["scale"], ref["inv"],
                  torch.from_numpy(ref["gram_t"]), num_coefs=cfg.num_coefs[0], **kw)
    _stream_equal(got, ref["single"])
    _stream_equal(got, ref["local"])
    assert np.float32(got.energy0) == np.float32(ref["single"].energy0)
    jsp = jax_sp_encode(jax_make_mesh({"seq": 4}, devices=jax.devices()[:4]), jnp.asarray(x)[:, None],
                        jnp.asarray(ref["bank"]), jnp.asarray(ref["gram_t"]), num_coefs=cfg.num_coefs[0], **kw)
    _stream_equal(got, jsp)
    own = sp_encode(mesh, x, torch.from_numpy(ref["bank"]), torch.from_numpy(ref["gram_t"]),
                    num_coefs=cfg.num_coefs[0], **kw)
    _stream_equal(own, jsp)
    if tol is not None:
        assert 10 * np.log10(float(got.energy0) / float(got.energy_res)) >= tol


def test_sp_snr_stop_borderline(mld1):
    """The SNR stop exactly at the threshold (tests/test_parallel.py:352):
    the tolerance is the SNR the port's single-device loop reaches at its
    final event, and its float neighbours.  e0 is one full-block
    reduction, so the sharded stop is the local stop bit for bit, and both
    are the oracle's (given the same init).  JAX's single-device stream is
    not the reference here: its XLA loop's residual energy is a few ulps
    off the oracle's (ROADMAP Queue 3), which moves a stop at the
    threshold."""
    from hsc_torch.oracle.mp import mp_encode

    cfg = mld1.config
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(1, cfg.block_size, seed=68)[0]
    probe = _single_device(mld1, x, tolerance_snr=5.0)["local"]
    assert 0 < int(probe.count) < cfg.num_coefs[0]
    tol = 10.0 * float(np.log10(float(probe.energy0) / float(probe.energy_res)))
    mesh = _cpu_mesh({"seq": 4})
    for t in (tol, np.nextafter(tol, 0.0), np.nextafter(tol, np.inf)):
        ref = _single_device(mld1, x, tolerance_snr=float(t))
        got = sp_loop(mesh, sp_shard_scores(mesh, ref["s0"], cfg.block_size), ref["e0"], ref["scale"],
                      ref["inv"], torch.from_numpy(ref["gram_t"]), num_coefs=cfg.num_coefs[0],
                      tolerance_snr=float(t))
        _stream_equal(got, ref["local"])
        assert np.float32(got.energy_res) == np.float32(ref["local"].energy_res)
        o = mp_encode(x[:, None], ref["bank"], ref["gram"], scores0=ref["s0"].numpy(),
                      energy0=float(ref["e0"]), num_coefs=cfg.num_coefs[0], tolerance_snr=float(t))
        assert int(got.count) == o.positions.shape[0]
        np.testing.assert_array_equal(got.codes[: int(got.count)].numpy(), o.codes)


def _planted(mld, n, spots, seed=0):
    """A block of `n` samples: small noise plus raw atom 0 of `mld` placed
    at each position in `spots` (large amplitudes, so they win first)."""
    rng = np.random.default_rng(seed)
    x = (0.01 * rng.standard_normal(n)).astype(np.float32)
    atom = mld.dicts[0][0, :, 0]
    for j, t in enumerate(spots):
        x[t : t + atom.shape[0]] += np.float32(10.0 - j) * atom
    return x


@pytest.mark.parametrize("case", ["edge", "tail", "l_eq_2w"])
@pytest.mark.parametrize("num_select", [1, 3])
def test_sp_shard_boundaries(mld1, case, num_select):
    """SP's boundary code: winners within W-1 of a shard edge (on both
    sides), a winner at the last valid position in the last shard (whose
    tail lies past npos_total), and shards of exactly 2W samples.  Given
    the single-device init the stream is bitwise the single-device one, the
    port's local loop and JAX's `sp_encode`."""
    cfg = mld1.config
    w = cfg.scales[0]
    if case == "l_eq_2w":
        n, spots = 4 * 2 * w, [2 * w - 3, 4 * w + 1, 6 * w - w + 2]
    else:
        n = cfg.block_size
        l = n // 4
        spots = ([l - 3, 2 * l - w + 1, 3 * l + 2, l + w - 2] if case == "edge"
                 else [n - w, 3 * l - 1, n - w - 7])
    x = _planted(mld1, n, spots)
    kw = dict(num_select=num_select)
    ref = _single_device(mld1, x, **kw)
    assert {int(p) for p in np.asarray(ref["single"].positions)[:8]} & set(spots), "no planted atom was picked"
    mesh = _cpu_mesh({"seq": 4})
    got = sp_loop(mesh, sp_shard_scores(mesh, ref["s0"], n), ref["e0"], ref["scale"], ref["inv"],
                  torch.from_numpy(ref["gram_t"]), num_coefs=cfg.num_coefs[0], **kw)
    _stream_equal(got, ref["single"])
    _stream_equal(got, ref["local"])
    jsp = jax_sp_encode(jax_make_mesh({"seq": 4}, devices=jax.devices()[:4]), jnp.asarray(x)[:, None],
                        jnp.asarray(ref["bank"]), jnp.asarray(ref["gram_t"]), num_coefs=cfg.num_coefs[0], **kw)
    _stream_equal(got, jsp)


def test_sp_init_matches_single_device(mld1):
    """The halo'd per-shard init: every valid position within 1e-5 of the
    peak of JAX's single-device init and of the port's (a different conv
    problem, so a tolerance); e0 is the port's single-device expression, so
    bitwise its e0; the peak within the same 1e-5."""
    from hsc_torch.ops.encode import encode_init_batched

    cfg = mld1.config
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(1, cfg.block_size, seed=61)[0]
    ref = _single_device(mld1, x)
    mesh = _cpu_mesh({"seq": 4})
    s0, e0, peak = sp_init(mesh, x, torch.from_numpy(ref["bank"]))
    l_s0, l_e0, l_peak = encode_init_batched(torch.from_numpy(x)[None, :, None], torch.from_numpy(ref["bank"]))
    full = torch.cat(s0, dim=1)[:, : ref["s0"].shape[1]]
    for other, top in ((ref["s0"], ref["s0"].abs().max()), (l_s0[0], l_peak[0])):
        assert float((full - other).abs().max()) <= 1e-5 * float(top)
        assert abs(float(peak) - float(top)) <= 1e-5 * float(top)
    assert e0.dtype == torch.float32 and float(e0) == float(l_e0[0])


@pytest.mark.parametrize("seed,num_select,tol", [(63, 1, None), (66, 3, None), (66, 1, 5.0), (63, 3, 6.0)])
def test_tp_loop_bitwise_single_device_and_jax(mld1, seed, num_select, tol):
    """`tp_loop` on 4 'model' shards (16 atoms, 4 each) given JAX's
    single-device init: bitwise JAX's single-device stream, the port's
    local loop and JAX's `tp_encode`; `tp_encode` with its own init too."""
    cfg = mld1.config
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(1, cfg.block_size, seed=seed)[0]
    kw = dict(num_select=num_select, tolerance_snr=tol)
    ref = _single_device(mld1, x, **kw)
    mesh = _cpu_mesh({"model": 4})
    got = tp_loop(mesh, tp_shard_scores(mesh, ref["s0"]), ref["e0"], ref["scale"], ref["inv"],
                  torch.from_numpy(ref["gram"]), num_coefs=cfg.num_coefs[0], **kw)
    _stream_equal(got, ref["single"])
    _stream_equal(got, ref["local"])
    jtp = jax_tp_encode(jax_make_mesh({"model": 4}, devices=jax.devices()[:4]), jnp.asarray(x)[:, None],
                        jnp.asarray(ref["bank"]), jnp.asarray(ref["gram"]), num_coefs=cfg.num_coefs[0], **kw)
    _stream_equal(got, jtp)
    own = tp_encode(mesh, x, torch.from_numpy(ref["bank"]), torch.from_numpy(ref["gram"]),
                    num_coefs=cfg.num_coefs[0], **kw)
    _stream_equal(own, jtp)
    s0, e0, peak = tp_init(mesh, x, torch.from_numpy(ref["bank"]))
    assert float((torch.cat(s0) - ref["s0"]).abs().max()) <= 1e-5 * float(peak)


def test_tp_singleton_weights(mld2):
    """TP at a level-1 geometry of the hierarchy (raw atoms and weighted
    singleton atoms, sharded across the raw/singleton boundary): bitwise
    the port's local loop given one init."""
    port = _port(mld2)
    k = port.num_atoms(1)
    mesh = _cpu_mesh({"model": 2 if k % 4 else 4})
    rng = np.random.default_rng(5)
    bank = port.augmented(1)
    gram = port.gram(1)
    n = 400
    x = rng.standard_normal((n, bank.shape[2])).astype(np.float32)
    params = level_params_from_mld(port, 1, "cpu")
    s0, e0, peak = tp_init(mesh, x, torch.from_numpy(bank))
    full = torch.cat(s0)
    scale, inv = quantizer_steps(np.asarray(float(peak), np.float32), 16)
    cfg = port.config
    kw = dict(num_coefs=40, num_select=2)
    local = mp_encode_from_init_torch(full[None], e0[None], torch.from_numpy(scale)[None],
                                      torch.from_numpy(inv)[None], params, **kw)
    got = tp_loop(mesh, s0, e0, scale, inv, torch.from_numpy(gram), n_raw=cfg.counts[1],
                  singleton_weight=cfg.singleton_weight, **kw)
    _stream_equal(got, type(local)(*(f[0] for f in local)))


def test_bad_shapes_raise(mld1):
    bank = torch.from_numpy(mld1.augmented(0))
    gram = mld1.gram(0)
    gram_t = torch.from_numpy(np.ascontiguousarray(gram.transpose(1, 0, 2)))
    seq = _cpu_mesh({"seq": 4})
    with pytest.raises(ValueError, match="must divide"):
        sp_encode(seq, torch.zeros((1026, 1)), bank, gram_t, num_coefs=4)
    with pytest.raises(ValueError, match="shard length"):
        sp_encode(seq, torch.zeros((64, 1)), bank, gram_t, num_coefs=4)
    with pytest.raises(ValueError, match="K=16 must divide"):
        tp_encode(_cpu_mesh({"model": 3}), torch.zeros((1024, 1)), bank, torch.from_numpy(gram), num_coefs=4)
    with pytest.raises(ValueError, match="must divide the mesh axis"):
        distributed_kmeans(_cpu_mesh({"data": 8}), torch.zeros((20, 4)), torch.eye(4), 1)


# -- distributed k-means -------------------------------------------------------------


def _kmeans_data(seed):
    rng = np.random.default_rng(seed)
    windows = rng.standard_normal((256, 32)).astype(np.float32)
    cents = rng.standard_normal((8, 32)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    return windows, cents


def test_distributed_kmeans_step_vs_jax():
    """One sharded step: within 1e-5 of JAX's and of the unsharded update;
    bitwise run to run."""
    windows, cents = _kmeans_data(0)
    mesh = _cpu_mesh({"data": 8})
    new, obj = distributed_kmeans_step(mesh, windows, cents)
    again, obj2 = distributed_kmeans_step(mesh, windows, cents)
    assert torch.equal(new, again) and torch.equal(obj, obj2)
    j_new, j_obj = jax_dist_step(jax_make_mesh({"data": 8}), jnp.asarray(windows), jnp.asarray(cents))
    np.testing.assert_allclose(new.numpy(), np.asarray(j_new), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(obj), float(j_obj), rtol=1e-5)


def test_distributed_kmeans_vs_jax_and_local():
    """The full sharded loop with a dead centroid and a silent window:
    within 1e-5 of JAX's `distributed_kmeans` and of the port's local
    `kmeans_refine_device`; bitwise run to run."""
    windows, cents = _kmeans_data(3)
    windows[5] = 0
    cents[2] = 0
    mesh = _cpu_mesh({"data": 8})
    c, objs = distributed_kmeans(mesh, windows, cents, 6)
    c2, objs2 = distributed_kmeans(mesh, windows, cents, 6)
    assert torch.equal(c, c2) and torch.equal(objs, objs2)
    assert objs.shape == (6,)
    jc, jobjs = jax_dist_kmeans(jax_make_mesh({"data": 8}), jnp.asarray(windows), jnp.asarray(cents), 6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(objs.numpy(), np.asarray(jobjs), rtol=1e-5)
    lc, lobjs = kmeans_refine_device(torch.from_numpy(windows), torch.from_numpy(cents), iterations=6)
    np.testing.assert_allclose(c.numpy(), lc.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(objs.numpy(), lobjs.numpy(), rtol=1e-5)
    # the JAX package's own local loop, for the same bound
    jl, _ = jax_refine(jnp.asarray(windows), jnp.asarray(cents), iterations=6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
