"""Randomized cross-checks of the port against the JAX package on the CPU:
the counterpart of tests/test_fuzz.py, on the same sampled configs.

The port's plain path (`device="cpu"`) is held bitwise against the JAX
path with JAX's level-0 init injected (README "Determinism contract"), and
against the pinned oracle; the integer decode against JAX's XLA decode and
its Pallas kernel in interpret mode, as tests/test_fuzz.py runs them.
Then each mode of scripts/torch_fuzz_parity.py runs once at `--device cpu`
on a seed whose geometry is small, and its samplers are held equal to
scripts/fuzz_tpu_parity.py's, read from that script's source."""

import ast
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsc_tpu import CodecConfig, MultilevelDictionary, SignalGenerator
from hsc_tpu.io import pack_corpus as jax_pack_corpus
from hsc_tpu.models import ConvolutionalSparseCoder as JaxLevelCoder
from hsc_tpu.models import HierarchicalConvolutionalSparseCoder as JaxCoder
from hsc_tpu.ops.decode import mp_decode_integer_jax
from hsc_tpu.ops.decode_integer_kernel import mp_decode_integer_pallas
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.runtime import CorpusEncoder as JaxCorpusEncoder
from pinned import device_init_int as jax_device_init_int
from pinned import oracle_encode_pinned, oracle_hierarchical_pinned

import hsc_torch.models.coder
import hsc_torch.ops.pipeline
import hsc_torch.pinned
from hsc_torch.io import pack_corpus, unpack_corpus
from hsc_torch.models import ConvolutionalSparseCoder, HierarchicalConvolutionalSparseCoder
from hsc_torch.ops.decode_integer_kernel import mp_decode_integer_batch
from hsc_torch.oracle import hierarchical_decode, mp_decode
from hsc_torch.oracle.mp import mp_decode_integer, rep_quantize, to_top_level
from hsc_torch.params import dictionary_from_arrays
from hsc_torch.runtime import CorpusEncoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_fuzz_parity  # noqa: E402


def _port(mld):
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


def _inject(monkeypatch, module):
    """Make `module` call JAX's init where it looks up `encode_init_batched`."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(module, "encode_init_batched", init)


def _events_equal(got, want, cfg):
    for f in ("positions", "atoms", "codes"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), (f, cfg)
    assert np.float32(got.scale) == np.float32(want.scale), cfg


def _hier_config(rng, seed, extra):
    """tests/test_fuzz.py's random 2-level config; ``extra(rng)`` draws the
    remaining fields last, as the original's keyword arguments do."""
    k0 = int(rng.integers(4, 14))
    k1 = int(rng.integers(3, 8))
    w0 = int(rng.integers(8, 20))
    s1 = int(w0 + rng.integers(8, 40))
    block = int(rng.integers(s1 * 4, 1536))
    num_coefs = (int(rng.integers(8, 48)), int(rng.integers(4, 24)))
    return CodecConfig(
        counts=(k0, k1), scales=(w0, s1), num_coefs=num_coefs, block_size=block,
        entropy="rice" if seed % 2 else "fixed", **extra(rng),
    )


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_single_level_pipeline(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(3, 24))
    # wide atom windows (W > 129) every 5th seed, blocks down to < 2W
    if seed % 5 == 4:
        w = int(rng.integers(130, 220))
        block = int(rng.integers(w * 7 // 4, w * 6))
    else:
        w = int(rng.integers(6, 40))
        block = int(rng.integers(w * 4, 2048))
    nc = int(rng.integers(4, 80))
    amp_bits = int(rng.integers(6, 17))
    entropy = "rice" if seed % 2 else "fixed"
    ns = int(rng.choice([1, 1, 2, 3, 8]))
    tol = float(rng.uniform(3.0, 20.0)) if seed % 3 == 0 else None
    cfg = CodecConfig(
        counts=(k,), scales=(w,), num_coefs=(nc,), block_size=block,
        amp_bits=amp_bits, num_select=ns, entropy=entropy,
        tolerance_snr=tol,
    )
    mld = MultilevelDictionary.generate(cfg, seed=seed + 100, max_correlation=0.98)
    gen = SignalGenerator(mld, rates=float(rng.uniform(1e-3, 2e-2)))
    x = gen.generate_signals(1, block, seed=seed)[0]

    jc = JaxLevelCoder(mld, backend="jax")
    want = jc.encode(x)
    ref = oracle_encode_pinned(x[:, None], mld, 0)
    _inject(monkeypatch, hsc_torch.models.coder)
    pmld = _port(mld)
    pc = ConvolutionalSparseCoder(pmld, device="cpu")
    got = pc.encode(x)
    _events_equal(got, want, cfg)
    _events_equal(got, ref, cfg)
    assert np.float32(got.energy_res) == np.float32(ref.energy_res), cfg

    # serialize (the JAX package's bytes), round trip, decode bit-exact
    blob = pack_corpus(pmld.config, [[(0, got)]])
    assert blob == jax_pack_corpus(cfg, [[(0, want)]])
    cfg2, blocks = unpack_corpus(blob)
    assert cfg2 == pmld.config
    stream = blocks[0][0][1]
    a = mp_decode(stream, pmld.augmented(0), block)
    assert pc.reconstruct(stream, n=block).tobytes() == a.tobytes(), cfg
    assert jc.reconstruct(stream, n=block).tobytes() == a.tobytes(), cfg


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_hierarchical_pipeline(monkeypatch, seed):
    rng = np.random.default_rng(1000 + seed)
    cfg = _hier_config(rng, seed, lambda r: dict(singleton_weight=float(r.uniform(0.5, 1.0)),
                                                 num_select=int(r.choice([1, 1, 2]))))
    mld = MultilevelDictionary.generate(cfg, seed=seed + 5, max_correlation=0.98)
    gen = SignalGenerator(mld, rates=float(rng.uniform(2e-3, 1e-2)))
    x = gen.generate_signals(1, cfg.block_size, seed=seed)[0]

    jc = JaxCoder(mld, backend="jax")
    want = jc.encode(x)
    ref = oracle_hierarchical_pinned(x, mld)
    _inject(monkeypatch, hsc_torch.models.coder)
    pmld = _port(mld)
    pc = HierarchicalConvolutionalSparseCoder(pmld, device="cpu")
    got = pc.encode(x)
    for level in range(2):
        _events_equal(got[level], want[level], cfg)
        _events_equal(got[level], ref[level], cfg)

    # decode bit-exact: ordered vs the float oracle and JAX, the default
    # (resolved 'integer') vs the integer oracle and JAX
    a = pc.reconstruct(got[1], mode="ordered")
    assert a.tobytes() == hierarchical_decode(got[1], pmld).tobytes(), cfg
    assert a.tobytes() == jc.reconstruct(want[1], mode="ordered").tobytes(), cfg
    assert pmld.config.decode_mode == "integer"
    rep_q, step = rep_quantize(pmld.representations(1)[:, :, None], cfg.rep_bits)
    ai = pc.reconstruct(got[1])
    assert ai.tobytes() == mp_decode_integer(got[1], rep_q, step, cfg.block_size)[:, 0].tobytes(), cfg
    assert ai.tobytes() == jc.reconstruct(want[1]).tobytes(), cfg


def _padded(streams, cap, step):
    """Event buffers ``[B, cap]``, counts and amplitude steps of streams."""
    nb = len(streams)
    pos, atm, cds = (np.zeros((nb, cap), np.int32) for _ in range(3))
    cnt = np.zeros(nb, np.int32)
    amp = np.zeros(nb, np.float32)
    for b, s in enumerate(streams):
        n = s.positions.shape[0]
        pos[b, :n], atm[b, :n], cds[b, :n], cnt[b] = s.positions, s.atoms, s.codes, n
        amp[b] = np.float32(np.float32(s.scale) * np.float32(step))
    return pos, atm, cds, cnt, amp


def _integer_config(rng, draw_w, block_hi):
    """tests/test_fuzz.py's random integer-decode config: ``draw_w(rng)``
    is the window, ``block_hi(w)`` the block length's bound."""
    k = int(rng.integers(3, 24))
    w = draw_w(rng)
    block = int(rng.integers(w * 4, block_hi(w)))
    nc = int(rng.integers(4, 80))
    amp_bits = int(rng.integers(6, 16))
    rep_bits = int(rng.integers(2, 13))
    return CodecConfig(
        counts=(k,), scales=(w,), num_coefs=(nc,), block_size=block,
        amp_bits=amp_bits, decode_mode="integer", rep_bits=rep_bits,
    )


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_integer_decode(seed):
    """The port's integer decode of a JAX stream bitwise the oracle and
    JAX's XLA decode, across rep_bits / amp_bits / geometry."""
    rng = np.random.default_rng(2000 + seed)
    cfg = _integer_config(rng, lambda r: int(r.integers(6, 40)), lambda w: 2048)
    block, nc = cfg.block_size, cfg.num_coefs[0]
    mld = MultilevelDictionary.generate(cfg, seed=seed + 300, max_correlation=0.98)
    gen = SignalGenerator(mld, rates=float(rng.uniform(1e-3, 2e-2)))
    x = gen.generate_signals(1, block, seed=seed)[0]
    stream = JaxLevelCoder(mld, backend="jax").encode(x)
    rep_q, step = rep_quantize(mld.augmented(0), cfg.rep_bits)
    oracle = mp_decode_integer(stream, rep_q, step, block)
    pos, atm, cds, cnt, amp = _padded([stream], max(nc, 1), step)
    got = mp_decode_integer_batch(*(torch.from_numpy(a) for a in (pos, atm, cds, cnt, amp, rep_q)), n=block)
    assert got[0].numpy().tobytes() == oracle.tobytes(), cfg
    dev = mp_decode_integer_jax(
        jnp.asarray(pos[0]), jnp.asarray(atm[0]), jnp.asarray(cds[0]), jnp.int32(cnt[0]),
        jnp.float32(amp[0]), jnp.asarray(rep_q), n=block,
    )
    assert np.asarray(dev).tobytes() == oracle.tobytes(), cfg


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_integer_kernel(seed):
    """The port's integer decode bitwise JAX's fused kernel (interpret
    mode) and the oracle, wide windows and un-aligned capacities included."""
    rng = np.random.default_rng(4000 + seed)
    wide = seed % 3 == 2
    cfg = _integer_config(rng, lambda r: int(r.integers(130, 200)) if wide else int(r.integers(6, 40)),
                          lambda w: w * 30)
    block, nc = cfg.block_size, cfg.num_coefs[0]
    mld = MultilevelDictionary.generate(cfg, seed=seed + 400, max_correlation=0.98)
    gen = SignalGenerator(mld, rates=float(rng.uniform(1e-3, 2e-2)))
    xs = gen.generate_signals(2, block, seed=seed)
    coder = JaxLevelCoder(mld, backend="jax")
    streams = [coder.encode(x) for x in xs]
    rep_q, step = rep_quantize(mld.augmented(0), cfg.rep_bits)
    cap = max(nc, 1) + int(rng.integers(0, 100))  # un-aligned capacities
    arrays = _padded(streams, cap, step)
    want = np.asarray(
        mp_decode_integer_pallas(*(jnp.asarray(a) for a in arrays), jnp.asarray(rep_q), n=block, interpret=True)
    )
    got = mp_decode_integer_batch(*(torch.from_numpy(a) for a in (*arrays, rep_q)), n=block).numpy()
    assert got.tobytes() == want.tobytes(), cfg
    for b, s in enumerate(streams):
        assert got[b].tobytes() == mp_decode_integer(s, rep_q, step, block).tobytes(), cfg


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_distributed_containers(monkeypatch, seed):
    """Random 2-level configs through the distributed runtime: the port's
    containers (top-only and distributed) byte-identical to JAX's, the
    merged events equal top-only, and the decode deterministic and JAX's."""
    rng = np.random.default_rng(3000 + seed)
    cfg = _hier_config(rng, seed, lambda r: dict(decode_mode="integer" if seed % 2 == 0 else "ordered"))
    mld = MultilevelDictionary.generate(cfg, seed=seed + 7, max_correlation=0.98)
    gen = SignalGenerator(mld, rates=float(rng.uniform(2e-3, 1e-2)))
    xs = gen.generate_signals(3, cfg.block_size, seed=seed)
    jax_dist = JaxCorpusEncoder(mld, backend="jax", batch_size=2, distributed=True)
    want_t = JaxCorpusEncoder(mld, backend="jax", batch_size=2).encode(xs)
    want_d = jax_dist.encode(xs)
    _inject(monkeypatch, hsc_torch.ops.pipeline)
    pmld = _port(mld)
    top = CorpusEncoder(pmld, device="cpu", batch_size=2)
    dist = CorpusEncoder(pmld, device="cpu", batch_size=2, distributed=True)
    blob_t, blob_d = top.encode(xs), dist.encode(xs)
    assert blob_t == want_t and blob_d == want_d, cfg
    _, blocks_t = unpack_corpus(blob_t)
    cfg_d, blocks_d = unpack_corpus(blob_d)

    def key(s):
        return sorted(zip(s.positions.tolist(), s.atoms.tolist(), s.codes.tolist()))

    for bt, bd in zip(blocks_t, blocks_d):
        assert key(to_top_level(cfg_d, bd, level=bt[0][0])) == key(bt[0][1])
    d1 = dist.decode(blob_d)
    assert d1.tobytes() == dist.decode(blob_d).tobytes()
    assert d1.tobytes() == jax_dist.decode(blob_d).tobytes(), cfg


# seeds whose sampled geometry is small (a second or two on the CPU), each
# the first seed of its --base-seed: flat 104000 (K 4, W 11, 2563-sample
# blocks, num_select 30, an SNR stop), hierarchical 104000 (counts 7 / 6,
# scales 12 / 36, int8 hand-off), container 121000 (2 levels, rice,
# distributed, CBR at 1.391 bits per sample over the corpus, seek index)
SCRIPT_CASES = [("flat", 104), ("hierarchical", 104), ("container", 121)]


@pytest.mark.parametrize("mode,base_seed", SCRIPT_CASES)
def test_fuzz_script_modes_on_cpu(capsys, mode, base_seed):
    """Each mode of scripts/torch_fuzz_parity.py through its command line
    at `--device cpu` (the plain paths): one shape, bitwise, exit 0."""
    flag = {"flat": [], "hierarchical": ["--hierarchical"], "container": ["--container"]}[mode]
    argv = [*flag, "--device", "cpu", "--shapes", "1", "--base-seed", str(base_seed)]
    assert torch_fuzz_parity.main(argv) == 0
    line, summary = capsys.readouterr().out.strip().splitlines()
    r = json.loads(line)
    assert r["seed"] == base_seed * 1000 and r["ok"] and r["diff"] is None, r
    assert summary.startswith("1/1 ")


def _jax_script_functions():
    """sample_shape / sample_hier_shape of scripts/fuzz_tpu_parity.py,
    compiled from its source (the script itself imports JAX at load)."""
    path = os.path.join(REPO, "scripts", "fuzz_tpu_parity.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in ("sample_shape", "sample_hier_shape")]
    ns = {"np": np}
    exec(compile(ast.Module(body=fns, type_ignores=[]), path, "exec"), ns)
    return {n.name: (n, ns[n.name]) for n in fns}


@pytest.mark.parametrize("name", ["sample_shape", "sample_hier_shape"])
def test_samplers_equal_the_jax_scripts(name):
    """The port's samplers are the JAX script's, statement for statement
    and draw for draw over 50 seeds."""
    node, fn = _jax_script_functions()[name]
    port_fn = getattr(torch_fuzz_parity, name)
    port_node = ast.parse(open(torch_fuzz_parity.__file__).read()).body
    (port_node,) = [n for n in port_node if isinstance(n, ast.FunctionDef) and n.name == name]
    assert ast.dump(port_node) == ast.dump(node)
    for seed in range(50):
        assert port_fn(np.random.default_rng(seed)) == fn(np.random.default_rng(seed)), seed


@pytest.mark.parametrize("seed", range(2))
def test_pinned_int8_init_is_jaxs(seed):
    """`hsc_torch.pinned.device_init_int` gives the JAX helper's scores bit
    for bit (integer arithmetic, no injection) and its e0 within 1e-6."""
    rng = np.random.default_rng(seed)
    n, c, n_raw, w = int(rng.integers(60, 300)), int(rng.integers(2, 12)), int(rng.integers(1, 8)), int(rng.integers(3, 30))
    m_int = rng.integers(-3000, 3000, size=(n, c)).astype(np.int32)
    bank = rng.standard_normal((n_raw, w, c)).astype(np.float32)
    scale = np.float32(rng.uniform(1e-4, 1.0))
    s_port, e_port = hsc_torch.pinned.device_init_int(m_int, scale, bank, "cpu")
    s_jax, e_jax = jax_device_init_int(m_int, scale, bank)
    assert s_port.dtype == s_jax.dtype and s_port.tobytes() == s_jax.tobytes()
    np.testing.assert_allclose(e_port, e_jax, rtol=1e-6)
