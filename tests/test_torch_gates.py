"""The gates of the port's bitwise contract at the geometries the first
fuzz left out, on the CPU against the JAX package: corpora checked at several
batch sizes, 3-level hierarchies, containers with the f32 hand-off, and
meshes on ragged corpora.  Then the new samplers of
scripts/torch_fuzz_parity.py (and the old ones, unchanged), and each of its
new modes at `--device cpu`.

Geometries are small (blocks of at most 4096 samples, at most 16 blocks).
The port runs its plain paths on the CPU; JAX's level-0 init is injected
where the port looks it up (`encode_init_batched`, at every f32 level too),
so streams and containers are held bitwise against JAX's (README
"Determinism contract"); the int8 init of levels >= 1 needs no injection.
JAX's mesh runs on conftest's 8 virtual CPU devices, the port's on
repeated CPU devices."""

import inspect
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsc_tpu import MultilevelDictionary as JaxMLD
from hsc_tpu import SignalGenerator, make_test_config
from hsc_tpu.models import HierarchicalConvolutionalSparseCoder as JaxCoder
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.parallel import make_mesh as jax_make_mesh
from hsc_tpu.runtime import CorpusEncoder as JaxCorpusEncoder
from pinned import oracle_hierarchical_pinned

import hsc_torch.models.coder
import hsc_torch.ops.pipeline
from hsc_torch.models import HierarchicalConvolutionalSparseCoder
from hsc_torch.params import dictionary_from_arrays
from hsc_torch.parallel import make_mesh
from hsc_torch.runtime import CorpusEncoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_fuzz_parity as fuzz  # noqa: E402


def _port(mld):
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


def _inject(monkeypatch, *modules):
    """Make each of `modules` call JAX's init where it looks up
    `encode_init_batched`."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    for module in modules:
        monkeypatch.setattr(module, "encode_init_batched", init)


def _events_equal(got, want, what):
    for f in ("positions", "atoms", "codes"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), (f, what)
    assert np.float32(got.scale) == np.float32(want.scale), what


def _small_config(rng, levels: int, **extra):
    """A random geometry of 1-3 levels with blocks of at most 4096 samples:
    each scale a multiple (2-3) of the one below, counts mostly not
    multiples of 8."""
    w0 = int(rng.integers(6, 16))
    scales = [w0]
    for _ in range(levels - 1):
        scales.append(scales[-1] * int(rng.integers(2, 4)))
    counts = [int(rng.integers(4, 20))] + [int(rng.integers(3, 12)) for _ in range(levels - 1)]
    nc = [int(rng.integers(16, 80))]
    for _ in range(levels - 1):
        nc.append(int(rng.integers(4, max(nc[-1] // 2, 5))))
    block = int(rng.integers(max(scales[-1] * 6, 512), 4097))
    return make_test_config(counts=tuple(counts), scales=tuple(scales), num_coefs=tuple(nc), block_size=block,
                            amp_bits=int(rng.integers(8, 17)), num_select=int(rng.choice([1, 2, 3, 8])), **extra)


def _corpus(mld, n, seed):
    return SignalGenerator(mld, rates=4e-3).generate_signals(n, mld.config.block_size, seed=seed)


# -- batch invariance ----------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_containers_batch_invariant(monkeypatch, seed):
    """A ragged corpus of 10-16 blocks (1 or 2 levels): the level-0 init of
    every block the same bits at batch 1, 3 and whole; the port's container
    byte-identical at batch_size 1, 3 and whole; at batch_size 3 with JAX's
    init injected, JAX's `CorpusEncoder`'s bytes, and its rows JAX's."""
    rng = np.random.default_rng(5000 + seed)
    cfg = _small_config(rng, 1 + seed % 2)
    mld = JaxMLD.generate(cfg, seed=seed + 60, max_correlation=0.98)
    n = int(rng.choice([10, 11, 13, 14, 16]))
    xs = _corpus(mld, n, seed + 61)
    pmld = _port(mld)
    coder = HierarchicalConvolutionalSparseCoder(pmld, device="cpu")
    assert fuzz.init_batch_diff(xs, coder.coders[0].mp.bank, torch.device("cpu"), (1, 3)) is None, cfg
    blobs = {bs: CorpusEncoder(pmld, device="cpu", batch_size=bs).encode(xs) for bs in (1, 3, n)}
    assert blobs[1] == blobs[3] == blobs[n], cfg
    _inject(monkeypatch, hsc_torch.ops.pipeline, hsc_torch.models.coder)
    port = CorpusEncoder(pmld, device="cpu", batch_size=3)
    jax_enc = JaxCorpusEncoder(mld, backend="jax", batch_size=3)
    blob = port.encode(xs)
    assert blob == jax_enc.encode(xs), cfg
    assert port.decode(blob).tobytes() == jax_enc.decode(blob).tobytes(), cfg


# -- three levels --------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_three_level_hierarchy(monkeypatch, seed):
    """Every level of the port's 3-level coder (int8 or f32 hand-off) bitwise
    JAX's coder with JAX's init injected and tests/pinned.py's
    `oracle_hierarchical_pinned`; the top streams decode in both modes
    bitwise JAX's decode."""
    rng = np.random.default_rng(6000 + seed)
    cfg = _small_config(rng, 3, hier_init=("int8", "f32")[seed % 2])
    mld = JaxMLD.generate(cfg, seed=seed + 70, max_correlation=0.98)
    xs = _corpus(mld, 2, seed + 71)
    jc = JaxCoder(mld, backend="jax")
    _inject(monkeypatch, hsc_torch.models.coder)
    pc = HierarchicalConvolutionalSparseCoder(_port(mld), device="cpu")
    got = pc.encode_batch(xs)
    for b in range(2):
        want = jc.encode(xs[b])
        ref = oracle_hierarchical_pinned(xs[b], mld)
        for level in range(3):
            _events_equal(got[b][level], want[level], (cfg, b, level, "jax"))
            _events_equal(got[b][level], ref[level], (cfg, b, level, "oracle"))
        for mode in ("ordered", "integer"):
            assert (pc.reconstruct(got[b][2], mode=mode).tobytes()
                    == jc.reconstruct(want[2], mode=mode).tobytes()), (cfg, b, mode)


# -- f32 hand-off containers ---------------------------------------------------


@pytest.mark.parametrize("seed,levels,distributed", [(0, 2, False), (1, 3, True), (2, 3, False)])
def test_f32_containers(monkeypatch, seed, levels, distributed):
    """A container of a hierarchy with hier_init='f32' (2 or 3 levels, top
    only or distributed): with JAX's init injected at every f32 level, the
    port's bytes are JAX's `CorpusEncoder`'s and its rows JAX's decode."""
    rng = np.random.default_rng(7000 + seed)
    cfg = _small_config(rng, levels, hier_init="f32", entropy=("fixed", "rice")[seed % 2])
    mld = JaxMLD.generate(cfg, seed=seed + 80, max_correlation=0.98)
    xs = _corpus(mld, 5, seed + 81)
    _inject(monkeypatch, hsc_torch.ops.pipeline, hsc_torch.models.coder)
    port = CorpusEncoder(_port(mld), device="cpu", batch_size=2, distributed=distributed)
    jax_enc = JaxCorpusEncoder(mld, backend="jax", batch_size=2, distributed=distributed)
    blob = port.encode(xs)
    assert blob == jax_enc.encode(xs), cfg
    assert port.decode(blob).tobytes() == jax_enc.decode(blob).tobytes(), cfg


# -- meshes on ragged corpora --------------------------------------------------


@pytest.mark.parametrize("seed,shards", [(0, 2), (1, 3), (2, 4)])
def test_mesh_containers_ragged(monkeypatch, seed, shards):
    """A ragged corpus on a mesh of 2-4 CPU shards (1-3 levels): with JAX's
    init injected, the port's `CorpusEncoder(mesh=...)` container is JAX's
    on as many of conftest's virtual devices; with its own init it is the
    port's local container at the same batch size, and its rows the local
    rows."""
    rng = np.random.default_rng(8000 + seed)
    cfg = _small_config(rng, 1 + seed)
    mld = JaxMLD.generate(cfg, seed=seed + 90, max_correlation=0.98)
    n, bs = int(rng.integers(5, 12)), int(rng.integers(1, 4))
    xs = _corpus(mld, n, seed + 91)
    pmld = _port(mld)
    mesh = make_mesh({"data": shards}, devices=["cpu"] * shards)
    _inject(monkeypatch, hsc_torch.models.coder, hsc_torch.ops.pipeline)
    got = CorpusEncoder(pmld, device="cpu", batch_size=bs, mesh=mesh).encode(xs)
    jax_mesh = jax_make_mesh({"data": shards}, devices=jax.devices()[:shards])
    assert got == JaxCorpusEncoder(mld, backend="jax", batch_size=bs, mesh=jax_mesh).encode(xs), (cfg, n, bs)
    monkeypatch.undo()
    sharded = CorpusEncoder(pmld, device="cpu", batch_size=bs, mesh=mesh)
    local = CorpusEncoder(pmld, device="cpu", batch_size=bs)
    blob = sharded.encode(xs)
    assert blob == local.encode(xs), (cfg, n, bs)
    assert sharded.decode(blob).tobytes() == local.decode(blob).tobytes(), (cfg, n, bs)


# -- the samplers --------------------------------------------------------------


def _cache_fits(k, npos, ns):
    """csrc/mp_encode.cu's shared-memory test, written out again: the
    selection cache (npos rounded up to 128, a float and a 16-bit atom
    each), the candidates (an 8-byte key and 10 ints each) and the K
    weights within the H100's 227 KiB opt-in less the kernel's 16 static
    bytes."""
    cache = (npos + 127) // 128 * 128 * (4 + 2)
    rest = 8 * ns + 4 * k + 4 * 10 * ns
    return cache + rest <= 227 * 1024 - 16


def test_new_samplers_reach_the_routes():
    """Over seeds 0-63: the long sampler draws level-0 geometries on both
    sides of the loop kernel's shared-memory limit, some within 1024
    positions of it on each side, and 2-level shapes whose level-0 event
    buffers lie on both sides of 16384 (the int8 init's global sort); the
    batch sampler draws corpora past the H100's 132 SMs and below; the
    3-level sampler both hand-offs; the f32 container sampler f32 at 2 and
    3 levels.  The script's H100 rules agree with the limits written out
    here and with the kernels' answers logged on the card (phase 11's 65536
    samples: 393216 bytes; phase 12's 20000 events: a global sort)."""
    assert fuzz.loop_workspace_bytes(16, 65505, 8) == 393216
    assert fuzz.loop_workspace_bytes(64, 16353, 8) == 0
    assert fuzz.int8_sort_workspace_ints(20000) == 3 * 32768 and fuzz.int8_sort_workspace_ints(16384) == 0
    sides, near, sorts, corpora, inits, f32_levels = set(), set(), set(), set(), set(), set()
    for seed in range(64):
        kw = fuzz.sample_long_shape(np.random.default_rng(seed))
        k, w, ns = kw["counts"][0], kw["scales"][0], kw["num_select"]
        npos = kw["block_size"] - w + 1
        assert 12288 <= kw["block_size"] <= 65536
        fits = _cache_fits(k, npos, ns)
        assert (fuzz.loop_workspace_bytes(k, npos, ns) == 0) == fits, kw
        assert _cache_fits(k, fuzz.loop_smem_npos(k, ns), ns) and not _cache_fits(k, fuzz.loop_smem_npos(k, ns) + 1, ns)
        sides.add(fits)
        if abs(npos - fuzz.loop_smem_npos(k, ns)) <= 1024:
            near.add(fits)
        if len(kw["counts"]) == 2:
            sorts.add(kw["num_coefs"][0] > 16384)
            assert (fuzz.int8_sort_workspace_ints(kw["num_coefs"][0]) > 0) == (kw["num_coefs"][0] > 16384)
        corpora.add(fuzz.sample_batch_shape(np.random.default_rng(seed))["corpus"][0] > fuzz.H100_SMS)
        inits.add(fuzz.sample_three_level_shape(np.random.default_rng(seed))["hier_init"])
        kw = fuzz.sample_container_f32_shape(np.random.default_rng(seed))
        if kw["hier_init"] == "f32":
            f32_levels.add(len(kw["counts"]))
    assert sides == near == sorts == corpora == {True, False}
    assert inits == {"int8", "f32"} and f32_levels == {2, 3}


# scripts/torch_fuzz_parity.py's container sampler as it was before the new
# modes: chip_smoke.py phase 15a's fixed seeds draw from it
CONTAINER_SAMPLER_SOURCE = '''def sample_container_shape(rng: np.random.Generator) -> dict:
    """A container geometry: 1 or 2 levels with no SNR stop, and its
    entropy coder."""
    two_level = rng.random() < 0.5
    kw = sample_hier_shape(rng) if two_level else sample_shape(rng)
    kw.pop("tolerance_snr", None)
    kw["entropy"] = str(rng.choice(["fixed", "rice"]))
    return kw
'''

# what phase 15a's fixed seeds drew on the card before the new modes
# (chip_smoke.py at fuzz base seed 1, "NVIDIA H100 80GB HBM3, 700.00 W"):
# the hierarchical seeds' geometry and events, the container seeds' draws
PHASE15_HIER = {
    1001: dict(ns=9, hier_init="int8", counts=[40, 3], scales=[44, 132], block=4680, nc=[37, 15], amp_bits=15,
               events=[[37, 15], [37, 15]]),
    1003: dict(ns=39, hier_init="f32", counts=[29, 8], scales=[19, 38], block=2539, nc=[71, 31], amp_bits=13,
               events=[[71, 31], [71, 31]]),
}
PHASE15_CONTAINER = {
    1001: dict(counts=[74], scales=[165], block=515, nc=[138], entropy="fixed", distributed=False, target_bps=0.398,
               rate_mode="corpus", index=False, decode_mode="integer", streams=[[0], [0], [0]]),
    1003: dict(counts=[16, 13], scales=[31, 62], block=7172, nc=[90, 37], entropy="fixed", distributed=True,
               target_bps=None, rate_mode="block", index=False, decode_mode="integer", streams=[[0, 1], [0], [0]]),
}


def test_old_samplers_draw_as_before():
    """`sample_container_shape`'s source is what it was, and the refactored
    `run_hier_shape` / `run_container_shape` draw at phase 15a's fixed seeds
    what they drew on the card before (their JSON lines' geometry, events
    and sampled options; `sample_shape` and `sample_hier_shape` are held to
    the JAX script by test_torch_fuzz.py)."""
    assert inspect.getsource(fuzz.sample_container_shape) == CONTAINER_SAMPLER_SOURCE
    for seed, want in PHASE15_HIER.items():
        r = json.loads(json.dumps(fuzz.run_hier_shape(seed, "cpu")))
        assert r["ok"] and {k: r[k] for k in want} == want, r
    for seed, want in PHASE15_CONTAINER.items():
        r = json.loads(json.dumps(fuzz.run_container_shape(seed, "cpu")))
        assert r["ok"] and {k: r[k] for k in want} == want, r


# -- the new modes at --device cpu -------------------------------------------


# seeds whose sampled geometry is small, each the first of its --base-seed:
# batch 186000 (2 levels, 7 blocks of 548 samples at batch 1, 5, 7), long
# 242000 (6 atoms of 31, 38796-sample blocks: past the H100's shared memory
# by the H100 rule), three-level 311000 (f32 hand-off, counts 6 / 14 / 5),
# container-f32 353000 (3 levels, f32, distributed, CBR over the corpus),
# mesh 291000 (3 levels, f32, 4 shards, 14 blocks at batch 7, SP and TP)
NEW_MODES = [("batch", 186), ("long", 242), ("three-level", 311), ("container-f32", 353), ("mesh", 291)]


@pytest.mark.parametrize("mode,base_seed", NEW_MODES)
def test_new_modes_on_cpu(capsys, mode, base_seed):
    """Each new mode of scripts/torch_fuzz_parity.py through its command
    line at `--device cpu` (the plain paths): one shape, bitwise, exit 0."""
    argv = [f"--{mode}", "--device", "cpu", "--shapes", "1", "--base-seed", str(base_seed)]
    assert fuzz.main(argv) == 0
    line, summary = capsys.readouterr().out.strip().splitlines()
    r = json.loads(line)
    assert r["seed"] == base_seed * 1000 and r["ok"] and r["diff"] is None, r
    assert summary.startswith("1/1 ")
    if mode == "long":
        assert r["h100_rule_mp_workspace_bytes"][0] > 0 and r["mp_workspace_bytes"] is None
    if mode == "container-f32":
        assert r["hier_init"] == "f32" and r["distributed"]
    if mode == "mesh":
        assert r["sp_tp"] and r["shards"] == 4
