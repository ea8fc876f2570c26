"""Random-geometry parity fuzz of the PyTorch / CUDA port: codec geometries
sampled anew per seed, encoded (and decoded) by the hand-written CUDA
kernels on the card, bitwise against the port's NumPy oracle given the
port's own init, and against the kernels' plain PyTorch versions.

The counterpart of scripts/fuzz_tpu_parity.py.  Fixed geometries missed
the reference's own silent kernel bug (an integer decode that was wrong at
widths no pin covered), so every run of a new --base-seed extends what the
card has held.  Eight modes:

  flat (default)  one level through `ConvolutionalMatchingPursuit`: the
                  kernel loop bitwise the plain loop on the same init and
                  the oracle `mp_encode` with that init injected;
  --hierarchical  a 2-level hierarchy (int8 or f32 hand-off) through
                  `HierarchicalConvolutionalSparseCoder`: every level
                  bitwise `pinned.oracle_hierarchical_pinned` and the plain
                  backend, the top stream decoded in both modes bitwise the
                  oracle;
  --container     the container path through `CorpusEncoder` (fixed / rice
                  entropy, distributed, both CBR modes, the seek index):
                  the same bytes twice, the card's rows byte-identical to a
                  `python -m hsc_torch.cli decode --device cpu` subprocess
                  of the same file and bitwise the oracle's decode of the
                  unpacked streams;
  --batch         a flat or 2-level corpus of 5-200 blocks (past the H100's
                  132 SMs in about one draw in three, so the loop kernel
                  runs in waves): the level-0 init of every block the same
                  bits at batch 1, at an odd batch and at the whole corpus,
                  `CorpusEncoder`'s container byte-identical at those batch
                  sizes and its rows bitwise the oracle's decode, every
                  level's kernel loop bitwise the plain loop on the same
                  init, the first and last blocks bitwise the pinned oracle;
  --long          blocks of 12288-65536 samples, about half past the loop
                  kernel's shared memory on an H100 (its selection cache in a
                  global workspace), some within 1024 positions of that
                  boundary; one in three a 2-level hierarchy whose level 0
                  keeps 12000-24000 events, so the int8 init's sort falls on
                  both sides of 16384 (past it, a global workspace).  Flat:
                  the kernel loop bitwise the plain loop, and the oracle
                  only where it is cheap (`ORACLE_CELLS`); 2-level: the int8
                  init and every level bitwise backend='torch'.  Each line
                  logs the kernels' `mp_workspace_bytes` and
                  `int8_sort_workspace_ints` beside the H100 rules;
  --three-level   a 3-level hierarchy (int8 or f32 hand-off), checked as
                  --hierarchical checks 2 levels;
  --container-f32 2- and 3-level containers, hier_init 'f32' in two draws of
                  three, checked as --container checks its own;
  --mesh          a 1-3 level ragged corpus on a mesh of 2-4 shards of one
                  device: `CorpusEncoder(mesh=...)`, `DataParallelEncoder`
                  and `HierarchicalDataParallelEncoder` the local path's,
                  `DataParallelDecoder`'s rows the local decode in both
                  modes, and `sp_loop` / `tp_loop` on block 0, given the
                  local init, bitwise the local kernel loop.

    python scripts/torch_fuzz_parity.py --shapes 8 --base-seed 0
    python scripts/torch_fuzz_parity.py --hierarchical --shapes 4 --base-seed 0
    python scripts/torch_fuzz_parity.py --container --shapes 4 --base-seed 0
    python scripts/torch_fuzz_parity.py --batch --shapes 4 --base-seed 0
    python scripts/torch_fuzz_parity.py --long --shapes 8 --base-seed 0
    python scripts/torch_fuzz_parity.py --three-level --shapes 4 --base-seed 0
    python scripts/torch_fuzz_parity.py --container-f32 --shapes 4 --base-seed 0
    python scripts/torch_fuzz_parity.py --mesh --shapes 4 --base-seed 0
    python scripts/torch_fuzz_parity.py --mesh --cards 4 --shapes 4 --base-seed 0   # shard i on card i mod 4

`--device` defaults to 'cuda' and raises without a card; `--device cpu`
runs the plain paths.  One JSON line per shape (seed ``base_seed * 1000 +
i``; ``run_s`` the device encode, ``wall_s`` the whole shape with its
checks; ``diff`` the first difference found, an event where one differs),
then a summary line; the exit code is 1 if any shape failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from hsc_torch import MultilevelDictionary, SignalGenerator, _build, make_test_config  # noqa: E402
from hsc_torch.device import resolve_device  # noqa: E402
from hsc_torch.io import unpack_corpus  # noqa: E402
from hsc_torch.models import HierarchicalConvolutionalSparseCoder  # noqa: E402
from hsc_torch.models.coder import ConvolutionalMatchingPursuit, to_host  # noqa: E402
from hsc_torch.ops.encode import encode_init_batched, mp_encode_from_init_torch, quantizer_steps  # noqa: E402
from hsc_torch.ops.mp_kernels import mp_loop  # noqa: E402
from hsc_torch.oracle import hierarchical_decode  # noqa: E402
from hsc_torch.oracle.mp import mp_decode_integer, rep_quantize  # noqa: E402
from hsc_torch.pinned import oracle_encode_pinned, oracle_hierarchical_pinned  # noqa: E402
from hsc_torch.runtime import CorpusEncoder  # noqa: E402


def sample_shape(rng: np.random.Generator) -> dict:
    """One random geometry, weighted toward the zones that have bitten:
    non-multiple-of-8 atom counts, wide windows, short blocks, sweep folds."""
    wide = rng.random() < 0.25
    if wide:
        w = int(rng.integers(130, 200))
        block = int(rng.integers(w * 2, w * 8))
    else:
        w = int(rng.integers(6, 80))
        block = int(rng.integers(max(w * 4, 512), 12288))
    k = int(rng.integers(3, 96))
    nc = int(rng.integers(8, 160))
    amp_bits = int(rng.integers(8, 17))
    tol = float(rng.uniform(4.0, 18.0)) if rng.random() < 0.3 else None
    return dict(
        counts=(k,), scales=(w,), block_size=block, num_coefs=(nc,),
        amp_bits=amp_bits, tolerance_snr=tol,
    )


def sample_hier_shape(rng: np.random.Generator) -> dict:
    """Random 2-level geometry: level-1 windows cover several level-0
    scales (the reference's atoms-of-atoms structure), counts include
    non-multiple-of-8 zones (Mosaic sublane padding)."""
    w0 = int(rng.integers(8, 48))
    w1_factor = int(rng.integers(2, 5))
    k0 = int(rng.integers(4, 48))
    k1 = int(rng.integers(3, 24))
    block = int(rng.integers(w0 * w1_factor * 8, 8192))
    nc0 = int(rng.integers(16, 128))
    nc1 = int(rng.integers(8, max(nc0 // 2, 9)))
    return dict(
        counts=(k0, k1), scales=(w0, w0 * w1_factor),
        block_size=block, num_coefs=(nc0, nc1),
        amp_bits=int(rng.integers(8, 17)),
    )


def sample_container_shape(rng: np.random.Generator) -> dict:
    """A container geometry: 1 or 2 levels with no SNR stop, and its
    entropy coder."""
    two_level = rng.random() < 0.5
    kw = sample_hier_shape(rng) if two_level else sample_shape(rng)
    kw.pop("tolerance_snr", None)
    kw["entropy"] = str(rng.choice(["fixed", "rice"]))
    return kw


# The routes the kernels take on an H100 (227 KiB of shared memory per block
# by opt-in, 132 SMs).  `sample_long_shape` aims at both sides of each
# shared-memory boundary with these rules, copied from the kernels' host code;
# on a card the script logs the kernels' own answers beside them.
H100_SMEM_OPTIN = 227 * 1024
H100_SMS = 132
LOOP_STATIC_SMEM = 16  # csrc/mp_encode.cu's static shared memory (ptxas)


def loop_rest_bytes(k: int, num_select: int) -> int:
    """csrc/mp_encode.cu's `rest_bytes`: the loop kernel's shared memory
    beside its selection cache (per candidate an 8-byte key and 10 words,
    per atom a weight)."""
    return 8 * num_select + 4 * k + 40 * num_select


def loop_workspace_bytes(k: int, npos: int, num_select: int, limit: int = H100_SMEM_OPTIN - LOOP_STATIC_SMEM) -> int:
    """csrc/mp_encode.cu's `hsc_mp_encode_workspace`: 0 while the greedy
    loop's selection cache (`cache_bytes`: npos rounded up to 128, 6 bytes
    each) and `loop_rest_bytes` fit `limit` bytes, else the cache's bytes,
    which then go to a global workspace."""
    cache = -(-npos // 128) * 128 * 6
    return 0 if cache + loop_rest_bytes(k, num_select) <= limit else cache


def loop_smem_npos(k: int, num_select: int, limit: int = H100_SMEM_OPTIN - LOOP_STATIC_SMEM) -> int:
    """The most positions whose selection cache still fits in shared memory
    at `k` atoms and `num_select`."""
    return (limit - loop_rest_bytes(k, num_select)) // 768 * 128


def int8_sort_workspace_ints(m: int, limit: int = H100_SMEM_OPTIN) -> int:
    """csrc/sparse_init.cu's `hsc_int8_init_workspace`: 0 while the cell
    kernel's sort of a block's `m` events (3 ints for each of P, the next
    power of two >= m) fits in shared memory, else 3 P ints of global
    workspace (past P = 16384; the kernel's few hundred bytes of static
    shared memory move no power of two across the limit)."""
    p = 1
    while p < m:
        p <<= 1
    return 0 if 12 * p <= limit else 3 * p


def sample_batch_shape(rng: np.random.Generator) -> dict:
    """A flat or 2-level geometry at `sample_shape`'s or
    `sample_hier_shape`'s ranges, with a corpus of 5-200 blocks (past the
    H100's 132 SMs, so the loop kernel's one CTA per block runs in waves, in
    about one draw in three) and an odd batch size that leaves a ragged
    last batch: ``corpus`` is ``(n_blocks, batch_size)``."""
    kw = sample_hier_shape(rng) if rng.random() < 0.5 else sample_shape(rng)
    n = int(rng.integers(H100_SMS + 1, 201)) if rng.random() < 0.35 else int(rng.integers(5, H100_SMS + 1))
    kw["corpus"] = (n, int(rng.choice([b for b in range(3, n, 2) if n % b])))
    return kw


def sample_long_shape(rng: np.random.Generator) -> dict:
    """A long-block geometry: 12288-65536 samples.  About half of them need
    the greedy loop's global workspace on an H100 (`loop_workspace_bytes`),
    and two draws in five put the level-0 positions within 1024 of that
    boundary, on either side.  One draw in three is a 2-level hierarchy
    whose level 0 keeps 12000-24000 coefficients, so the level-1 int8
    init's sort of them falls on both sides of 16384 events (past it, a
    global workspace); its num_select is 8-48, because the plain loop that
    holds it takes num_coefs / num_select sweeps."""
    two_level = rng.random() < 1 / 3
    k = int(rng.integers(4, 49) if two_level else rng.integers(3, 97))
    w = int(rng.integers(8, 48) if two_level else rng.integers(6, 80))
    ns = int(rng.integers(8, 49) if two_level else rng.integers(1, 49))
    if rng.random() < 0.4:
        npos = loop_smem_npos(k, ns) + int(rng.integers(-1024, 1025))
    else:
        npos = int(rng.integers(12288, 65537)) - w + 1
    block = min(max(npos + w - 1, 12288), 65536)
    kw = dict(counts=(k,), scales=(w,), block_size=block, num_coefs=(int(rng.integers(16, 513)),),
              amp_bits=int(rng.integers(8, 17)), num_select=ns)
    if two_level:
        kw.update(counts=(k, int(rng.integers(3, 25))), scales=(w, w * int(rng.integers(2, 5))),
                  num_coefs=(int(rng.integers(12000, 24001)), int(rng.integers(8, 257))), hier_init="int8")
    return kw


def sample_three_level_shape(rng: np.random.Generator) -> dict:
    """A random 3-level geometry: each scale a multiple (2-4, then 2-3) of
    the one below, as phase 14b's (32, 96, 288), counts drawn freely (so
    mostly not multiples of 8), and `hier_init` 'int8' or 'f32'."""
    w0 = int(rng.integers(8, 40))
    w1 = w0 * int(rng.integers(2, 5))
    w2 = w1 * int(rng.integers(2, 4))
    nc0 = int(rng.integers(16, 160))
    nc1 = int(rng.integers(8, max(nc0 // 2, 9)))
    return dict(
        counts=(int(rng.integers(4, 41)), int(rng.integers(3, 25)), int(rng.integers(3, 17))),
        scales=(w0, w1, w2), block_size=int(rng.integers(w2 * 6, 12288)),
        num_coefs=(nc0, nc1, int(rng.integers(4, max(nc1 // 2, 5)))),
        amp_bits=int(rng.integers(8, 17)), hier_init=str(rng.choice(["int8", "f32"])),
    )


def sample_container_f32_shape(rng: np.random.Generator) -> dict:
    """A 2- or 3-level container geometry whose `hier_init` is 'f32' in two
    draws of three ('int8' else), and its entropy coder."""
    kw = sample_three_level_shape(rng) if rng.random() < 0.5 else sample_hier_shape(rng)
    kw["hier_init"] = "f32" if rng.random() < 2 / 3 else "int8"
    kw["entropy"] = str(rng.choice(["fixed", "rice"]))
    return kw


def sample_mesh_shape(rng: np.random.Generator, shards: int) -> dict:
    """A flat, 2-level or 3-level geometry for a mesh of `shards`: the block
    a multiple of `shards` (sequence parallelism splits it evenly) and the
    level-0 count too (tensor parallelism splits the atoms)."""
    pick = rng.random()
    kw = sample_shape(rng) if pick < 1 / 3 else sample_hier_shape(rng) if pick < 2 / 3 else sample_three_level_shape(rng)
    kw.pop("tolerance_snr", None)
    kw["block_size"] -= kw["block_size"] % shards
    k0 = kw["counts"][0]
    kw["counts"] = (max(shards, k0 - k0 % shards), *kw["counts"][1:])
    return kw


def generate(rng: np.random.Generator, sample, seed: int):
    """A geometry drawn by ``sample(rng)`` (a ``corpus`` key is not the
    config's) and its dictionary (seed `seed`).
    Some sampled geometries cannot generate a dictionary (the coherence
    rejection sampler exhausts, e.g. many atoms over a short window): those
    are drawn again from `rng`, up to 8 times, so the sweep stays
    deterministic.  Returns ``(kw, mld)``."""
    for _attempt in range(8):
        kw = sample(rng)
        try:
            cfg = make_test_config(**{k: v for k, v in kw.items() if k != "corpus"})
            return kw, MultilevelDictionary.generate(cfg, seed=seed)
        except RuntimeError:
            continue
    raise RuntimeError("no generatable geometry in 8 draws")


def first_event_diff(got, want) -> str | None:
    """Where stream `got` first differs from stream `want` (positions,
    atoms, codes, count, scale), or None if those fields are equal."""
    n, m = got.positions.shape[0], want.positions.shape[0]
    for i in range(min(n, m)):
        g = (int(got.positions[i]), int(got.atoms[i]), int(got.codes[i]))
        w = (int(want.positions[i]), int(want.atoms[i]), int(want.codes[i]))
        if g != w:
            return f"event {i}: (position, atom, code) {g} vs {w}"
    if n != m:
        return f"count {n} vs {m}"
    if np.float32(got.scale) != np.float32(want.scale):
        return f"scale {np.float32(got.scale)!r} vs {np.float32(want.scale)!r}"
    return None


def flat_parity(mld, xs, device, *, num_select=1, singleton_weight=1.0, n_raw=None, oracle_blocks=None) -> dict:
    """Level 0 of `mld` on the blocks ``xs [B, N]`` through
    `ConvolutionalMatchingPursuit` on `device`.  On a card the kernel's
    result must equal the plain loop on the same init bit for bit; every
    block in `oracle_blocks` (default: all) must equal
    `pinned.oracle_encode_pinned`, the oracle `mp_encode` with the port's
    init of that block injected (positions, atoms, codes, count, scale,
    energy_res): the init is the same bits at every batch size.  Returns
    ``ok``, the kernel's seconds and the first difference found."""
    cfg = mld.config
    dev = resolve_device(device)
    k = mld.num_atoms(0)
    n_raw = k if n_raw is None else n_raw
    mp = ConvolutionalMatchingPursuit(
        mld.augmented(0), mld.gram(0), num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits,
        tolerance_snr=cfg.tolerance_snr, num_select=num_select, singleton_weight=singleton_weight,
        n_raw=n_raw, device=dev,
    )
    xb = torch.from_numpy(np.ascontiguousarray(xs, np.float32)).to(dev)
    t0 = time.perf_counter()
    enc = mp.compute_coefficients_batch(xb)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    diff = None
    if dev.type == "cuda":
        s0, e0, peak = encode_init_batched(xb[:, :, None], mp.bank)
        scale, inv = (torch.from_numpy(a).to(dev) for a in quantizer_steps(peak.cpu().numpy(), cfg.amp_bits))
        plain = mp_encode_from_init_torch(s0.clone(), e0, scale, inv, mp.params, **mp.settings)
        for name, a, b in zip(enc._fields, enc, plain):
            if not torch.equal(a, b):
                diff = f"kernel != plain in {name}"
                break
    host = to_host(enc)
    for b in range(xs.shape[0]) if oracle_blocks is None else oracle_blocks:
        if diff is not None:
            break
        ref = oracle_encode_pinned(np.asarray(xs[b], np.float32)[:, None], mld, 0, dev, num_select=num_select,
                                   singleton_weight=singleton_weight, n_raw=n_raw)
        n = int(host.count[b])
        got = dataclasses.replace(
            ref, positions=host.positions[b, :n], atoms=host.atoms[b, :n], codes=host.codes[b, :n],
            scale=np.float32(host.scale[b]),
        )
        where = first_event_diff(got, ref)
        if where is None and host.energy_res[b] != np.float32(ref.energy_res):
            where = f"energy_res {host.energy_res[b]!r} vs {np.float32(ref.energy_res)!r}"
        if where is not None:
            diff = f"block {b} vs oracle: {where}"
    return dict(ok=diff is None, run_s=round(seconds, 3), diff=diff,
                events=[int(c) for c in host.count])


def run_shape(seed: int, device: str = "cuda") -> dict:
    """One random single-level geometry (`sample_shape`): two blocks through
    `flat_parity` at `num_select` 1-48, `singleton_weight` 0.9 and
    ``n_raw = max(K - 2, 1)``."""
    rng = np.random.default_rng(seed)
    kw, mld = generate(rng, sample_shape, seed + 17)
    cfg = mld.config
    gen = SignalGenerator(mld, rates=float(rng.uniform(1e-3, 1e-2)))
    xs = gen.generate_signals(2, cfg.block_size, seed=seed)
    ns = int(rng.integers(1, 49))
    k = kw["counts"][0]
    r = flat_parity(mld, xs, device, num_select=ns, singleton_weight=0.9, n_raw=max(k - 2, 1))
    return dict(
        seed=seed, ok=r["ok"], run_s=r["run_s"], ns=ns, k=k, w=kw["scales"][0],
        block=kw["block_size"], nc=kw["num_coefs"][0], amp_bits=kw["amp_bits"],
        tol=kw["tolerance_snr"], events=r["events"], diff=r["diff"],
    )


def run_hier_shape(seed: int, device: str = "cuda") -> dict:
    """One random 2-level hierarchy (`sample_hier_shape`, `num_select`
    1-48, `hier_init` int8 or f32) through the coder: every level of both
    blocks bitwise `oracle_hierarchical_pinned` and the plain backend, the
    top streams decoded in both modes bitwise the oracle."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    kw, mld = generate(rng, sample_hier_shape, seed + 23)
    ns = int(rng.integers(1, 49))
    hier_init = str(rng.choice(["int8", "f32"])) if mld.config.hier_init == "int8" else "f32"
    cfg = dataclasses.replace(mld.config, num_select=ns, hier_init=hier_init)
    mld = MultilevelDictionary(cfg, mld.dicts)
    gen = SignalGenerator(mld, rates=float(rng.uniform(2e-3, 1e-2)))
    xs = gen.generate_signals(2, cfg.block_size, seed=seed)
    r = hierarchy_parity(mld, xs, dev)
    return dict(
        seed=seed, ok=r["diff"] is None, run_s=r["run_s"], ns=ns, hier_init=hier_init,
        counts=kw["counts"], scales=kw["scales"], block=kw["block_size"], nc=kw["num_coefs"],
        amp_bits=kw["amp_bits"], events=r["events"], diff=r["diff"], hier=True,
    )


def hierarchy_parity(mld, xs, dev) -> dict:
    """The blocks ``xs [B, N]`` through `HierarchicalConvolutionalSparseCoder`
    on `dev`: every level of every block bitwise `oracle_hierarchical_pinned`
    and the plain backend, the top streams decoded in both modes bitwise the
    oracle.  Returns the coder's seconds, the events per block and level,
    and the first difference found (None if none)."""
    cfg = mld.config
    top_level = cfg.num_levels - 1
    coder = HierarchicalConvolutionalSparseCoder(mld, device=dev)
    t0 = time.perf_counter()
    batch = coder.encode_batch(xs)
    seconds = time.perf_counter() - t0
    plain = HierarchicalConvolutionalSparseCoder(mld, backend="torch", device=dev).encode_batch(xs)
    rep_q, step = rep_quantize(mld.representations(top_level)[:, :, None], cfg.rep_bits)
    diff = None
    for b in range(xs.shape[0]):
        refs = oracle_hierarchical_pinned(xs[b], mld, dev)
        for level in range(cfg.num_levels):
            for what, want in (("oracle", refs[level]), ("plain", plain[b][level])):
                where = first_event_diff(batch[b][level], want)
                if diff is None and where is not None:
                    diff = f"block {b} level {level} vs {what}: {where}"
        top = batch[b][top_level]
        if diff is None and coder.reconstruct(top, mode="ordered").tobytes() != hierarchical_decode(top, mld).tobytes():
            diff = f"block {b}: ordered decode != oracle.hierarchical_decode"
        want = mp_decode_integer(top, rep_q, step, cfg.block_size)[:, 0]
        if diff is None and coder.reconstruct(top).tobytes() != want.tobytes():
            diff = f"block {b}: {cfg.decode_mode} decode != oracle.mp.mp_decode_integer"
    return dict(run_s=round(seconds, 3), diff=diff,
                events=[[s.positions.shape[0] for s in blk] for blk in batch])


def oracle_rows(blob: bytes, mld) -> np.ndarray:
    """The NumPy oracle's decode of a container: each block's streams
    decoded in the header's mode and summed in container order."""
    hdr, blocks = unpack_corpus(blob)
    out = np.zeros((len(blocks), hdr.block_size), np.float32)
    for b, streams in enumerate(blocks):
        for level, st in streams:
            if hdr.decode_mode == "integer":
                rq, step = rep_quantize(mld.representations(level)[:, :, None], hdr.rep_bits)
                out[b] += mp_decode_integer(st, rq, step, hdr.block_size)[:, 0]
            else:
                out[b] += hierarchical_decode(st, mld, level=level)
    return out


def cli_decode_cpu(mld, blob: bytes) -> np.ndarray:
    """Rows of `blob` from ``python -m hsc_torch.cli decode --device cpu``
    in a subprocess."""
    with tempfile.TemporaryDirectory() as td:
        paths = {k: os.path.join(td, k) for k in ("d.npz", "c.hsct", "r.npy")}
        mld.save(paths["d.npz"])
        with open(paths["c.hsct"], "wb") as f:
            f.write(blob)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
        r = subprocess.run(
            [sys.executable, "-m", "hsc_torch.cli", "decode", "--dict", paths["d.npz"],
             "--input", paths["c.hsct"], "--output", paths["r.npy"], "--device", "cpu"],
            capture_output=True, text=True, timeout=900, cwd=REPO, env=env,
        )
        if r.returncode != 0:
            raise RuntimeError(f"CLI decode failed: {r.stderr[-400:]}")
        return np.load(paths["r.npy"])


def run_container_shape(seed: int, device: str = "cuda") -> dict:
    """One random geometry (1 or 2 levels) through the container path:
    entropy, distributed, CBR (both rate modes) and the seek index sampled
    as scripts/fuzz_tpu_parity.py samples them (a geometry that cannot
    generate a dictionary is drawn again with its entropy coder, and only a
    2-level one is distributed).  Two encodes give the same
    bytes; the device's rows are byte-identical to a CPU decode of the same
    file in a subprocess and bitwise the oracle's decode of the unpacked
    streams.  Container bytes are not compared across devices: the level-0
    init is held only to a tolerance there."""
    return container_parity(seed, device, sample_container_shape, seed + 31)


def container_parity(seed: int, device, sample, dict_seed: int) -> dict:
    """`run_container_shape`'s draws and checks on a geometry drawn by
    ``sample(rng)`` with its dictionary from `dict_seed`: a hierarchy of
    2 or more levels is distributed in one draw of two."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    kw, mld = generate(rng, sample, dict_seed)
    cfg = mld.config
    distributed = bool(cfg.num_levels >= 2 and rng.random() < 0.5)
    # CBR sampled: None / per-block / corpus at a truncating-ish rate
    mode_pick = rng.random()
    target_bps, rate_mode = None, "block"
    if mode_pick < 0.4:
        target_bps = float(rng.uniform(0.2, 1.5))
        rate_mode = "corpus" if rng.random() < 0.5 else "block"
    gen = SignalGenerator(mld, rates=float(rng.uniform(2e-3, 8e-3)))
    xs = gen.generate_signals(3, cfg.block_size, seed=seed)
    enc = CorpusEncoder(mld, device=dev, batch_size=3, distributed=distributed,
                        target_bps=target_bps, rate_mode=rate_mode)
    use_index = bool(rng.random() < 0.5)
    t0 = time.perf_counter()
    try:
        blob = enc.encode(xs, index=use_index)
    except ValueError as e:
        if target_bps is None or "floor" not in str(e):
            raise
        # sampled rate below the empty-stream floor: resample as VBR
        enc = CorpusEncoder(mld, device=dev, batch_size=3, distributed=distributed)
        target_bps, rate_mode = None, "block"
        blob = enc.encode(xs, index=use_index)
    same = enc.encode(xs, index=use_index) == blob
    rows = enc.decode(blob)
    seconds = time.perf_counter() - t0
    rows_cpu = cli_decode_cpu(mld, blob)
    diff = None
    if not same:
        diff = "two encodes gave different bytes"
    elif rows_cpu.shape != rows.shape or rows_cpu.tobytes() != rows.tobytes():
        diff = f"device rows {rows.shape} != CPU CLI rows {rows_cpu.shape}"
    else:
        want = oracle_rows(blob, mld)
        bad = [b for b in range(want.shape[0]) if rows[b].tobytes() != want[b].tobytes()]
        if bad:
            diff = f"rows != oracle decode at blocks {bad}"
    _, blocks = unpack_corpus(blob)
    return dict(
        seed=seed, ok=diff is None, run_s=round(seconds, 3), counts=kw["counts"], scales=kw["scales"],
        block=kw["block_size"], nc=kw["num_coefs"], entropy=cfg.entropy, hier_init=cfg.hier_init,
        distributed=distributed, target_bps=None if target_bps is None else round(target_bps, 3),
        rate_mode=rate_mode, index=use_index, decode_mode=cfg.decode_mode, bytes=len(blob),
        streams=[[lv for lv, _ in s] for s in blocks], diff=diff, container=True,
    )


# the NumPy oracle's cost on a block, in score cells visited: K * npos *
# ceil(num_coefs / num_select) (each sweep scans the whole score buffer); the
# flagship's 6.7e7 took 462 ms a block on the H100's host (PERF.md §6).  The
# long shapes hold a block against the oracle only where this is at most
# ORACLE_CELLS, about a second and a half of NumPy.
ORACLE_CELLS = 2 * 10**8


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same shape, dtype and bits (signed zeros and NaNs included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def first_block(a: torch.Tensor, b: torch.Tensor) -> int:
    """The first block (leading index) where two same-shape batches differ."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).reshape(a.shape[0], -1).any(dim=1).nonzero()[0])


def init_batch_diff(xs: np.ndarray, bank: torch.Tensor, dev, sizes) -> str | None:
    """Where the level-0 init (scores, e0, peak) of the blocks ``xs [B, N]``
    at a batch size in `sizes` first differs from the init of all B blocks
    at once, or None."""
    x = torch.from_numpy(np.ascontiguousarray(xs[:, :, None], np.float32)).to(dev)
    want = encode_init_batched(x, bank)
    for bs in sizes:
        parts = [encode_init_batched(x[i : i + bs], bank) for i in range(0, x.shape[0], bs)]
        for j, name in enumerate(("scores", "e0", "peak")):
            got = torch.cat([p[j] for p in parts])
            if not bits_equal(got, want[j]):
                return f"init {name} at batch {bs} != at batch {x.shape[0]}, first at block {first_block(got, want[j])}"
        del parts
    return None


def loop_parity_diff(coder, xs: np.ndarray, dev) -> str | None:
    """On a card, every level's kernel loop against the plain loop on the
    same init (a level's init made from the kernel's events of the level
    below), block for block; the first difference, or None.  On the CPU
    both are the plain loop: None."""
    if dev.type != "cuda":
        return None
    seq = torch.from_numpy(np.ascontiguousarray(xs[:, :, None], np.float32)).to(dev)
    for level, c in enumerate(coder.coders):
        mp = c.mp
        s0, e0, peak = mp.init_int_batched(*seq) if mp.int8_init else encode_init_batched(seq, mp.bank)
        sc, iv = (torch.from_numpy(a).to(dev) for a in quantizer_steps(peak.cpu().numpy(), mp.settings["amp_bits"]))
        plain = mp_encode_from_init_torch(s0, e0, sc, iv, mp.params, **mp.settings)
        enc = mp_loop(s0.clone(), e0, sc, iv, mp.params, **mp.settings)
        for name, a, b in zip(enc._fields, enc, plain):
            if not bits_equal(a, b):
                return f"level {level}: kernel != plain in {name}, first at block {first_block(a, b)}"
        if level + 1 < len(coder.coders):
            seq = coder.handoff(level, enc)
    return None


def run_batch_shape(seed: int, device: str = "cuda") -> dict:
    """One random corpus (`sample_batch_shape`: flat or 2-level, 5-200
    blocks, `num_select` 1-48): the level-0 init of every block bitwise the
    same at batch 1, at an odd batch and at the whole corpus;
    `CorpusEncoder`'s container byte-identical at those three batch sizes,
    its top streams those of the coder's whole-corpus encode and its rows
    bitwise the oracle's decode; on a card every level's kernel loop
    bitwise the plain loop on the same init; the first and last blocks
    bitwise `oracle_hierarchical_pinned` at every level (and level 0's
    energy_res)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    kw, mld = generate(rng, sample_batch_shape, seed + 41)
    n, odd = kw["corpus"]
    ns = int(rng.integers(1, 49))
    cfg = dataclasses.replace(mld.config, num_select=ns)
    mld = MultilevelDictionary(cfg, mld.dicts)
    gen = SignalGenerator(mld, rates=float(rng.uniform(2e-3, 1e-2)))
    xs = gen.generate_signals(n, cfg.block_size, seed=seed)
    coder = HierarchicalConvolutionalSparseCoder(mld, device=dev)
    diff = init_batch_diff(xs, coder.coders[0].mp.bank, dev, (1, odd))
    t0 = time.perf_counter()
    blobs = {bs: CorpusEncoder(mld, device=dev, batch_size=bs).encode(xs) for bs in (1, odd, n)}
    seconds = time.perf_counter() - t0
    blob = blobs[n]
    if diff is None and any(b != blob for b in blobs.values()):
        diff = f"containers differ: bytes at batch 1, {odd}, {n}: {[len(b) for b in blobs.values()]}"
    if diff is None:
        rows = CorpusEncoder(mld, device=dev, batch_size=n).decode(blob)
        want = oracle_rows(blob, mld)
        bad = [b for b in range(n) if rows[b].tobytes() != want[b].tobytes()]
        if bad:
            diff = f"rows != oracle decode at blocks {bad[:8]}"
    if diff is None:
        diff = loop_parity_diff(coder, xs, dev)
    streams = coder.encode_batch(xs)
    top = cfg.num_levels - 1
    _, blocks = unpack_corpus(blob)
    for b in (0, n - 1):
        if diff is not None:
            break
        where = first_event_diff(blocks[b][0][1], streams[b][top])
        if where is not None:
            diff = f"block {b}: container stream vs the coder's: {where}"
            break
        refs = oracle_hierarchical_pinned(xs[b], mld, dev)
        for level in range(cfg.num_levels):
            where = first_event_diff(streams[b][level], refs[level])
            if where is None and level == 0 and np.float32(streams[b][0].energy_res) != np.float32(refs[0].energy_res):
                where = f"energy_res {streams[b][0].energy_res!r} vs {refs[0].energy_res!r}"
            if where is not None:
                diff = f"block {b} level {level} vs oracle: {where}"
                break
    return dict(
        seed=seed, ok=diff is None, run_s=round(seconds, 3), blocks=n, batch_sizes=[1, odd, n],
        waves=-(-n // H100_SMS), ns=ns, counts=kw["counts"], scales=kw["scales"], block=kw["block_size"],
        nc=kw["num_coefs"], amp_bits=kw["amp_bits"], tol=kw.get("tolerance_snr"), bytes=len(blob),
        events=[int(sum(s[level].positions.shape[0] for s in streams)) for level in range(cfg.num_levels)],
        diff=diff, batch=True,
    )


def run_long_shape(seed: int, device: str = "cuda") -> dict:
    """One long-block geometry (`sample_long_shape`), 1-4 blocks.  Flat: the
    kernel loop bitwise the plain loop on the same init (`flat_parity`),
    and block 0 bitwise the oracle where the oracle is cheap (its cost in
    score cells at most `ORACLE_CELLS`).  2-level: the level-1 int8 init of
    the kernel's level-0 events (scores and peak bitwise, e0 within 1e-6
    relative) and every level's events of the whole encode bitwise
    `backend='torch'` (no oracle: level 0 keeps 12000-24000 events).  The
    line logs each level's `mp_workspace_bytes` and the level-1 sort's
    `int8_sort_workspace_ints` from the kernels (null off a card) beside
    the H100 rules of `loop_workspace_bytes` and `int8_sort_workspace_ints`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    kw, mld = generate(rng, sample_long_shape, seed + 43)
    cfg = mld.config
    nb = int(rng.integers(1, 5))
    gen = SignalGenerator(mld, rates=float(rng.uniform(1e-3, 1e-2)))
    xs = gen.generate_signals(nb, cfg.block_size, seed=seed)
    ns, two = cfg.num_select, cfg.num_levels == 2
    geom = [(mld.num_atoms(lv), cfg.num_positions(lv)) for lv in range(cfg.num_levels)]
    rule_ws = [loop_workspace_bytes(k, npos, ns) for k, npos in geom]
    rule_sort = int8_sort_workspace_ints(cfg.num_coefs[0]) if two else None
    ws = sort_ws = None
    if dev.type == "cuda":
        lib = _build.load()
        ws = [int(lib.hsc_mp_encode_workspace(k, npos, ns)) for k, npos in geom]
        sort_ws = int(lib.hsc_int8_init_workspace(cfg.num_coefs[0])) if two else None
    oracle = None
    if not two:
        k, npos = geom[0]
        oracle = k * npos * -(-cfg.num_coefs[0] // ns) <= ORACLE_CELLS
        r = flat_parity(mld, xs, dev, num_select=ns, oracle_blocks=(0,) if oracle else ())
        diff, seconds, events = r["diff"], r["run_s"], [r["events"]]
    else:
        coder = HierarchicalConvolutionalSparseCoder(mld, device=dev)
        plain = HierarchicalConvolutionalSparseCoder(mld, backend="torch", device=dev)
        ev = coder.handoff(0, coder.coders[0].mp.compute_coefficients_batch(xs))
        got = coder.coders[1].mp.init_int_batched(*ev)
        want = plain.coders[1].mp.init_int_batched(*ev)
        diff = None
        for name, a, b in zip(("scores", "peak"), (got[0], got[2]), (want[0], want[2])):
            if not bits_equal(a, b):
                diff = f"level-1 int8 init {name} != backend='torch', first at block {first_block(a, b)}"
                break
        e_rel = float(((got[1].double() - want[1].double()).abs() / want[1].double().abs().clamp_min(1e-30)).max())
        if diff is None and e_rel > 1e-6:
            diff = f"level-1 int8 init e0 off backend='torch' by {e_rel:.3g} relative"
        t0 = time.perf_counter()
        batch = coder.encode_batch(xs)
        seconds = round(time.perf_counter() - t0, 3)
        ref = plain.encode_batch(xs)
        for b in range(nb):
            for level in range(2):
                where = first_event_diff(batch[b][level], ref[b][level])
                if diff is None and where is not None:
                    diff = f"block {b} level {level} vs backend='torch': {where}"
        events = [[s.positions.shape[0] for s in blk] for blk in batch]
    return dict(
        seed=seed, ok=diff is None, run_s=seconds, blocks=nb, ns=ns, counts=kw["counts"], scales=kw["scales"],
        block=kw["block_size"], nc=kw["num_coefs"], amp_bits=kw["amp_bits"], npos=[p for _, p in geom],
        mp_workspace_bytes=ws, h100_rule_mp_workspace_bytes=rule_ws, int8_sort_workspace_ints=sort_ws,
        h100_rule_int8_sort_workspace_ints=rule_sort, oracle=oracle, events=events, diff=diff, long=True,
    )


def run_three_level_shape(seed: int, device: str = "cuda") -> dict:
    """One random 3-level hierarchy (`sample_three_level_shape`,
    `num_select` 1-48, `hier_init` int8 or f32), 2 blocks through
    `hierarchy_parity`: every level bitwise `oracle_hierarchical_pinned`
    and `backend='torch'`, the top streams decoded in both modes bitwise
    the oracle."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    kw, mld = generate(rng, sample_three_level_shape, seed + 47)
    ns = int(rng.integers(1, 49))
    cfg = dataclasses.replace(mld.config, num_select=ns)
    mld = MultilevelDictionary(cfg, mld.dicts)
    gen = SignalGenerator(mld, rates=float(rng.uniform(2e-3, 1e-2)))
    xs = gen.generate_signals(2, cfg.block_size, seed=seed)
    r = hierarchy_parity(mld, xs, dev)
    return dict(
        seed=seed, ok=r["diff"] is None, run_s=r["run_s"], ns=ns, hier_init=cfg.hier_init,
        counts=kw["counts"], scales=kw["scales"], block=kw["block_size"], nc=kw["num_coefs"],
        amp_bits=kw["amp_bits"], decode_mode=cfg.decode_mode, events=r["events"], diff=r["diff"], three_level=True,
    )


def run_container_f32_shape(seed: int, device: str = "cuda") -> dict:
    """One random 2- or 3-level container (`sample_container_f32_shape`:
    `hier_init` f32 in two draws of three) through `container_parity`:
    the same bytes twice, the rows byte-identical to a CPU CLI decode of
    the file in a subprocess and bitwise the oracle's decode."""
    return container_parity(seed, device, sample_container_f32_shape, seed + 53)


# the single-block mesh loops (`sp_loop`, `tp_loop`) launch eager ops per
# coefficient from the host, 2-5 ms each on the H100 (ROADMAP Queue 1 item 5):
# the mesh mode holds them at this many coefficients
MESH_LOOP_COEFS = 48


def run_mesh_shape(seed: int, device: str = "cuda", cards: int | None = None) -> dict:
    """One random geometry (`sample_mesh_shape`: 1-3 levels, `num_select`
    1-48) on a mesh of 2-4 shards of one device (with `cards`, shard i on
    card i mod `cards`, the local path on card 0), a ragged corpus of 5-40
    blocks at a batch size of 1-8: `CorpusEncoder(mesh=...)` gives the
    local path's container and rows at the same batch size;
    `DataParallelEncoder` (level 0) and `HierarchicalDataParallelEncoder`
    give the local coder's events; `DataParallelDecoder`'s rows of the top
    streams are bitwise the local decode in both modes; on block 0, where
    a shard of the block holds two windows, `sp_loop` and `tp_loop` given
    the local init are bitwise the local loop (the kernel on a card) at
    `MESH_LOOP_COEFS` coefficients."""
    from hsc_torch.parallel import (
        DataParallelDecoder, DataParallelEncoder, HierarchicalDataParallelEncoder, make_mesh,
    )
    from hsc_torch.parallel.sp import sp_loop, sp_shard_scores
    from hsc_torch.parallel.tp import tp_loop, tp_shard_scores

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    shards = int(rng.integers(2, 5))
    kw, mld = generate(rng, lambda r: sample_mesh_shape(r, shards), seed + 59)
    ns = int(rng.integers(1, 49))
    cfg = dataclasses.replace(mld.config, num_select=ns)
    mld = MultilevelDictionary(cfg, mld.dicts)
    n, bs = int(rng.integers(5, 41)), int(rng.integers(1, 9))
    gen = SignalGenerator(mld, rates=float(rng.uniform(2e-3, 1e-2)))
    xs = gen.generate_signals(n, cfg.block_size, seed=seed)
    devs = [dev] * shards if cards is None else [torch.device(dev.type, i % cards) for i in range(shards)]
    mesh = make_mesh({"data": shards}, devices=devs)
    local = CorpusEncoder(mld, device=devs[0], batch_size=bs)
    sharded = CorpusEncoder(mld, device=dev, batch_size=bs, mesh=mesh)
    t0 = time.perf_counter()
    blob = sharded.encode(xs)
    rows = sharded.decode(blob)
    seconds = time.perf_counter() - t0
    diff = None
    if blob != local.encode(xs):
        diff = f"mesh container ({len(blob)} bytes) != the local one at batch_size {bs}"
    elif rows.tobytes() != local.decode(blob).tobytes():
        diff = "mesh rows != the local rows"
    coder = local.coder
    mp0 = coder.coders[0].mp
    checks = [("DataParallelEncoder level 0", [DataParallelEncoder(mesh, mp0).encode(xs)],
               [to_host(mp0.compute_coefficients_batch(xs))])]
    if cfg.num_levels > 1:
        checks.append(("HierarchicalDataParallelEncoder", HierarchicalDataParallelEncoder(mesh, coder).encode(xs),
                       [to_host(e) for e in coder.encode_batch_device(xs)]))
    for what, got, want in checks:
        for level, (g, w) in enumerate(zip(got, want)):
            for name in ("positions", "atoms", "codes", "count", "scale"):
                a, b = np.asarray(getattr(g, name))[:n], np.asarray(getattr(w, name))[:n]
                if diff is None and a.tobytes() != b.tobytes():
                    blk = int(np.nonzero((a != b).reshape(n, -1).any(axis=1))[0][0])
                    diff = f"{what}: level {level} {name} != the local coder's, first at block {blk}"
    streams = [s[-1] for s in coder.encode_batch(xs)]
    dec = DataParallelDecoder(mesh, coder)
    for m in ("integer", "ordered"):
        if diff is None and not bits_equal(dec.decode_batch_device(streams, mode=m).cpu(),
                                           coder.reconstruct_batch_device(streams, mode=m).cpu()):
            diff = f"DataParallelDecoder {m} rows != the local decode"
    w0 = cfg.scales[0]
    single = cfg.block_size // shards >= 2 * w0
    if single:
        loop_kw = dict(num_coefs=min(cfg.num_coefs[0], MESH_LOOP_COEFS), amp_bits=cfg.amp_bits, num_select=ns)
        s0, e0, peak = encode_init_batched(torch.from_numpy(xs[:1, :, None]).to(dev), mp0.bank)
        sc, iv = quantizer_steps(peak.cpu().numpy(), cfg.amp_bits)
        want = mp_loop(s0.clone(), e0, torch.from_numpy(sc).to(dev), torch.from_numpy(iv).to(dev), mp0.params,
                          **loop_kw)
        sp_mesh = make_mesh({"seq": shards}, devices=devs)
        tp_mesh = make_mesh({"model": shards}, devices=devs)
        got = {
            "sp_loop": sp_loop(sp_mesh, sp_shard_scores(sp_mesh, s0[0], cfg.block_size), e0[0], sc[0], iv[0],
                               mp0.gram_t, **loop_kw),
            "tp_loop": tp_loop(tp_mesh, tp_shard_scores(tp_mesh, s0[0]), e0[0], sc[0], iv[0],
                               torch.from_numpy(mld.gram(0)).to(dev), **loop_kw),
        }
        for name, g in got.items():
            c = int(g.count)
            if diff is None and c != int(want.count[0]):
                diff = f"{name}: count {c} != the local loop's {int(want.count[0])}"
            for f in ("positions", "atoms", "codes"):
                if diff is None and not torch.equal(getattr(g, f)[:c].cpu(), getattr(want, f)[0, :c].cpu()):
                    diff = f"{name}: {f} != the local loop's"
            if diff is None and not bits_equal(g.energy_res.reshape(1).cpu(), want.energy_res[:1].cpu()):
                diff = f"{name}: energy_res != the local loop's"
    out = dict(
        seed=seed, ok=diff is None, run_s=round(seconds, 3), shards=shards, blocks=n, batch_size=bs, ns=ns,
        counts=kw["counts"], scales=kw["scales"], block=kw["block_size"], nc=kw["num_coefs"],
        hier_init=cfg.hier_init if cfg.num_levels > 1 else None, bytes=len(blob), sp_tp=single, diff=diff, mesh=True,
    )
    if cards is not None:
        out["cards"] = cards
    return out


MODES = {
    "flat": (run_shape, "shapes bitwise vs pinned oracle"),
    "hierarchical": (run_hier_shape, "shapes bitwise vs pinned oracle"),
    "container": (run_container_shape, "container decode byte-identity"),
    "batch": (run_batch_shape, "corpora batch-invariant and bitwise"),
    "long": (run_long_shape, "long shapes bitwise vs the plain path"),
    "three_level": (run_three_level_shape, "3-level shapes bitwise vs pinned oracle"),
    "container_f32": (run_container_f32_shape, "container decode byte-identity"),
    "mesh": (run_mesh_shape, "mesh shapes bitwise vs the local path"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shapes", type=int, default=4)
    ap.add_argument("--base-seed", type=int, default=0)
    modes = ap.add_mutually_exclusive_group()
    modes.add_argument("--hierarchical", action="store_true",
                       help="fuzz random 2-level hierarchies (kernel loop per level, int8 or f32 hand-off) "
                       "instead of single-level")
    modes.add_argument("--container", action="store_true",
                       help="fuzz the full container path (device decode == subprocess CPU decode, "
                       "byte for byte) with entropy, distributed and target_bps / rate_mode sampled")
    modes.add_argument("--batch", action="store_true",
                       help="corpora of 5-200 blocks: the init and the containers the same at batch 1, odd and whole")
    modes.add_argument("--long", action="store_true",
                       help="blocks of 12288-65536 samples on both sides of the kernels' shared-memory routes")
    modes.add_argument("--three-level", action="store_true", help="random 3-level hierarchies, int8 or f32 hand-off")
    modes.add_argument("--container-f32", action="store_true",
                       help="2- and 3-level containers, mostly with hier_init='f32'")
    modes.add_argument("--mesh", action="store_true", help="ragged corpora on meshes of 2-4 shards of one device")
    ap.add_argument("--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--cards", type=int, default=None,
                    help="with --mesh: shard i on card i mod N (on the CPU on device cpu:i mod N)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    mode = next((m for m in MODES if m != "flat" and getattr(args, m)), "flat")
    run, what = MODES[mode]
    if args.cards is not None:
        if mode != "mesh":
            ap.error("--cards goes with --mesh")
        if args.device != "cpu" and args.cards > torch.cuda.device_count():
            ap.error(f"--cards {args.cards}: only {torch.cuda.device_count()} card(s) visible")
        run = functools.partial(run, cards=args.cards)
    results = []
    for i in range(args.shapes):
        seed = args.base_seed * 1000 + i
        t0 = time.perf_counter()
        try:
            r = run(seed, args.device)
        except Exception:  # a shape that raises is a failed shape; the sweep goes on
            r = dict(seed=seed, ok=False, diff=traceback.format_exc(limit=3)[-600:])
        r["wall_s"] = round(time.perf_counter() - t0, 3)
        results.append(r)
        print(json.dumps(r), flush=True)
    n_ok = sum(r["ok"] for r in results)
    print(f"{n_ok}/{len(results)} {what}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
