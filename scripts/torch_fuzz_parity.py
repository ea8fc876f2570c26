"""Random-geometry parity fuzz of the PyTorch / CUDA port: codec geometries
sampled anew per seed, encoded (and decoded) by the hand-written CUDA
kernels on the card, bitwise against the port's NumPy oracle given the
port's own init, and against the kernels' plain PyTorch versions.

The counterpart of scripts/fuzz_tpu_parity.py.  Fixed geometries missed
the reference's own silent kernel bug (an integer decode that was wrong at
widths no pin covered), so every run of a new --base-seed extends what the
card has held.  Three modes:

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
                  unpacked streams.

    python scripts/torch_fuzz_parity.py --shapes 8 --base-seed 0
    python scripts/torch_fuzz_parity.py --hierarchical --shapes 4 --base-seed 0
    python scripts/torch_fuzz_parity.py --container --shapes 4 --base-seed 0

`--device` defaults to 'cuda' and raises without a card; `--device cpu`
runs the plain paths.  One JSON line per shape (seed ``base_seed * 1000 +
i``; ``run_s`` the device encode, ``wall_s`` the whole shape with its
checks), then a summary line; the exit code is 1 if any shape failed.
"""

from __future__ import annotations

import argparse
import dataclasses
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

from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config  # noqa: E402
from hsc_torch.device import resolve_device  # noqa: E402
from hsc_torch.io import unpack_corpus  # noqa: E402
from hsc_torch.models import HierarchicalConvolutionalSparseCoder  # noqa: E402
from hsc_torch.models.coder import ConvolutionalMatchingPursuit, to_host  # noqa: E402
from hsc_torch.ops.encode import encode_init_batched, mp_encode_from_init_torch, quantizer_steps  # noqa: E402
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


def generate(rng: np.random.Generator, sample, seed: int):
    """A geometry drawn by ``sample(rng)`` and its dictionary (seed `seed`).
    Some sampled geometries cannot generate a dictionary (the coherence
    rejection sampler exhausts, e.g. many atoms over a short window): those
    are drawn again from `rng`, up to 8 times, so the sweep stays
    deterministic.  Returns ``(kw, mld)``."""
    for _attempt in range(8):
        kw = sample(rng)
        try:
            return kw, MultilevelDictionary.generate(make_test_config(**kw), seed=seed)
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


def flat_parity(mld, xs, device, *, num_select=1, singleton_weight=1.0, n_raw=None) -> dict:
    """Level 0 of `mld` on the blocks ``xs [B, N]`` through
    `ConvolutionalMatchingPursuit` on `device`.  On a card the kernel's
    result must equal the plain loop on the same init bit for bit; every
    block must equal `pinned.oracle_encode_pinned`, the oracle `mp_encode`
    with the port's init of that block injected (positions, atoms, codes,
    count, scale, energy_res): the init is the same bits at every batch
    size.  Returns ``ok``, the kernel's seconds and the first difference
    found."""
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
    for b in range(xs.shape[0]):
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
    coder = HierarchicalConvolutionalSparseCoder(mld, device=dev)
    t0 = time.perf_counter()
    batch = coder.encode_batch(xs)
    seconds = time.perf_counter() - t0
    plain = HierarchicalConvolutionalSparseCoder(mld, backend="torch", device=dev).encode_batch(xs)
    rep_q, step = rep_quantize(mld.representations(1)[:, :, None], cfg.rep_bits)
    diff = None
    for b in range(2):
        refs = oracle_hierarchical_pinned(xs[b], mld, dev)
        for level in range(cfg.num_levels):
            for what, want in (("oracle", refs[level]), ("plain", plain[b][level])):
                where = first_event_diff(batch[b][level], want)
                if diff is None and where is not None:
                    diff = f"block {b} level {level} vs {what}: {where}"
        top = batch[b][1]
        if diff is None and coder.reconstruct(top, mode="ordered").tobytes() != hierarchical_decode(top, mld).tobytes():
            diff = f"block {b}: ordered decode != oracle.hierarchical_decode"
        want = mp_decode_integer(top, rep_q, step, cfg.block_size)[:, 0]
        if diff is None and coder.reconstruct(top).tobytes() != want.tobytes():
            diff = f"block {b}: {cfg.decode_mode} decode != oracle.mp.mp_decode_integer"
    return dict(
        seed=seed, ok=diff is None, run_s=round(seconds, 3), ns=ns, hier_init=hier_init,
        counts=kw["counts"], scales=kw["scales"], block=kw["block_size"], nc=kw["num_coefs"],
        amp_bits=kw["amp_bits"], events=[[s.positions.shape[0] for s in blk] for blk in batch],
        diff=diff, hier=True,
    )


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
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    kw, mld = generate(rng, sample_container_shape, seed + 31)
    cfg = mld.config
    distributed = bool(cfg.num_levels == 2 and rng.random() < 0.5)
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
        block=kw["block_size"], nc=kw["num_coefs"], entropy=cfg.entropy, distributed=distributed,
        target_bps=None if target_bps is None else round(target_bps, 3), rate_mode=rate_mode,
        index=use_index, decode_mode=cfg.decode_mode, bytes=len(blob),
        streams=[[lv for lv, _ in s] for s in blocks], diff=diff, container=True,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shapes", type=int, default=4)
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--hierarchical", action="store_true",
                    help="fuzz random 2-level hierarchies (kernel loop per level, int8 or f32 hand-off) "
                    "instead of single-level")
    ap.add_argument("--container", action="store_true",
                    help="fuzz the full container path (device decode == subprocess CPU decode, "
                    "byte for byte) with entropy, distributed and target_bps / rate_mode sampled")
    ap.add_argument("--device", default="cuda", help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    run = run_container_shape if args.container else run_hier_shape if args.hierarchical else run_shape
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
    what = "container decode byte-identity" if args.container else "shapes bitwise vs pinned oracle"
    print(f"{n_ok}/{len(results)} {what}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
