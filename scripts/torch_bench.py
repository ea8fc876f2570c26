"""Headline benchmark of the PyTorch / CUDA port, the counterpart of
`bench.py`: the same cells, constants, seeds and timing rule, on the card.

Prints ONE JSON line last on stdout (detail lines go to stderr):
  {"metric": ..., "value": N, "unit": "MB/s", "vs_baseline": N,
   "decode_integer_mb_s": N, "decode_ordered_mb_s": N,
   "encode_hier_mb_s": N, "encode_hier_flagship_mb_s": N,
   "learn_mwindows_s": N, "platform": "cuda", "device": "<name>, <power
   limit>", "encode_ns1_mb_s": N, "launches": {<kernel>: N, ...}}

value       = encode throughput of the flat flagship (MB of float32 signal a
              second): 16384-sample blocks, 64 atoms of width 32, 512
              coefficients, num_select 8; 16 batches of 64 blocks through
              `ops.pipeline.encode_batches_pipelined` with `window=None`
              (all 16 batches' scores live), ended by a host read of every
              batch's count.  Device-pipelined: no bit-packing, unlike the
              `CorpusEncoder` host-wall rate.  `encode_ns1_mb_s` is the same
              cell at num_select 1.
vs_baseline = value / the NumPy oracle's encode MB/s on block 0 (one thread
              of the card's host; best of 2 after a 64-coefficient warm-up).
decode_*    = the integer decode of one encoded batch tiled 256 times (16384
              blocks) and the ordered decode of it tiled 32 times (2048
              blocks), each a kernel call plus an on-device `.sum()`, ended
              by a host read of that scalar.
encode_hier_mb_s          = a 2-level hierarchy (counts 32, 16; 8192-sample
              blocks; 256 and 128 coefficients; num_select 8), 32 batches of
              64 blocks through `encode_hierarchical_batches_pipelined` at
              window 8, ended by a host read of the top level's counts.
encode_hier_flagship_mb_s = the flagship hierarchy (counts 64, 32; 16384-
              sample blocks; 512 and 192 coefficients; num_select 8), 16
              batches of 64 blocks at the pipeline's default window.
learn_mwindows_s = k-means refinement (`learn.kmeans.kmeans_refine_device`)
              of 65536 windows of 32 against 64 centroids, 20 iterations:
              million window-assignments a second, ended by a host read of
              the centroids.
launches    = each hand-written kernel's launches over the run (the
              wrappers' `LAUNCHES` counters), not counting the launches that
              only compare a kernel with its plain version; on a card every
              kernel must have launched.

Each cell: a warm-up run, then the best of 3 runs, each timed with
`time.perf_counter` around a run that ends in a host read.  Before its timed
runs each cell's first batch is held against the port's plain version on
the same device, and every timed run must return the warm-up's counts
(checksums, centroids) bit for bit; a failed check raises.

Differences from `bench.py`, and nothing else: no CPU fallback (without a
card the script exits non-zero; `--device cpu` runs the plain paths at a
small geometry, a check of the control flow, not a device number); the
port's pipelines take host batches, so each batch's upload is inside the
timed run; the checks; the keys `device`, `encode_ns1_mb_s` and `launches`.

Usage: python scripts/torch_bench.py [--device cuda|cuda:N|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hsc_torch.cli import _device  # noqa: E402
from hsc_torch.device import device_name  # noqa: E402

METRIC = ("encode throughput, 16k-sample/64-atom/512-coef blocks (flagship config, "
          "8-way multi-select sweeps)")
# bench.py's cells at its sizes (the values it takes on its accelerator)
CARD = dict(
    flat=dict(counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,)),  # :72-78
    batch=64, batches=16,  # :77, :106
    integer_tiles=256, ordered_tiles=32,  # :149, :185
    hier=dict(counts=(32, 16), scales=(32, 96), block_size=8192, num_coefs=(256, 128), num_select=8),  # :219
    hier_batch=64, hier_batches=32,  # :225, :231
    flagship=dict(counts=(64, 32), scales=(32, 96), block_size=16384, num_coefs=(512, 192),
                  num_select=8),  # :257
    flagship_batch=64, flagship_batches=16,  # :263, :269
    kmeans=(65536, 32, 64, 20),  # :291: windows, window width, centroids, iterations
)
# --device cpu: the plain paths at a small geometry (control flow only)
SMALL = dict(
    flat=dict(counts=(16,), scales=(16,), block_size=1024, num_coefs=(32,)),
    batch=4, batches=2,
    integer_tiles=2, ordered_tiles=1,
    hier=dict(counts=(8, 4), scales=(16, 48), block_size=1024, num_coefs=(32, 16), num_select=8),
    hier_batch=4, hier_batches=2,
    flagship=dict(counts=(12, 6), scales=(16, 48), block_size=1024, num_coefs=(48, 24), num_select=8),
    flagship_batch=4, flagship_batches=2,
    kmeans=(4096, 32, 16, 5),
)
FLAT_SEEDS = (7, 3)  # dictionary, signals
HIER_SEEDS = (9, 5)
RATES = 2e-3
NUM_SELECT = (1, 8)  # the flat cell's sweeps; the headline is the last
HIER_WINDOW = 8  # the 2-level cell's; the flagship hierarchy takes the pipeline's default
ORACLE_WARM_COEFS = 64
ORACLE_REPEATS = 2
KMEANS_SEED = 0
REPEATS = 3
# blocks of the first batch held against the plain version
FLAT_CHECK_BLOCKS = 8
HIER_CHECK_BLOCKS = 4
EVENT_FIELDS = ("positions", "atoms", "codes", "count", "scale")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; exits if no card is visible), 'cuda:N' or 'cpu'")
    return ap.parse_args(argv)


def kernel_counters() -> dict:
    """Each hand-written kernel's wrapper module, which counts its launches."""
    from hsc_torch.ops import decode_integer_kernel, decode_kernel, init_kernels, mp_kernels

    return {"mp_encode": mp_kernels, "int_decode": decode_integer_kernel,
            "sparse_init": init_kernels, "ordered_decode": decode_kernel}


@contextlib.contextmanager
def uncounted():
    """The launches inside (those that only compare a kernel with its plain
    version) leave every kernel's count as it was."""
    saved = {name: mod.LAUNCHES for name, mod in kernel_counters().items()}
    try:
        yield
    finally:
        for name, mod in kernel_counters().items():
            mod.LAUNCHES = saved[name]


def same(got, want, what: str) -> None:
    """Raise unless the two tensors are the same bits."""
    if not (got.shape == want.shape and got.dtype == want.dtype
            and got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()):
        raise AssertionError(what)


def best_time(run, want, what: str) -> float:
    """The best of REPEATS runs of `run`, each timed around a run that ends
    in a host read; each run's host result must be `want`'s bits (the
    warm-up's)."""
    best = math.inf
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        got = run()
        best = min(best, time.perf_counter() - t0)
        same(got, want, f"{what}: a timed run returned other results than the warm-up")
    return best


def card_line(dev) -> str:
    """The card's name and power limit as `nvidia-smi` gives them, or 'cpu'."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()
    return smi[dev.index or 0].strip()


def oracle_mb_s(mld, x: np.ndarray) -> float:
    """The NumPy oracle's encode MB/s on one block (bench.py:81-92)."""
    from hsc_torch.oracle import mp_encode

    cfg = mld.config
    bank, gram = mld.augmented(0), mld.gram(0)
    mp_encode(x[:, None], bank, gram, num_coefs=ORACLE_WARM_COEFS)  # warm caches
    dt = math.inf  # best of 2: host load spikes distort the ratio
    for _ in range(ORACLE_REPEATS):
        t0 = time.perf_counter()
        stream = mp_encode(x[:, None], bank, gram, num_coefs=cfg.num_coefs[0])
        dt = min(dt, time.perf_counter() - t0)
    mbps = cfg.block_size * 4 / 1e6 / dt
    log(f"oracle: {dt * 1e3:.1f} ms/block -> {mbps:.4f} MB/s ({stream.positions.shape[0]} events, "
        f"snr {stream.snr_db():.2f} dB)")
    return mbps


def check_flat(dev, first, xb, params, settings: dict) -> None:
    """The first batch's first FLAT_CHECK_BLOCKS blocks: events, count and
    scale bitwise the plain loop given the same init (the pipeline's init of
    that batch, computed again)."""
    import torch

    from hsc_torch.ops.encode import encode_init_batched, mp_encode_from_init_torch, quantizer_steps

    n = FLAT_CHECK_BLOCKS
    s0, e0, peak = encode_init_batched(torch.from_numpy(xb).to(dev), params.bank)
    scale, inv = quantizer_steps(peak[:n].cpu().numpy(), settings["amp_bits"])
    want = mp_encode_from_init_torch(s0[:n], e0[:n], torch.from_numpy(scale).to(dev),
                                     torch.from_numpy(inv).to(dev), params, **settings)
    for f in EVENT_FIELDS:
        same(getattr(first, f)[:n], getattr(want, f),
             f"flat encode, num_select {settings['num_select']}: {f} of the first {n} blocks != the plain loop's")


def flat_data(geo: dict):
    """The flat flagship's dictionary and one batch of its signals."""
    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config

    cfg = make_test_config(**geo["flat"])
    mld = MultilevelDictionary.generate(cfg, seed=FLAT_SEEDS[0])
    return mld, SignalGenerator(mld, rates=RATES).generate_signals(geo["batch"], cfg.block_size,
                                                                   seed=FLAT_SEEDS[1])


def flat_cells(dev, geo: dict, mld, xs: np.ndarray) -> dict:
    """The flat flagship at each NUM_SELECT -> {num_select: MB/s}."""
    import torch

    from hsc_torch.models.coder import resolve_backend
    from hsc_torch.ops.pipeline import encode_batches_pipelined
    from hsc_torch.params import level_params_from_mld

    cfg = mld.config
    b, nbatch = geo["batch"], geo["batches"]
    params = level_params_from_mld(mld, 0, dev)
    backend = resolve_backend("auto", dev)
    xb = xs[:, :, None]
    batches = [xb] * nbatch
    mb = nbatch * b * cfg.block_size * 4 / 1e6
    rates = {}
    for ns in NUM_SELECT:
        settings = dict(num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, num_select=ns)

        def run():
            # window=None: every batch's init in flight before the first loop
            encs = encode_batches_pipelined(batches, params, device=dev, backend=backend, window=None,
                                            **settings)
            return encs, torch.stack([e.count for e in encs]).cpu()

        t0 = time.perf_counter()
        encs, counts = run()
        log(f"ns={ns} first run: {time.perf_counter() - t0:.1f}s (min count {int(counts.min())})")
        check_flat(dev, encs[0], xb, params, settings)
        del encs
        best = best_time(lambda: run()[1], counts, f"flat encode, num_select {ns}")
        rates[ns] = mb / best
        log(f"fused encode ns={ns}: {best * 1e3:.1f} ms for {nbatch * b} blocks -> {rates[ns]:.1f} MB/s")
    return rates


def decode_cells(dev, geo: dict, mld, xs: np.ndarray) -> tuple[float, float]:
    """The integer and ordered decodes of one encoded flat batch, tiled ->
    their MB/s (bench.py:130-207)."""
    import torch

    from hsc_torch.models.coder import resolve_backend, to_host
    from hsc_torch.ops.decode import mp_decode_batch_torch, mp_decode_integer_batch_torch
    from hsc_torch.ops.decode_integer_kernel import mp_decode_integer_batch
    from hsc_torch.ops.decode_kernel import mp_decode_batch
    from hsc_torch.ops.pipeline import encode_batches_pipelined
    from hsc_torch.oracle.mp import rep_quantize
    from hsc_torch.params import level_params_from_mld

    cfg = mld.config
    b, n = geo["batch"], cfg.block_size
    bank = mld.augmented(0)
    (enc,) = encode_batches_pipelined([xs[:, :, None]], level_params_from_mld(mld, 0, dev), device=dev,
                                      backend=resolve_backend("auto", dev), num_coefs=cfg.num_coefs[0])
    enc = to_host(enc)
    rep_q, step = rep_quantize(bank, cfg.rep_bits)
    amp_step = (enc.scale.astype(np.float32) * np.float32(step)).astype(np.float32)
    block_mb = n * 4 / 1e6

    def tiles(a, reps):
        return torch.from_numpy(np.tile(a, (reps,) + (1,) * (a.ndim - 1))).to(dev)

    def cell(name, kernel, plain, reps, per_block, table):
        args = (*(tiles(a, reps) for a in (enc.positions, enc.atoms, enc.codes, enc.count, per_block)), table)
        # rows of one tile (the encoded batch) bitwise the plain version
        tile = (*(a[:b] for a in args[:5]), table)
        with uncounted():
            got = kernel(*tile, n=n)
        same(got, plain(*tile, n=n), f"{name} decode: the rows of one {b}-block tile != the plain version's")

        def run():
            return kernel(*args, n=n).sum().cpu()

        t0 = time.perf_counter()
        want = run()
        log(f"{name} decode first run: {time.perf_counter() - t0:.1f}s")
        best = best_time(run, want, f"{name} decode")
        mbps = reps * b * block_mb / best
        log(f"{name} decode: {best * 1e3:.3f} ms for {reps * b} blocks -> {mbps:.1f} MB/s")
        return mbps

    integer = cell("integer", mp_decode_integer_batch, mp_decode_integer_batch_torch, geo["integer_tiles"],
                   amp_step, torch.from_numpy(rep_q).to(dev))
    ordered = cell("ordered", mp_decode_batch, mp_decode_batch_torch, geo["ordered_tiles"], enc.scale,
                   torch.from_numpy(bank).to(dev))
    return integer, ordered


def hier_cell(dev, spec: dict, batch: int, batches: int, window: int | None, what: str) -> float:
    """A level-pipelined hierarchical encode of `batches` copies of one
    batch -> MB/s (bench.py:212-287).  `window` None: the pipeline's
    default."""
    import torch

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.models import HierarchicalConvolutionalSparseCoder
    from hsc_torch.ops.pipeline import encode_hierarchical_batches_pipelined

    cfg = make_test_config(**spec)
    mld = MultilevelDictionary.generate(cfg, seed=HIER_SEEDS[0])
    xs = SignalGenerator(mld, rates=RATES).generate_signals(batch, cfg.block_size, seed=HIER_SEEDS[1])
    coder = HierarchicalConvolutionalSparseCoder(mld, device=dev)
    hbatches = [xs[:, :, None]] * batches
    kw = {} if window is None else {"window": window}

    def run():
        outs = encode_hierarchical_batches_pipelined(hbatches, coder, **kw)
        return outs, torch.stack([e.count for e in outs[-1]]).cpu()

    t0 = time.perf_counter()
    outs, counts = run()
    log(f"{what} first run: {time.perf_counter() - t0:.1f}s (hier_init {cfg.hier_init})")
    # the top level's events of the first blocks bitwise backend='torch'
    n = HIER_CHECK_BLOCKS
    plain = HierarchicalConvolutionalSparseCoder(mld, backend="torch", device=dev)
    want = plain.encode_batch_device(xs[:n])[-1]
    for f in EVENT_FIELDS:
        same(getattr(outs[-1][0], f)[:n], getattr(want, f),
             f"{what}: the top level's {f} of the first {n} blocks != backend='torch'")
    del outs, want
    best = best_time(lambda: run()[1], counts, what)
    mbps = batches * batch * cfg.block_size * 4 / 1e6 / best
    log(f"{what}: {best * 1e3:.1f} ms for {batches * batch} {cfg.num_levels}-level blocks -> {mbps:.1f} MB/s")
    return mbps


def kmeans_cell(dev, geo: dict) -> float:
    """Device-resident k-means refinement -> M window-assignments a second
    (bench.py:289-307)."""
    import torch

    from hsc_torch.learn.kmeans import kmeans_refine_device

    m, d, k, iters = geo["kmeans"]
    rng = np.random.default_rng(KMEANS_SEED)
    flat = rng.standard_normal((m, d)).astype(np.float32)
    cents = rng.standard_normal((k, d)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    wdev, cdev = torch.from_numpy(flat).to(dev), torch.from_numpy(cents).to(dev)

    def run():
        return kmeans_refine_device(wdev, cdev, iterations=iters)[0].cpu()

    t0 = time.perf_counter()
    want = run()
    log(f"kmeans refine first run: {time.perf_counter() - t0:.1f}s")
    best = best_time(run, want, "k-means")
    rate = m * iters / best / 1e6
    log(f"kmeans refine: {best * 1e3:.2f} ms for {iters} iters over {m} windows -> "
        f"{rate:.1f} M window-assignments/s")
    return rate


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = _device(args)  # as the port's CLI resolves it: no CPU fallback
    geo = SMALL if dev.type == "cpu" else CARD
    card = card_line(dev)
    log(f"device: {device_name(dev)} ({card})")
    start = {name: mod.LAUNCHES for name, mod in kernel_counters().items()}

    mld, xs = flat_data(geo)
    oracle = oracle_mb_s(mld, xs[0])
    flat = flat_cells(dev, geo, mld, xs)
    integer, ordered = decode_cells(dev, geo, mld, xs)
    hier = hier_cell(dev, geo["hier"], geo["hier_batch"], geo["hier_batches"], HIER_WINDOW,
                     "hierarchical encode")
    flagship = hier_cell(dev, geo["flagship"], geo["flagship_batch"], geo["flagship_batches"], None,
                         "hierarchical flagship encode")
    learn = kmeans_cell(dev, geo)

    launches = {name: mod.LAUNCHES - start[name] for name, mod in kernel_counters().items()}
    log(f"kernel launches: {launches}")
    if dev.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"a kernel was never launched on the card: {launches}")
    out = {
        "metric": METRIC,
        "value": flat[8],
        "unit": "MB/s",
        "vs_baseline": flat[8] / oracle,
        "decode_integer_mb_s": integer,
        "decode_ordered_mb_s": ordered,
        "encode_hier_mb_s": hier,
        "encode_hier_flagship_mb_s": flagship,
        "learn_mwindows_s": learn,
        "platform": dev.type,
        "device": card,
        "encode_ns1_mb_s": flat[1],
        "launches": launches,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
