"""Marginal-rate decode measurement of the PyTorch / CUDA port, the
counterpart of `scripts/bench_decode_marginal.py`.

Times the integer (format v2) and ordered (format v1) batched decodes at
growing block counts and reports the MARGINAL µs/block between the two
largest sizes: the steady-state per-block cost net of the fixed cost of a
call (launch, the synchronize that ends it).  The events are one 64-block
flat-flagship batch (16384 samples, 64 atoms of width 32, 512
coefficients; dictionary seed 7, signals seed 3) encoded once and tiled to
each size.  Each timed call sums the decoded rows on the device and ends
with a synchronize, so the copy of the rows to the host stays out of the
measurement; each size is the best of 3 calls after one warm call.

Unlike the JAX script (whose ordered leg runs only on a TPU), both modes run
on every device: on a card `--backend cuda` times the hand-written kernels
(`ops.decode_integer_kernel.mp_decode_integer_batch`,
`ops.decode_kernel.mp_decode_batch`) and `--backend torch` their plain
PyTorch versions; on the CPU both are the plain versions.  `--backend`
replaces the JAX script's `--kernel on|off` (the `kernel` key says "on" for
`cuda`); no environment variable is read.  `--device` replaces `--platform`:
'cuda' (default; exits if no card is visible), 'cuda:N' or 'cpu'.  The last
line printed is one JSON object.

Usage: python scripts/torch_bench_decode_marginal.py [--device cuda|cpu]
       [--blocks 256,512,1024,2048] [--mode integer|ordered|both]
       [--backend cuda|torch]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hsc_torch.cli import _device  # noqa: E402
from hsc_torch.device import device_name, synchronize  # noqa: E402

# the flat flagship of bench.py:72-78
FLAGSHIP = dict(counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,))
BATCH = 64


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; exits if no card is visible), 'cuda:N' or 'cpu'")
    ap.add_argument("--blocks", default="256,512,1024,2048")
    ap.add_argument("--mode", default="both", choices=["integer", "ordered", "both"])
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                    help="'cuda': the decode kernels; 'torch': their plain PyTorch versions")
    return ap.parse_args(argv)


def measure(spec: dict, *, sizes: list[int], mode: str, backend: str, device, batch: int = BATCH) -> dict:
    """Marginal decode cost between the two largest of `sizes` blocks at
    config `spec` (`make_test_config` overrides) on `device` -> the output
    dict."""
    import torch

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.models.coder import resolve_backend
    from hsc_torch.ops.decode import mp_decode_batch_torch, mp_decode_integer_batch_torch
    from hsc_torch.ops.decode_integer_kernel import mp_decode_integer_batch
    from hsc_torch.ops.decode_kernel import mp_decode_batch
    from hsc_torch.ops.pipeline import encode_batches_pipelined
    from hsc_torch.oracle.mp import rep_quantize
    from hsc_torch.params import level_params_from_mld
    from hsc_torch.utils import Timer

    dev = torch.device(device)
    cfg = make_test_config(**spec)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    gen = SignalGenerator(mld, rates=2e-3)
    xs = gen.generate_signals(batch, cfg.block_size, seed=3)
    bank = mld.augmented(0)
    params = level_params_from_mld(mld, 0, dev)
    (enc,) = encode_batches_pipelined(
        [xs[:, :, None]], params, device=dev, backend=resolve_backend("auto", dev),
        num_coefs=cfg.num_coefs[0],
    )
    enc = [t.cpu().numpy() for t in enc]  # positions, atoms, codes, count, scale, ...
    rep_q, step = rep_quantize(bank, cfg.rep_bits)
    amp_step = (enc[4].astype(np.float32) * np.float32(step)).astype(np.float32)
    block_mb = cfg.block_size * 4 / 1e6
    out = {"config": "flagship 16k/64-atom/512-coef" if spec == FLAGSHIP else json.dumps(spec),
           "kernel": "on" if backend == "cuda" else "off"}

    def timed(fn, a) -> float:
        with Timer() as t:
            fn(*a)
            synchronize(dev)
        return t.elapsed

    def run(name, fn, mults):
        times = {}
        for nb, a in mults:
            log(f"{name} {nb} blocks first call {timed(fn, a) * 1e3:.1f} ms")
            times[nb] = min(timed(fn, a) for _ in range(3))
            log(f"{name} {nb} blocks: {times[nb] * 1e3:.3f} ms ({times[nb] / nb * 1e6:.2f} µs/block gross)")
        n1, n2 = sorted(times)[-2:]
        us = (times[n2] - times[n1]) / (n2 - n1) * 1e6
        out[f"{name}_marginal_us_block"] = us
        out[f"{name}_marginal_mb_s"] = block_mb / (us / 1e6)
        log(f"{name} marginal ({n1}->{n2}): {us:.3f} µs/block -> {block_mb / (us / 1e6):.0f} MB/s")

    def tiled(a, nb):
        return torch.from_numpy(np.ascontiguousarray(np.tile(a, (-(-nb // batch),) + (1,) * (a.ndim - 1))[:nb])).to(dev)

    events = {nb: [tiled(a, nb) for a in enc[:4]] for nb in sizes}
    if mode in ("integer", "both"):
        dec = mp_decode_integer_batch if backend == "cuda" else mp_decode_integer_batch_torch
        rep = torch.from_numpy(rep_q).to(dev)

        def _int(*a):
            return dec(*a, n=cfg.block_size).sum()

        run("integer", _int, [(nb, (*events[nb], tiled(amp_step, nb), rep)) for nb in sizes])
    if mode in ("ordered", "both"):
        dec = mp_decode_batch if backend == "cuda" else mp_decode_batch_torch
        bank_t = torch.from_numpy(bank).to(dev)

        def _ord(*a):
            return dec(*a, n=cfg.block_size).sum()

        run("ordered", _ord, [(nb, (*events[nb], tiled(enc[4], nb), bank_t)) for nb in sizes])
    out["device"] = device_name(dev)
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = _device(args)  # as the port's CLI resolves it: no CPU fallback
    sizes = [int(s) for s in args.blocks.split(",")]
    out = measure(FLAGSHIP, sizes=sizes, mode=args.mode, backend=args.backend, device=dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
