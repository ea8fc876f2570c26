"""Per-stage encode breakdown of the PyTorch / CUDA port at the flagship
config, the counterpart of `scripts/bench_encode_stages.py`.

Separates the three stages of the level-0 encode (`ops/pipeline.py`):
  init   — `ops.encode.encode_init_batched` (the cuDNN conv in IEEE float32,
           e0's fixed pairwise tree, the peaks)
  loop   — the level-0 coder's `loop_stage` (the greedy-loop kernel on a
           card) from a fixed init; the kernel updates its scores in place,
           so every call gets its own copy, made before the timing starts
  pack   — host bit-packing of the emitted streams (`io.pack_corpus`)

Each stage is timed in steady state: NB batches back to back, ended by a
device synchronize, best of R repeats after one warm run.  At the flat
flagship (16384-sample blocks, 64 atoms of width 32, 512 coefficients,
batches of 64; dictionary seed 7, signals seed 3).  On `--device cpu` it
runs the tiny config of the JAX script's CPU leg (16 atoms of width 16,
1024-sample blocks, 32 coefficients, batches of 4) through the plain
versions: a check of the control flow, not a device number.

`--device` replaces `--platform`: 'cuda' (default; exits if no card is
visible), 'cuda:N' or 'cpu'.  The last line printed is one JSON object.

Usage: python scripts/torch_bench_encode_stages.py [--batches 8] [--repeats 3]
       [--ns 8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hsc_torch.cli import _device  # noqa: E402
from hsc_torch.device import device_name, synchronize  # noqa: E402

# the flat flagship of bench.py:72-78, and the JAX script's CPU leg
FLAGSHIP = dict(counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,))
TINY = dict(counts=(16,), scales=(16,), num_coefs=(32,))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--ns", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; exits if no card is visible), 'cuda:N' or 'cpu'")
    return ap.parse_args(argv)


def measure(spec: dict, *, batch: int, batches: int, repeats: int, ns: int, device) -> dict:
    """The three stages' ms per batch of `batch` blocks at config `spec`
    (`make_test_config` overrides) on `device` -> the output dict."""
    import torch

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.io import pack_corpus
    from hsc_torch.models.coder import ConvolutionalMatchingPursuit, level_streams, to_host
    from hsc_torch.ops.encode import encode_init_batched, quantizer_steps
    from hsc_torch.utils import Timer

    dev = torch.device(device)
    cfg = make_test_config(**spec)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    gen = SignalGenerator(mld, rates=2e-3)
    xs = gen.generate_signals(batch, cfg.block_size, seed=3)
    xb = torch.from_numpy(xs[:, :, None]).to(dev)
    mp = ConvolutionalMatchingPursuit(
        mld.augmented(0), mld.gram(0), num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits,
        num_select=ns, device=dev,
    )
    nb, r = batches, repeats
    batch_mb = batch * cfg.block_size * 4 / 1e6

    def best_of(prepare) -> float:
        """`prepare()` sets up outside the timing and returns the run."""
        def once():
            run = prepare()
            synchronize(dev)
            with Timer() as t:
                run()
                synchronize(dev)
            return t.elapsed

        once()  # warm
        return min(once() for _ in range(r))

    # --- stage 1: init conv ------------------------------------------------
    t_init = best_of(lambda: lambda: [encode_init_batched(xb, mp.bank) for _ in range(nb)])

    # --- stage 2: greedy loop from a fixed init ------------------------------
    scores0, e0, peak = encode_init_batched(xb, mp.bank)
    scale, inv = quantizer_steps(peak.cpu().numpy(), cfg.amp_bits)

    def loop_run():
        copies = [scores0.clone() for _ in range(nb)]  # the kernel writes its scores
        return lambda: [mp.loop_stage(s, e0, scale, inv) for s in copies]

    t_loop = best_of(loop_run)

    # --- stage 3: host bit-pack ---------------------------------------------
    streams = level_streams(to_host(mp.loop_stage(scores0.clone(), e0, scale, inv)))
    t_pack = best_of(lambda: lambda: [pack_corpus(cfg, [[(0, s)] for s in streams]) for _ in range(nb)])

    return {
        "batches": nb,
        "ns": ns,
        "init_ms_per_batch": t_init / nb * 1e3,
        "loop_ms_per_batch": t_loop / nb * 1e3,
        "pack_ms_per_batch": t_pack / nb * 1e3,
        "loop_mb_s": nb * batch_mb / t_loop,
        "device": device_name(dev),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = _device(args)  # as the port's CLI resolves it: no CPU fallback
    spec, batch = (TINY, 4) if dev.type == "cpu" else (FLAGSHIP, 64)
    out = measure(spec, batch=batch, batches=args.batches, repeats=args.repeats, ns=args.ns, device=dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
