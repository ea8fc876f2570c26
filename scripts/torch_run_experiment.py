"""End-to-end experiment driver of the PyTorch / CUDA port — the counterpart
of `scripts/run_experiment.py`: generate a ground-truth multilevel
dictionary, synthesize a corpus, learn dictionaries from scratch, encode at a
sparsity sweep, run the rate/distortion analysis, and emit figures.

Its options, files and `report.json` are the JAX driver's, but for:
  --device   replaces --platform: 'cuda' (default; exits if no card is
             visible), 'cuda:N' or 'cpu' — never a silent CPU fallback;
  --backend  takes the port's names: 'cuda' (the hand-written kernels; the
             JAX driver's 'pallas'), 'torch' (their plain PyTorch versions;
             the JAX driver's 'jax') or 'auto' ('cuda' on a CUDA device);
  --profile-dir  writes a `torch.profiler` Chrome trace of the encode.
Where matplotlib is not installed, every step but the figures runs and one
line names the figures that were not written.

`main(argv)` runs the experiment and returns the report it wrote.

Examples:
  python scripts/torch_run_experiment.py --outdir /tmp/exp --blocks 8
  python scripts/torch_run_experiment.py --outdir /tmp/exp --device cpu \\
      --counts 16,8 --scales 16,48 --block-size 2048 --backend torch
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hsc_torch.cli import _device  # noqa: E402
from hsc_torch.utils.profiling import profile_region  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--outdir", required=True)
    add_device_args(p)
    p.add_argument("--counts", default="16,8", help="atoms per level")
    p.add_argument("--scales", default="16,48", help="signal-space atom sizes")
    p.add_argument("--num-coefs", default="96,48")
    p.add_argument("--block-size", type=int, default=1024)
    p.add_argument("--blocks", type=int, default=8)
    p.add_argument("--rate", type=float, default=4e-3, help="event rate/sample")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--learn-iterations", type=int, default=10)
    p.add_argument("--budget-sweep", default="8,16,32,64")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the encode here")
    p.add_argument("--skip-learning", action="store_true")
    p.add_argument("--entropy", choices=["fixed", "rice"], default="fixed")
    p.add_argument("--decode-mode", choices=["ordered", "integer"],
                   default="ordered")
    p.add_argument("--num-select", type=int, default=1)
    return p.parse_args(argv)


def add_device_args(p) -> None:
    """`--device` and `--backend`, shared with torch_run_audio_experiment.py."""
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; exits if no card is visible), "
                   "'cuda:N' or 'cpu'")
    p.add_argument("--backend", default="auto", choices=["auto", "torch", "cuda"],
                   help="'cuda': the hand-written kernels (the JAX driver's "
                   "'pallas'); 'torch': their plain PyTorch versions (its "
                   "'jax'); 'auto': 'cuda' on a CUDA device")


class Figures:
    """Draws each figure where matplotlib is installed; where it is not,
    notes the files it would have written, and `report` prints them on one
    line.  Decided once, so no device step is ever inside a `try`."""

    def __init__(self, outdir: str):
        self.outdir = outdir
        self.enabled = importlib.util.find_spec("matplotlib") is not None
        self.skipped: list[str] = []

    def draw(self, files: list[str], fn) -> None:
        if self.enabled:
            fn()
        else:
            self.skipped.extend(files)

    def dictionary(self, mld, stem: str) -> None:
        """`mld.visualize` into ``<stem>.level<l>.png``."""
        self.draw(
            [f"{stem}.level{l}.png" for l in range(mld.config.num_levels)],
            lambda: mld.visualize(os.path.join(self.outdir, stem)),
        )

    def report(self) -> None:
        if self.skipped:
            print(f"figures not written (matplotlib is not installed): "
                  f"{', '.join(self.skipped)}", flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = _device(args)  # as the port's CLI resolves it: no CPU fallback

    from hsc_torch import CodecConfig, MultilevelDictionary, SignalGenerator
    from hsc_torch.analysis import (
        corpus_rates,
        hierarchical_rate_distortion_curve,
        rate_distortion_curve,
        visualize_rate_distortion,
    )
    from hsc_torch.io import unpack_corpus
    from hsc_torch.learn import MultilevelTrainer
    from hsc_torch.runtime import CorpusEncoder
    from hsc_torch.utils import snr_db

    os.makedirs(args.outdir, exist_ok=True)
    figures = Figures(args.outdir)
    counts = tuple(int(x) for x in args.counts.split(","))
    scales = tuple(int(x) for x in args.scales.split(","))
    num_coefs = tuple(int(x) for x in args.num_coefs.split(","))
    cfg = CodecConfig(
        counts=counts, scales=scales, num_coefs=num_coefs,
        block_size=args.block_size, entropy=args.entropy,
        decode_mode=args.decode_mode, num_select=args.num_select,
    )
    report: dict = {"config": json.loads(cfg.to_json())}

    # 1. ground-truth dictionary + corpus (reference §3.1-3.2)
    t0 = time.time()
    truth = MultilevelDictionary.generate(cfg, seed=args.seed)
    truth.save(os.path.join(args.outdir, "truth_dict.npz"))
    figures.dictionary(truth, "truth")
    gen = SignalGenerator(truth, rates=args.rate)
    corpus = gen.generate_signals(args.blocks, cfg.block_size, seed=args.seed + 1)
    report["corpus"] = {"blocks": args.blocks, "seconds": time.time() - t0}
    print(f"[1/5] corpus: {args.blocks} x {cfg.block_size} samples", flush=True)

    # 2. learn dictionaries from scratch (reference §3.5)
    if args.skip_learning:
        learned = truth
    else:
        t0 = time.time()
        trainer = MultilevelTrainer(
            cfg,
            iterations=args.learn_iterations,
            num_windows=min(4096, 16 * args.blocks * cfg.block_size // cfg.scales[0]),
            seed=args.seed,
            checkpoint_dir=os.path.join(args.outdir, "ckpt"),
            device=dev,
        )
        learned = trainer.train(corpus)
        learned.save(os.path.join(args.outdir, "learned_dict.npz"))
        figures.dictionary(learned, "learned")
        report["learning"] = {"seconds": time.time() - t0}
        print(f"[2/5] learned dictionaries in {time.time()-t0:.1f}s", flush=True)

    # 3. encode the corpus with the learned dictionary (configs 2-3)
    t0 = time.time()
    encoder = CorpusEncoder(
        learned,
        device=dev,
        backend=args.backend,
        journal_dir=os.path.join(args.outdir, "journal"),
        metrics_path=os.path.join(args.outdir, "metrics.jsonl"),
    )
    with profile_region(args.profile_dir, dev, "encode.trace.json"):
        blob = encoder.encode(corpus)
    with open(os.path.join(args.outdir, "corpus.hsct"), "wb") as f:
        f.write(blob)
    decoded = encoder.decode(blob)
    snrs = [snr_db(corpus[b], decoded[b]) for b in range(args.blocks)]
    _, stream_blocks = unpack_corpus(blob)
    rates = corpus_rates(cfg, stream_blocks)
    report["encode"] = {
        "seconds": time.time() - t0,
        "compressed_bytes": len(blob),
        "bits_per_sample": rates["bits_per_sample"],
        "compression_ratio": rates["compression_ratio"],
        "mean_snr_db": float(np.mean(snrs)),
    }
    print(
        f"[3/5] encode+decode: {rates['bits_per_sample']:.3f} bits/sample, "
        f"mean SNR {np.mean(snrs):.2f} dB",
        flush=True,
    )

    # 4. rate-distortion sweep, flat vs hierarchical (reference C9 headline)
    budgets = [int(x) for x in args.budget_sweep.split(",")]
    flat = rate_distortion_curve(learned.up_to_level(0), corpus, budgets, device=dev)
    curves = {"flat (level 0)": flat}
    report["rate_distortion"] = {"flat": flat}
    if cfg.num_levels > 1:
        hier = hierarchical_rate_distortion_curve(learned, corpus, budgets)
        curves[f"hierarchical ({cfg.num_levels} levels)"] = hier
        report["rate_distortion"]["hierarchical"] = hier
    print(f"[4/5] rate-distortion sweep at budgets {budgets}", flush=True)

    # 5. figures + report
    from hsc_torch.analysis import (
        coefficient_distribution,
        level_energies,
        visualize_level_diagnostics,
    )

    figures.draw(["rate_distortion.png"], lambda: visualize_rate_distortion(
        curves, path=os.path.join(args.outdir, "rate_distortion.png")
    ))
    # distributed=True: the container stores top-level-only streams, so the
    # per-level views demote singleton-chain events to their native level
    figures.draw(["level_diagnostics.png"], lambda: visualize_level_diagnostics(
        learned, stream_blocks,
        path=os.path.join(args.outdir, "level_diagnostics.png"),
        distributed=True,
    ))
    report["level_energies"] = {
        str(l): v
        for l, v in level_energies(
            learned, stream_blocks, distributed=True
        ).items()
    }
    report["coefficient_distribution"] = {
        str(l): v
        for l, v in coefficient_distribution(
            cfg, stream_blocks, distributed=True
        ).items()
    }
    with open(os.path.join(args.outdir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    figures.report()
    print(f"[5/5] wrote {args.outdir}/report.json", flush=True)
    return report


if __name__ == "__main__":
    main()
