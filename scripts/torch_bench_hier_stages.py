"""Per-level, per-stage hierarchical encode breakdown of the PyTorch / CUDA
port, the counterpart of `scripts/bench_hier_stages.py`.

Measures the device-MARGINAL cost of every stage of the level-pipelined
hierarchical encode:

  init_k   — level-k init: `ops.encode.encode_init_batched` at level 0 (and
             at a `hier_init='f32'` level >= 1, whose conv runs over the
             K_{k-1}-channel feature map in IEEE float32); at an int8 level
             the coder's `init_int_batched` from the level below's events
             (the int8-init kernels on a card)
  loop_k   — level-k greedy loop (`loop_stage`) from a fixed init; the
             kernel updates its scores in place, so every call gets its own
             copy, made before the timing starts
  fmap_k   — the level-k -> k+1 hand-off, `HierarchicalConvolutionalSparseCoder
             .handoff` as it is: for an int8 level above it hands on the
             events themselves and does no device work (since the int8
             init takes events), so its time is the call's host cost; for
             an f32 level it builds the feature map
  total    — `ops.pipeline.encode_hierarchical_batches_pipelined` end to end
  overhead — total - sum(stages): host quantizer steps, drain policy,
             scheduling gaps

Marginal method: each stage runs NB1 and NB2 times back to back, each run
ended by one device synchronize, best of R; the difference over NB2 - NB1
is the stage's cost per batch, net of the fixed cost of a call.

`--init-ab` also times each level's init conv with TF32 allowed for cuDNN
(`cudnn.conv.fp32_precision = 'tf32'`, in a scope that gives the caller's
flag back) — measurement only, never used on an output: TF32 is not the
spec's arithmetic, as the JAX script says of its DEFAULT-precision run.  At
an int8 level it convolves the f32 feature map a `hier_init='f32'` level
would take, and `init_f32_conv_ms` times the same conv in IEEE float32
(`device.spec_numerics`) beside it.

At `--config bench` (counts 32, 16; 8192-sample blocks) or `flagship`
(bench.py:257-262: counts 64, 32; scales 32, 96; 16384-sample blocks;
512 and 192 coefficients), dictionary seed 9, signals seed 5, batches of
`--batch`.  On `--device cpu` it runs the JAX script's CPU leg (counts 8,
4; 512-sample blocks; batches of 4) through the plain versions: a check of
the control flow, not a device number.  `--device` replaces `--platform`:
'cuda' (default; exits if no card is visible), 'cuda:N' or 'cpu'.  The last
line printed is one JSON object.

Usage:
  python scripts/torch_bench_hier_stages.py [--config bench|flagship]
      [--nb1 2 --nb2 6] [--repeats 3] [--device cuda|cpu] [--init-ab]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hsc_torch.cli import _device  # noqa: E402
from hsc_torch.device import device_name, spec_numerics, synchronize  # noqa: E402

CONFIGS = {
    # the bench.py hierarchical operating point
    "bench": dict(
        counts=(32, 16), scales=(32, 96), block_size=8192,
        num_coefs=(256, 128), num_select=8,
    ),
    # the flagship hierarchy: level 0 = the flat flagship geometry (K=64,
    # W=32, 16k blocks), plus a real level 1
    "flagship": dict(
        counts=(64, 32), scales=(32, 96), block_size=16384,
        num_coefs=(512, 192), num_select=8,
    ),
}
# the JAX script's CPU leg
TINY = dict(counts=(8, 4), scales=(8, 24), block_size=512, num_coefs=(16, 8), num_select=1)


@contextlib.contextmanager
def tf32_conv():
    """cuDNN convolutions may use TF32 inside; the caller's flag comes back
    on exit.  Measurement only."""
    import torch

    conv = torch.backends.cudnn.conv
    saved = conv.fp32_precision
    conv.fp32_precision = "tf32"
    try:
        yield
    finally:
        conv.fp32_precision = saved


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="bench", choices=sorted(CONFIGS))
    ap.add_argument("--nb1", type=int, default=2)
    ap.add_argument("--nb2", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; exits if no card is visible), 'cuda:N' or 'cpu'")
    ap.add_argument("--init-ab", action="store_true",
                    help="also time the level inits' conv with TF32 allowed (measurement only: "
                    "what IEEE float32 costs at this level's channel count)")
    return ap.parse_args(argv)


def measure(spec: dict, *, config: str, batch: int, nb1: int, nb2: int, repeats: int, init_ab: bool,
            device) -> dict:
    """Every stage's marginal ms per batch of `batch` blocks at config `spec`
    (`make_test_config` overrides) on `device` -> the output dict."""
    import torch
    import torch.nn.functional as F

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.models import HierarchicalConvolutionalSparseCoder
    from hsc_torch.ops.encode import encode_init_batched, feature_map, quantizer_steps
    from hsc_torch.ops.pipeline import encode_hierarchical_batches_pipelined
    from hsc_torch.utils import Timer

    dev = torch.device(device)
    cfg = make_test_config(**spec)
    mld = MultilevelDictionary.generate(cfg, seed=9)
    gen = SignalGenerator(mld, rates=2e-3)
    xs = gen.generate_signals(batch, cfg.block_size, seed=5)
    xb = xs[:, :, None]
    coder = HierarchicalConvolutionalSparseCoder(mld, device=dev)
    batch_mb = batch * cfg.block_size * 4 / 1e6

    def marginal(prepare) -> float:
        """Best-of-R marginal ms per run between NB1 and NB2 runs;
        `prepare(nb)` sets up outside the timing and returns the runs."""
        def timed(nb):
            run = prepare(nb)
            synchronize(dev)
            with Timer() as t:
                run()
                synchronize(dev)
            return t.elapsed

        timed(nb1)  # warm
        t1 = t2 = float("inf")
        for _ in range(repeats):
            t1 = min(t1, timed(nb1))
            t2 = min(t2, timed(nb2))
        return (t2 - t1) / (nb2 - nb1) * 1e3

    def conv(x, bank):
        return F.conv1d(x.transpose(1, 2).contiguous(), bank.permute(0, 2, 1).contiguous())

    out = {"config": config, "spec": {k: list(v) if isinstance(v, tuple) else v for k, v in spec.items()},
           "batch": batch, "nb": [nb1, nb2], "platform": dev.type}
    stages_ms = 0.0
    xin = torch.from_numpy(xb).to(dev)
    prev = None  # the level below's batch of events
    for level in range(cfg.num_levels):
        mp = coder.coders[level].mp

        def init(mp=mp, xin=xin):
            return mp.init_int_batched(*xin) if mp.int8_init else encode_init_batched(xin, mp.bank)

        s0, e0, peak = init()
        scale, inv = quantizer_steps(peak.cpu().numpy(), mp.settings["amp_bits"])
        enc = mp.loop_stage(s0.clone(), e0, scale, inv)

        m_init = marginal(lambda nb, init=init: lambda: [init() for _ in range(nb)])

        def loop_runs(nb, mp=mp, s0=s0, e0=e0, scale=scale, inv=inv):
            copies = [s0.clone() for _ in range(nb)]  # the kernel writes its scores
            return lambda: [mp.loop_stage(s, e0, scale, inv) for s in copies]

        m_loop = marginal(loop_runs)
        lvl = {
            "init_ms": m_init,
            "loop_ms": m_loop,
            "K": int(mp.bank.shape[0]),
            "W": int(mp.bank.shape[1]),
            "C": int(mp.bank.shape[2]),
            "npos": int(s0.shape[2]),
            "num_coefs": cfg.num_coefs[level],
        }
        stages_ms += m_init + m_loop

        if level + 1 < cfg.num_levels:
            m_fmap = marginal(lambda nb, level=level, enc=enc: lambda: [coder.handoff(level, enc)
                                                                        for _ in range(nb)])
            lvl["fmap_ms"] = m_fmap
            stages_ms += m_fmap

        if init_ab:
            x_map = xin
            if mp.int8_init:  # the f32 map a hier_init='f32' level would take
                x_map = feature_map(prev, npos=cfg.num_positions(level - 1), k=mld.num_atoms(level - 1))

            def tf32_runs(nb, x_map=x_map, bank=mp.bank):
                def run():
                    with tf32_conv():
                        return [conv(x_map, bank) for _ in range(nb)]
                return run

            def ieee_runs(nb, x_map=x_map, bank=mp.bank):
                def run():
                    with spec_numerics():
                        return [conv(x_map, bank) for _ in range(nb)]
                return run

            lvl["init_default_precision_ms"] = marginal(tf32_runs)
            lvl["init_f32_conv_ms"] = marginal(ieee_runs)

        out[f"level{level}"] = lvl
        if level + 1 < cfg.num_levels:
            xin = coder.handoff(level, enc)
        prev = enc

    # --- total: the production level-pipelined path -------------------------
    m_total = marginal(lambda nb: lambda: encode_hierarchical_batches_pipelined([xb] * nb, coder))
    out["total_ms_per_batch"] = m_total
    out["stages_sum_ms"] = stages_ms
    out["overhead_ms"] = m_total - stages_ms
    out["hier_mb_s_marginal"] = batch_mb / (m_total / 1e3)
    out["device"] = device_name(dev)
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = _device(args)  # as the port's CLI resolves it: no CPU fallback
    spec, batch = (TINY, 4) if dev.type == "cpu" else (CONFIGS[args.config], args.batch)
    out = measure(spec, config=args.config, batch=batch, nb1=args.nb1, nb2=args.nb2, repeats=args.repeats,
                  init_ab=args.init_ab, device=dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
