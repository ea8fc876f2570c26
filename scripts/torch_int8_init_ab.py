#!/usr/bin/env python3
"""Time the int8 level-1 init route and the hierarchical encode of one tree
of the port on an NVIDIA card, for comparing two trees in one chip call.

    python3 scripts/torch_int8_init_ab.py [--root DIR] [--label NAME]

`--root` is the tree whose `hsc_torch` is imported (default: this
repository); run a parent tree unpacked from `git archive` and this one in
turns (P C C P) in one call.  At the flagship hierarchy of
`bench.py:257-262` (dictionary seed 9, signals seed 5, 128 blocks) it
prints, per 64-block batch and with CUDA events (median [range]):

  - the whole int8 init route of a tree, ``mp1.init_int_batched(
    *coder.handoff(0, enc0))`` (the same call on the parent tree too),
    and its hand-off alone; on a tree that still has the dense-map kernel
    (`init_kernels.sparse_init_raw`) also that kernel alone;
  - the hierarchical `CorpusEncoder.encode` rate (host wall, MB/s);
  - one profiled hierarchical encode: host wall, device busy and idle
    share, device ms by kernel, the device ms launched inside the hand-offs
    and inside the level-1 init, and the host-to-device copies and stream
    synchronisations the CPU issued inside the level-1 init.

The last line is one JSON object with these numbers and the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIER = dict(counts=(64, 32), scales=(32, 96), block_size=16384, num_coefs=(512, 192), num_select=8)
N_BLOCKS, BATCH = 128, 64


def _smoke():
    """This repository's chip_smoke.py (its timing and profile helpers),
    whatever tree `hsc_torch` comes from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_calls(trace_path: str, range_name: str) -> dict:
    """CUDA runtime calls the CPU made inside `range_name` ranges of a chrome
    trace, by name (copies and synchronisations are the ones that matter)."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == range_name and "dur" in e]
    calls: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and any(lo <= float(e["ts"]) <= hi for lo, hi in spans):
            calls[e["name"]] = calls.get(e["name"], 0) + 1
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="tree whose hsc_torch is imported")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_int8_init_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import hsc_torch
    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.ops import init_kernels
    from hsc_torch.runtime import CorpusEncoder

    smoke = _smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[{args.label}] hsc_torch from {os.path.dirname(hsc_torch.__file__)}; card {smi}", flush=True)
    dev = torch.device("cuda")
    cfg = make_test_config(**HIER)
    mld = MultilevelDictionary.generate(cfg, seed=9)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(N_BLOCKS, cfg.block_size, seed=5)
    codec = CorpusEncoder(mld, device=dev)
    coder = codec.coder
    mp1 = coder.coders[1].mp
    enc0 = coder.coders[0].mp.compute_coefficients_batch(torch.from_numpy(xs[:BATCH]).to(dev))
    codec.encode(xs)  # warm: the kernels are built and every shape seen

    def turns_ms(fn, reps=10, rounds=4):
        return [smoke.cuda_ms(fn, reps) for _ in range(rounds)]

    out = {"tree": args.label, "card": smi}
    out["route_ms"] = turns_ms(lambda: mp1.init_int_batched(*coder.handoff(0, enc0)))
    out["handoff_ms"] = turns_ms(lambda: coder.handoff(0, enc0))
    if hasattr(init_kernels, "sparse_init_raw"):
        m_int, ps = coder.handoff(0, enc0)
        out["dense_kernel_ms"] = turns_ms(
            lambda: init_kernels.sparse_init_raw(m_int, ps, mp1.bank_planes, mp1.bank_step))
    mb = N_BLOCKS * cfg.block_size * 4 / 1e6
    out["encode_mb_s"] = [mb / smoke.wall_s(lambda: codec.encode(xs)) for _ in range(3)]

    handoff, init = coder.handoff, mp1.init_int_batched

    def annotated_handoff(level, enc):
        with torch.profiler.record_function("hand-off"):
            return handoff(level, enc)

    def annotated_init(*a):
        with torch.profiler.record_function("int8 init"):
            return init(*a)

    coder.handoff, mp1.init_int_batched = annotated_handoff, annotated_init
    trace = os.path.join(ROOT, "build", "chip_smoke", f"trace_int8_ab_{args.label}.json")
    try:
        prof = smoke.device_profile(lambda: codec.encode(xs), trace)
    finally:
        del coder.handoff, mp1.init_int_batched
    out.update(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
               idle=1 - prof["busy_ms"] / prof["wall_ms"], by_range=prof["by_range"],
               by_name=dict(sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:10]),
               init_host_calls=host_calls(trace, "int8 init"))
    for key in ("route_ms", "handoff_ms", "dense_kernel_ms"):
        if key in out:
            print(f"[{args.label}] {key}: {smoke.stats(out[key], 'ms')}", flush=True)
    print(f"[{args.label}] hierarchical encode: {smoke.stats(out['encode_mb_s'], 'MB/s', '.2f')}; profiled: wall "
          f"{out['wall_ms']:.2f} ms, busy {out['busy_ms']:.3f} ms (idle {100 * out['idle']:.1f}%), device ms in "
          f"ranges {out['by_range']}", flush=True)
    print(f"[{args.label}] device ms by name: {out['by_name']}", flush=True)
    print(f"[{args.label}] CUDA calls inside the level-1 inits: {out['init_host_calls']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"torch_int8_init_ab: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
