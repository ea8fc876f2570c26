"""The readings that a cell's limits are set from: for each seed, the
program's sound run and the control (the reference at the next precision
below the configuration's, put in the program's place), judged by the same
comparison on the same sample.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]

One process for all seeds, so the kernels build once.  Per seed one JSON
line (`program`, `control`, the judge's seconds); last, per number, the
largest program reading (the lower end of its limit) and the smallest
control reading (the upper end).  Needs the cell's cards, as a run does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    bench = bench_run.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s)", file=sys.stderr)
        return 3
    lows: dict[str, float] = {}
    highs: dict[str, float] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = bench_run.Run(bench, args.workload, seed, args.seconds, False)
        try:
            run.client.setup()
            run.client.window(args.seconds, None)
            run.synchronize()
            run.client.free()
            t0 = time.perf_counter()
            prog = run.client.judge()
            judge_s = time.perf_counter() - t0
            ctrl = run.client.judge(control=True)
            line = {"seed": seed, "attempted": run.client.attempted, "failed": run.client.failed,
                    "judge_s": judge_s, "program": prog, "control": ctrl}
            print(json.dumps(line), flush=True)
            for k, v in prog.items():
                lows[k] = max(lows.get(k, v), v)
            for k, v in ctrl.items():
                highs[k] = min(highs.get(k, v), v)
        finally:
            cleanup = getattr(run.client, "cleanup", None)
            if cleanup:
                cleanup()
            run.close()
            del run
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lows, "control_least": highs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
