"""One run of one cell of the port's benchmark.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json` at the checkout's root) names a configuration
(`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/traffic/<mix>.json`, whose `client` names
`benchmark/clients/<client>.py`).  A run makes the cell's inputs from the
seed, warms the cell's shapes, drives the port's entry point for
`--seconds`, has the plain reference judge what the window produced, and
prints one JSON line last: the cell's end-to-end metrics with `--trace 0`,
its per-layer metrics (`benchmark/layer_metrics/<metric>.py`) from a
profiled stretch of the window with `--trace 1`.  Beside them (under
`host`) it prints what the host and the card did around the window
(`hscbench/host.py`).

It needs as many CUDA cards as the cell asks for, and exits non-zero,
printing no result, without them; so it does where `sys.modules` holds JAX
or the JAX package once the window has closed.  It writes only under the
temporary directory (`TMPDIR`) and the checkout's `build/` (the kernels'
cache, where `hsc_torch/_build.py` keeps it).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "hsc_tpu")
TRACED_SECONDS = 4.0  # the profiled stretch at the start of a `--trace 1` window


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics that `cell` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [
        m for m in bench["per_layer"]
        if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]
    return e2e, layer


class Run:
    """Everything one run knows; the clients and readers read it."""

    def __init__(self, bench: dict, cell: str, seed: int, seconds: float, trace: bool, device=None):
        import torch

        from hscbench import inputs, traffic
        from hscbench.layers import load_file

        self.bench = bench
        self.cell = next(w for w in bench["workloads"] if w["name"] == cell)
        entry = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        with open(os.path.join(ROOT, entry["file"])) as f:
            self.config = json.load(f)
        self.mix = traffic.load_mix(self.cell["traffic"])
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = None
        self.tracing = bool(trace)
        chips = int(self.cell["chips"])
        if device is None:
            self.devices = [torch.device(f"cuda:{i}") for i in range(chips)]
        else:
            self.devices = [torch.device(device)] * chips
        self.device = self.devices[0]
        self.card_indices = [d.index or 0 for d in self.devices]
        self.ref_cfg = inputs.codec_config(self.config)
        self.ref_mld = inputs.make_dictionary(self.config, self.seed)
        from hsc_torch.params import dictionary_from_arrays

        self.port_mld = dictionary_from_arrays(self.ref_cfg.to_json(), self.ref_mld.dicts)
        self.tmp = tempfile.mkdtemp(prefix="hscbench-")
        mod = load_file(os.path.join(BENCH_DIR, "clients", f"{self.mix['client']}.py"),
                        f"client_{self.mix['client']}")
        self.kernel_modules = mod.KERNELS
        self.client = mod.Client(self)

    def log(self, msg: str) -> None:
        log(msg)

    def synchronize(self) -> None:
        import torch

        for d in set(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def read_trace(self, prof) -> None:
        from hscbench.profile import Trace

        self.trace = Trace.from_profiler(prof, os.path.join(self.tmp, "trace.json"))

    def launches_by_kernel(self) -> dict[str, int]:
        out = {}
        for name, module in self.kernel_modules.items():
            out[name] = int(getattr(importlib.import_module(module), "LAUNCHES", 0))
        return out

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return max(int(torch.cuda.max_memory_allocated(d)) for d in set(self.devices))

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def expected_kernels(run: Run) -> list[str]:
    names = ["int_decode"] if "int_decode" in run.kernel_modules else ["mp_loop"]
    if "int8_init" in run.kernel_modules and run.ref_cfg.num_levels > 1:
        names.append("int8_init")
    return names


def execute(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device=None) -> dict:
    """Set up, measure, judge; returns the result's fields.  `device`
    replaces the cell's cards (the tests drive a run on the CPU)."""
    import torch

    from hscbench import host

    run = Run(bench, cell, seed, seconds, trace, device)
    try:
        client = run.client
        client.setup()
        e2e, layer = cell_metrics(bench, cell)
        before = run.launches_by_kernel()
        setup_s = time.perf_counter() - T_START
        for d in set(run.devices):
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)
        traced_s = min(TRACED_SECONDS, seconds) if trace else None
        probe = host.Window()
        client.window(seconds, traced_s)
        run.synchronize()
        host_state = probe.close(card=run.device.type == "cuda")
        launched = {k: v - before[k] for k, v in run.launches_by_kernel().items()}
        peak = run.memory_peak()
        if trace:
            metrics = {}
            for m in layer:
                mod = run_file(os.path.join(BENCH_DIR, "layer_metrics", f"{m['name']}.py"))
                value = mod.read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = dict(client.end_to_end(), setup_s=setup_s)
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
        client.free()
        readings = client.judge()
        if run.device.type == "cuda":
            readings["kernels_not_launched"] = sum(1 for k in expected_kernels(run) if launched.get(k, 0) <= 0)
        limits = run.config["limits"]
        checks = {name: {"value": float(v), "limit": limits[name]} for name, v in readings.items()}
        correct = client.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
        device_info = {
            "platform": "gpu" if run.device.type == "cuda" else run.device.type,
            "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
            "count": len(set(run.devices)) if run.device.type == "cuda" else int(run.cell["chips"]),
            "memory_peak_bytes": peak,
        }
        result = {"correct": bool(correct), "attempted": client.attempted, "failed": client.failed,
                  "metrics": metrics, "device": device_info}
        if trace and run.trace is not None:
            cards = run.card_indices
            device_info["busy_s"] = sum(run.trace.busy_s(c) for c in cards) / len(cards)
            device_info["window_s"] = run.trace.window_s
            result["breakdown"] = {"device_ops": run.trace.top_ops(10), "idle_gaps": run.trace.idle_gaps(10)}
        result["host"] = host_state
        result["launches"] = launched
        result["checks"] = checks
        return result
    finally:
        cleanup = getattr(run.client, "cleanup", None)
        if cleanup:
            cleanup()
        run.close()


def run_file(path: str):
    from hscbench.layers import load_file

    return load_file(path, "layer_" + os.path.basename(path)[:-3].replace(".", "_"))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 3
    result = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"the run loaded {', '.join(loaded)}: no result")
        return 4
    import hsc_torch._build as build

    result["device"]["power_limit"] = power_limit()
    log(f"card: {result['device']['power_limit']}; kernel build this run: {build.BUILD_SECONDS:.2f} s")
    log(f"host around the window: {json.dumps(result['host'])}")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
