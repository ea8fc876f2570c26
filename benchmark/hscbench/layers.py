"""Arithmetic shared by the per-layer readers (`benchmark/layer_metrics/`)."""

from __future__ import annotations

import importlib.util
import json
import os

ROOFLINE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "roofline")


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks() -> dict:
    with open(os.path.join(ROOFLINE_DIR, "peaks.json")) as f:
        return json.load(f)


def roofline_file(kernel: str):
    return load_file(os.path.join(ROOFLINE_DIR, f"{kernel}.py"), f"roofline_{kernel}")


def least_seconds(kernel: str, launches: list[dict]) -> float:
    """The least time the card could take for `launches` of `kernel`: per
    launch the larger of its bytes over the memory rate and its operations
    over the float32 rate (`roofline/peaks.json`)."""
    mod = roofline_file(kernel)
    p = peaks()
    total = 0.0
    for launch in launches:
        ops, nbytes = mod.work(launch)
        total += max(nbytes / p["hbm_bytes_per_s"], ops / p["fp32_scalar_ops_per_s"])
    return total


def roofline_pct(run, kernel: str) -> float | None:
    """The traced launches' least time over the profiler's device time of
    the kernel, in %; None where the trace holds none of its launches, or
    not as many as the client counts."""
    if run.trace is None:
        return None
    mod = roofline_file(kernel)
    launches = run.client.launches().get(kernel, [])
    device_s, n = run.trace.kernel_s(*mod.KERNELS)
    per_launch = len(mod.KERNELS)
    if not launches or device_s <= 0 or n != per_launch * len(launches):
        run.log(f"{kernel}_roofline: {n} kernel events in the trace for {len(launches)} launches counted: not read")
        return None
    return 100.0 * least_seconds(kernel, launches) / device_s


def idle_pct(run, cards: list[int]) -> float | None:
    """The mean over `cards` of each card's idle share of the traced window."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    shares = [1.0 - run.trace.busy_s(c) / run.trace.window_s for c in cards]
    return 100.0 * sum(shares) / len(shares)
