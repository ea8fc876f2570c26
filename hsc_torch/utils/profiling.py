"""Tracing helpers, the port's counterpart of `hsc_tpu/utils/profiling.py`.

`profile_region` collects a `torch.profiler` trace of a region, gated by a
directory (None: off), and `scope` names a span in it, so the stages of a
run are attributable in the trace viewer (chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def profile_region(profile_dir: str | None, device=None, filename: str = "trace.json"):
    """Trace the body (the card's kernels too when `device` is a CUDA
    device) into ``<profile_dir>/<filename>``, a Chrome trace; a no-op when
    `profile_dir` is None."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, filename))


def scope(name: str):
    """A named span for trace attribution: ``with scope('mp/loop'): ...``"""
    return torch.profiler.record_function(name)
