"""Tracing helpers, the port's counterpart of `hsc_tpu/utils/profiling.py`.

`profile_region` collects a `torch.profiler` trace of a region, gated by a
directory (None: off), and `scope` names a span in it, so the stages of a
run are attributable in the trace viewer (chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


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
    """A named span for trace attribution: ``with scope('mp/loop'): ...``.

    A `torch.profiler.record_function` while a profiler runs (the flag
    that `torch.profiler.profile`, `emit_nvtx` and `emit_itt` set), else
    one shared no-op context: tracing is on exactly when someone profiles,
    and a span costs a flag read when nobody does.

    The runtime's hot paths (`hsc_torch/runtime.py`) carry spans named
    ``hsc:<path>.<stage>``, each over one call, batch or chunk, those of
    one path disjoint.  Encode (`CorpusEncoder.encode`, `encode_shard`,
    `encode_multihost`): ``hsc:encode.gather`` (the host batches),
    ``.pipeline`` (first upload to the events on the host), ``.pack`` (a
    batch's trim, bit-packing and journal records), ``.assemble`` (the
    container).  Decode (`decode`, `decode_stream`, `decode_blocks`,
    `CorpusReader`): ``hsc:decode.unpack`` (a chunk of blocks unpacked),
    ``.dispatch`` (a decode unit's staging, uploads, launch and the start
    of its copy-back), ``.drain`` (its wait, copy out of pinned memory and
    host sum), ``.stack`` (the rows joined into one array).  On a mesh
    the parallel layer's ``hsc:mesh.*`` spans (`parallel/dp.py`) split
    each ``hsc:encode.pipeline`` by stage.  In a trace
    that holds the card (`profile_region` with a CUDA device, e.g.
    ``scripts/torch_run_experiment.py --profile-dir``) they sit on the
    kernels' clock."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
