#!/usr/bin/env python3
"""The host waits and transfers of one tree's corpus encode and decode on
an NVIDIA card, for comparing two trees in one chip call.

    python3 scripts/torch_transfer_ab.py [--root DIR] [--label NAME] [--repeats N]

`--root` is the tree whose `hsc_torch` is imported (default: this
repository); run a parent tree unpacked from `git archive` and this one in
turns (P C C P) in one call (`chip_smoke.py` phase 19 does).  For the flat
flagship (dictionary seed 7, signals seed 3) and the flagship hierarchy of
`bench.py:257-262` (dictionary seed 9, signals seed 5), 128 blocks each,
`CorpusEncoder(device="cuda")` at its default batch of 64, after one warm
encode and decode it prints:

  - the encode and decode rates (host wall, MB/s of float32 samples) of
    `--repeats` runs, and the SHA-256 of the container and of the decoded
    rows, which must be the same in every run (and on both trees);
  - the synchronizing CUDA calls of one encode and one decode, by file and
    line, as torch's sync debug mode reports them, and the CUDA event waits
    (`torch.cuda.Event.synchronize`) by the line that asked for them;
  - whether the sync debug mode reports an event wait at all;
  - the device's idle share in a profile of one encode and one decode, and
    the profile's copies by name ("Pinned" or "Pageable" host memory);
  - the peak of PyTorch's pinned host pool (`torch.cuda.host_memory_stats`)
    after those cells, and after the bench's flat pipeline (16 batches of
    64 blocks at `window=None`, every batch's staging live at once);
  - the host time to stage one 64-block batch in pinned memory per call
    (`pin_memory()`) against a copy into one pinned buffer kept for reuse,
    and to copy its decoded rows back, pageable against pinned.

It fails if a run's container or rows differ from the first run's, or
from the serial path's: each 64-block batch encoded alone
(`coder.encode_batch`) and each decoded alone (`coder.reconstruct_batch`).
Each line is tagged with `--label`; the last line is one JSON object with
these numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BLOCKS, BATCH = 128, 64
# the files whose host waits the transfer layer removes from the batch loops
LOOP_FILES = ("hsc_torch/ops/pipeline.py", "hsc_torch/models/coder.py", "hsc_torch/runtime.py")


def _smoke():
    """This repository's chip_smoke.py (its configs and measuring helpers),
    whatever tree `hsc_torch` comes from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _where(filename: str, lineno: int, root: str) -> str:
    """``file:line`` relative to the tree's root where it lies inside it."""
    path = os.path.abspath(filename)
    if path.startswith(root + os.sep):
        path = os.path.relpath(path, root)
    return f"{path}:{lineno}"


def counted_waits(smoke, fn, root: str):
    """``(fn(), syncs, event_waits)``: the synchronizing CUDA calls of
    `fn` (torch's sync debug mode, `chip_smoke.sync_count`) and its CUDA
    event waits, each by ``file:line``: for an event wait the first caller
    outside `hsc_torch/device.py` and `hsc_torch/utils/__init__.py`, the
    line that asked for the values."""
    import torch

    waits = []
    real = torch.cuda.Event.synchronize
    skip = (os.path.join("hsc_torch", "device.py"), os.path.join("hsc_torch", "utils", "__init__.py"))

    def synchronize(self):
        f = sys._getframe(1)
        while f.f_back is not None and f.f_code.co_filename.endswith(skip):
            f = f.f_back
        waits.append(_where(f.f_code.co_filename, f.f_lineno, root))
        return real(self)

    torch.cuda.Event.synchronize = synchronize
    try:
        out, syncs = smoke.sync_count(fn)
    finally:
        torch.cuda.Event.synchronize = real
    return out, [_where(f, int(line), root) for f, line in (s.rsplit(":", 1) for s in syncs)], waits


def tally(lines: list[str]) -> dict[str, int]:
    out: dict[str, int] = {}
    for line in lines:
        out[line] = out.get(line, 0) + 1
    return dict(sorted(out.items()))


def copies_by_name(trace_path: str) -> dict[str, int]:
    """The profile's device copies (memcpy events) counted by name; the
    name says whether the host side was pinned or pageable memory."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    return tally([e["name"] for e in events if e.get("cat") == "gpu_memcpy"])


def serial_check(codec, xs, blob, rows, unpack_corpus) -> None:
    """Raise unless the container's streams are those of each 64-block
    batch encoded alone, and the rows those of each batch of streams
    decoded alone (the serial path: no pipeline, no window)."""
    import numpy as np

    top = codec.cfg.num_levels - 1
    _, blocks = unpack_corpus(blob)
    streams = [s[0][1] for s in blocks]
    for lo in range(0, len(xs), BATCH):
        serial = [s[top] for s in codec.coder.encode_batch(xs[lo : lo + BATCH])]
        for b, (got, want) in enumerate(zip(streams[lo : lo + BATCH], serial)):
            for name in ("positions", "atoms", "codes"):
                if getattr(got, name).tobytes() != getattr(want, name).tobytes():
                    raise RuntimeError(f"block {lo + b}: container {name} != the serial encode's")
            if np.float32(got.scale).tobytes() != np.float32(want.scale).tobytes():
                raise RuntimeError(f"block {lo + b}: container scale != the serial encode's")
        dec = codec.coder.reconstruct_batch(streams[lo : lo + BATCH])
        if dec.tobytes() != rows[lo : lo + BATCH].tobytes():
            raise RuntimeError(f"blocks {lo}..: decoded rows != the serial decode's")


def staging_ms(reps: int = 20) -> dict:
    """Host ms to stage one ``[64, 16384, 1]`` float32 batch in pinned
    memory: a fresh `pin_memory()` per call (from the caching host
    allocator, which the transfer layer uses) against a copy into one
    pinned buffer kept for reuse; each followed by the non-blocking upload
    and a wait for it, medians of `reps` calls."""
    import statistics

    import numpy as np
    import torch

    dev = torch.device("cuda")
    x = np.random.default_rng(0).standard_normal((BATCH, 16384, 1)).astype(np.float32)
    ring = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)

    def per_call():
        return torch.from_numpy(x).pin_memory()

    def reused():
        return ring.copy_(torch.from_numpy(x))

    out = {}
    for name, stage in (("pin_memory", per_call), ("reused_buffer", reused)) * 2:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            staged = stage()
            t1 = time.perf_counter()
            staged.to(dev, non_blocking=True)
            torch.cuda.synchronize()
            times.append((t1 - t0) * 1e3)
        out[name] = statistics.median(times)  # the second turn's, warm
    return out


def copyback_ms(reps: int = 20) -> dict:
    """Host ms to bring one decoded 64-block batch of rows ``[64, 16384,
    1]`` float32 back: a pageable ``.cpu()`` (a synchronized copy) against
    a copy into pinned memory waited for on its event, with and without
    the copy out of the staging into an array of its own (what
    `HostCopy.numpy` does); medians of `reps` calls, the second of two
    turns.  Written with torch's own calls, so both trees time the same
    code."""
    import statistics

    import torch

    dev = torch.device("cuda")
    rows = torch.randn((BATCH, 16384, 1), device=dev)

    def pinned(own: bool):
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
        return host.numpy().copy() if own else host.numpy()

    out = {}
    ways = (("pageable", lambda: rows.cpu().numpy()), ("pinned", lambda: pinned(False)),
            ("pinned_then_own_array", lambda: pinned(True)))
    for name, fn in ways * 2:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="tree whose hsc_torch is imported")
    ap.add_argument("--label", default="change")
    ap.add_argument("--repeats", type=int, default=3, help="timed encodes and decodes per cell")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_transfer_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import hsc_torch
    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.io import unpack_corpus
    from hsc_torch.ops.pipeline import encode_batches_pipelined
    from hsc_torch.runtime import CorpusEncoder

    smoke = _smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    tag = f"[{args.label}]"
    print(f"{tag} hsc_torch from {os.path.dirname(hsc_torch.__file__)}; card {smi}", flush=True)
    dev = torch.device("cuda")

    ev = torch.cuda.Event()
    ev.record()
    _, event_syncs = smoke.sync_count(ev.synchronize)
    out = {"tree": args.label, "card": smi, "sync_debug_reports_event_wait": bool(event_syncs)}
    print(f"{tag} torch's sync debug mode reports an Event.synchronize: {bool(event_syncs)}", flush=True)
    cells = [("flat", smoke.FLAGSHIP, 7, 3), ("hier", smoke.HIER, 9, 5)]
    for name, kw, dseed, sseed in cells:
        cfg = make_test_config(**kw)
        mld = MultilevelDictionary.generate(cfg, seed=dseed)
        xs = SignalGenerator(mld, rates=2e-3).generate_signals(N_BLOCKS, cfg.block_size, seed=sseed)
        codec = CorpusEncoder(mld, device=dev)
        blob = codec.encode(xs)  # warm: the kernels are built and every shape seen
        rows = codec.decode(blob)
        serial_check(codec, xs, blob, rows, unpack_corpus)
        mb = N_BLOCKS * cfg.block_size * 4 / 1e6
        enc_rate, dec_rate = [], []
        for r in range(args.repeats):
            got = []
            enc_rate.append(mb / smoke.wall_s(lambda: got.append(codec.encode(xs))))
            dec_rate.append(mb / smoke.wall_s(lambda: got.append(codec.decode(got[0]))))
            if got[0] != blob or got[1].tobytes() != rows.tobytes():
                raise RuntimeError(f"{name}: run {r + 1} gave other container bytes or rows than the first")
        blob_e, enc_syncs, enc_waits = counted_waits(smoke, lambda: codec.encode(xs), root)
        rows_d, dec_syncs, dec_waits = counted_waits(smoke, lambda: codec.decode(blob), root)
        if blob_e != blob or rows_d.tobytes() != rows.tobytes():
            raise RuntimeError(f"{name}: the counted run gave other container bytes or rows")
        profiles = {}
        for what, fn in (("encode", lambda: codec.encode(xs)), ("decode", lambda: codec.decode(blob))):
            path = os.path.join(ROOT, "build", "transfer_ab", f"{args.label}_{name}_{what}.json")
            prof = smoke.device_profile(fn, path)
            profiles[what] = {"wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
                              "idle": 1 - prof["busy_ms"] / prof["wall_ms"], "copies": copies_by_name(path)}
        cell = {
            "container_sha256": hashlib.sha256(blob).hexdigest(),
            "rows_sha256": hashlib.sha256(rows.tobytes()).hexdigest(),
            "container_bytes": len(blob),
            "encode_mb_s": enc_rate,
            "decode_mb_s": dec_rate,
            "encode_syncs": tally(enc_syncs),
            "decode_syncs": tally(dec_syncs),
            "encode_event_waits": tally(enc_waits),
            "decode_event_waits": tally(dec_waits),
            "loop_file_syncs": sum(1 for s in enc_syncs + dec_syncs if s.startswith(LOOP_FILES)),
            "profile": profiles,
        }
        out[name] = cell
        print(f"{tag} {name}: encode {smoke.stats(enc_rate, 'MB/s', '.2f')}, decode "
              f"{smoke.stats(dec_rate, 'MB/s', '.2f')}; container {len(blob)} bytes sha256 "
              f"{cell['container_sha256'][:16]}, rows sha256 {cell['rows_sha256'][:16]}; the same in "
              f"{args.repeats} runs and bitwise the serial path", flush=True)
        for what in ("encode", "decode"):
            p = profiles[what]
            print(f"{tag} {name} {what}: syncs {len(enc_syncs if what == 'encode' else dec_syncs)} "
                  f"{json.dumps(cell[f'{what}_syncs'])}; event waits {json.dumps(cell[f'{what}_event_waits'])}; "
                  f"profiled wall {p['wall_ms']:.2f} ms, device busy {p['busy_ms']:.2f} ms (idle "
                  f"{100 * p['idle']:.1f}%); copies {json.dumps(p['copies'])}", flush=True)
        del codec
        torch.cuda.empty_cache()
    out["host_pinned_peak_bytes"] = torch.cuda.host_memory_stats().get("allocated_bytes.peak")
    # the bench's flat cell: 16 batches with every init dispatched first
    # (`window=None`), so every batch's staging is live at once
    cfg = make_test_config(**smoke.FLAGSHIP)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(BATCH, cfg.block_size, seed=3)
    mp = CorpusEncoder(mld, device=dev).coder.coders[0].mp
    encode_batches_pipelined([xs[:, :, None]] * 16, mp.params, device=dev, window=None, **mp.settings)
    torch.cuda.synchronize()
    out["host_pinned_peak_bytes_window_none"] = torch.cuda.host_memory_stats().get("allocated_bytes.peak")
    out["staging_ms"] = staging_ms()
    out["copyback_ms"] = copyback_ms()
    print(f"{tag} pinned host pool peak {out['host_pinned_peak_bytes']} bytes, after 16 flat batches at "
          f"window None {out['host_pinned_peak_bytes_window_none']}; staging one batch: "
          f"{json.dumps(out['staging_ms'])} ms; copying its rows back: {json.dumps(out['copyback_ms'])} ms",
          flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"torch_transfer_ab: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
