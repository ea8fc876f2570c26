#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on an NVIDIA card.

    python3 chip_smoke.py

At the single-level flagship configuration (16384-sample blocks, 64 atoms
of width 32, 512 coefficients, num_select=8, integer decode) it:

  1. requires a CUDA device and prints the card, power limit and toolchain;
  2. builds the hand-written kernels from hsc_torch/csrc;
  3. holds the init within 1e-5 of the exact (float64) correlation (IEEE
     float32, pinned at the conv; the oracle's float32 einsum is logged
     beside it), and
     the greedy-loop kernel bitwise against its plain PyTorch version
     (num_select 8, 1 and 3, plus an SNR stop and an all-zero block) and two
     blocks per setting against the NumPy oracle with the port's init
     injected; then the edge cases of its one-pass sweep, each bitwise the
     plain loop and the oracle: the 2W-1 guard, the budget and the SNR stop
     reached mid-sweep, num_select 1 to 48 (past the 32 lanes that take the
     candidates) at K=80 with npos not a multiple of 128, the flagship
     hierarchy's level-1 geometry (K=96, W=65) and 12 random geometries;
  4. holds the integer-decode kernel bitwise against its plain version and
     the oracle, including a batch whose sums wrap past 2^31 and an edge
     batch (70001-sample blocks, atoms wider than a tile, 3001 events in
     one tile, an empty block, dead events);
  5. encodes 128 blocks with CorpusEncoder(device='cuda') twice (identical
     bytes), decodes them (bitwise the oracle's integer decode of the
     unpacked streams) and shows both kernels were launched on that path;
  6. times both kernels against their plain versions and the codec end to
     end on both backends (in turns, median and range), times the init, and
     profiles one encode and one decode (device-busy share and time by
     kernel; the traces go to build/chip_smoke/).  The loop kernel updates
     its scores in place, so each timed launch gets a fresh copy made
     outside its CUDA events; its device time is the profile's.  The
     decode kernel's device time is a CUDA graph of 20 launches replayed
     between CUDA events; its host time per call is 50 back-to-back calls.

At the flagship hierarchy of `bench.py:257-262` (levels of 64 and 32 raw
atoms, scales 32 and 96, 512 and 192 coefficients, num_select=8, the int8
level-1 init; dictionary seed 9, signals seed 5) it then:

  7. holds the int8-init kernels (events in; the whole score buffer, e0 and
     peak out) against their plain route (the dense hand-off map, then the
     dense init) on the level-0 events of a real 64-block encode — scores
     and peak bitwise, e0 within 1e-6 relative — and against
     `oracle.int8_init_scores` on 2 blocks, and on adversarial batches of
     4096, 8193, 16384, 20000 and 65281 events per block (an all-zero block,
     a cell of 64 events, cells at the four-digit bound from large codes,
     events past `count`, at N - W < pos < N and off the map), logging which
     route each took (the cell kernel's sort in shared memory up to 16384
     events, in a global workspace past that) and timing the global route
     at 20000 (also its device time in a CUDA graph, the plain route's
     time, and the float64 conv1d of that map against the bank codes);
  8. holds the ordered-decode kernel bitwise against its plain version on
     64 top streams and against `oracle.hierarchical_decode` on every block,
     and on phase 4's edge batch against `oracle.mp.mp_decode`; then at
     C = 64 channels (the level-space decode of the level-1 streams against
     level 1's augmented bank) against the plain version, `oracle.mp.mp_decode`
     on 2 blocks and the coder's single-block `reconstruct`, with its device
     time (a CUDA graph), host time per call, plain version's time and
     bound;
  9. drives the hierarchy end to end on 128 blocks through CorpusEncoder in
     both decode modes and both container forms, counted: repeated encodes
     give identical bytes, level 1 is bitwise the oracle's greedy loop on
     the oracle's int8 init on 2 blocks, decodes are bitwise the oracle's,
     distributed rows are the per-level oracle sums, backend='torch' gives
     the same containers and rows, all four kernels were launched, and the
     CUDA path never called the dense hand-off map (`feature_map_int`) or
     the torch epilogue (`int8_assemble_batched`);
 10. times the int8-init, ordered-decode and level-1 greedy-loop kernels
     against their plain versions and the hierarchical codec on both
     backends (in turns), and profiles one hierarchical encode, with the
     device time of the level hand-offs split out (the int8 init's device
     time is the profile's; the ordered decode's as in phase 6), and one
     ordered decode.

Then:

 11. encodes and decodes 4 blocks of 65536 samples (16 atoms of width 32,
     512 coefficients) with CorpusEncoder(device='cuda'), whose
     greedy loop keeps its selection cache in a global workspace (it does
     not fit the card's shared memory), counted on its own: containers and
     rows equal backend='torch', rows bitwise the oracle's integer decode.
 12. a 2-level hierarchy whose level 0 keeps 20000 events per block
     (32768-sample blocks, so the level-1 int8 init takes the global route)
     through CorpusEncoder(device='cuda') on 4 blocks, counted, equal to
     backend='torch'; then, on the flat flagship's 128 blocks of phase 5,
     the serving surfaces (`encode(index=True)`, `decode_blocks` and
     `decode_stream(indices=...)` on 40 shuffled blocks, `CorpusReader`
     rows), `target_bps` containers in both rate modes (equal to
     backend='torch'), all counted, and a journal resume that gives the same
     bytes and launches no kernel.
 13. learning and the CLI: (a) `learn.kmeans_refine_device` at
     `bench.py:291-296`'s geometry (65536 windows of 32, 64 centroids, 20
     iterations) within 1e-5 of the same call on the CPU, with no host sync
     inside the loop (torch's sync debug mode counts them, checked against
     a copy that must count one), timed and profiled; (b) `learn.MultilevelTrainer`
     at the flagship hierarchy (64 blocks, 4096 windows, 20 iterations),
     counted, its level-0 encode bitwise the plain loop's, a second run
     bitwise the first, wall time split into device (profile) and host
     time, then the learned dictionary through CorpusEncoder; (c)
     `learn.OnlineConvolutionalDictionaryLearner` on a random unit-norm bank
     at the flat flagship (64 blocks, 512 coefficients, 5 steps), counted:
     the loss falls, `_OverlapAdd`'s forward is bitwise the plain decode and
     its gradient within 1e-4 of autograd through the plain decode in
     float64, two runs give the same bank bitwise; (d)
     `analysis.rate_distortion_curve(use_device=True)` on 2 flagship blocks:
     the oracle's rates, its SNR within 0.15 dB; (e) the CLI in
     subprocesses with no `--device` (so on the card): `learn` of 2 levels,
     `encode`, `info`, `decode` and `decode --range 1:3`, rows bitwise an
     in-process CorpusEncoder's decode, `info` equal to
     `analysis.corpus_rates`.
 14. the parallel layer on meshes of 4 shards of the one card
     (`hsc_torch.parallel`): (a) the level-0 init of 64 flagship blocks
     bitwise the same at batch 64, 32, 17 and 1; CorpusEncoder(mesh=...) at
     batch_size 32 on phase 5's 128 blocks, counted, its container equal to
     the local batch-32 and phase 5's batch-64 containers, its rows to
     phase 5's, a ragged corpus of 101 blocks equal to the local path, and
     encode and decode timed in turns with the local path; (b) the
     hierarchical DP codec at the flagship hierarchy, with hier_init='f32'
     and at 3 levels (counts 64, 32, 16; scales 32, 96, 288), containers
     equal to the local path and backend='torch', the top streams through
     `DataParallelDecoder` in both modes bitwise the local and plain
     decodes; (c) SP on one 65536-sample block of phase 11's config on
     {'seq': 4} and (d) TP on one flat-flagship block on {'model': 4}:
     given the local init, bitwise the local kernel loop at num_select 1
     and 8 and at an SNR stop, timed per block; with their own init, the
     init within 1e-5 of the peak of the local one and the stream equal to
     the local one or its first differing event named; (e) distributed
     k-means at phase 13a's geometry, timed, bitwise run to run, every atom
     within |cos| > 0.99 of the local loop's, and the online learner on the
     mesh (64 blocks, 5 steps), counted, bitwise run to run, its first step
     within 1e-4 (loss) and 1e-5 (bank) of the local learner's; (f) the CLI
     `encode --mesh 1 --device cuda` equal to no mesh, and `--mesh N` past
     the visible cards exits naming them.
 15. the hardware gates: (a) scripts/torch_fuzz_parity.py at fixed seeds,
     each shape logged — 8 random single-level geometries (at least 2 with
     a window of 130 or more) bitwise the plain loop and the oracle on the
     kernel's init, 4 random 2-level hierarchies (int8 or f32 hand-off)
     every level bitwise the pinned oracle and backend='torch' and the top
     streams' decodes in both modes bitwise the oracle, and 4 random
     containers (entropy, distributed, CBR, seek index sampled) encoded
     twice to the same bytes, decoded on the card byte-identically to a
     CPU decode of the same file in a subprocess and bitwise the oracle's
     decode; (b) the parity gauntlet's check 5b, the integer-decode kernel
     at W = 33, 48 and 59; (c) its check 7, the greedy-loop kernel at W =
     160.  The gauntlet's other checks are phases above (ROADMAP Queue 1
     item 4 maps them).
 16. the experiment drivers through their `main`, each counted, into a
     fresh directory: scripts/torch_run_experiment.py at the flat flagship
     (64 blocks, learning and the budget sweep at their defaults) and at
     its own 2-level defaults; scripts/torch_run_audio_experiment.py at
     its defaults (16 s of synthesized music, the int8 level-1 init) and
     on music and speech in integer mode at a corpus-wide 0.5 bits a
     sample, their oracle R-D prefix cut to 1 block and budgets 16, 128.
     Every run writes its files (no figures, and a line naming them, where
     matplotlib is absent); the audio runs' re-encode and streaming-decode
     assertions hold on the card; each container's first and last block
     decode bitwise the oracle, and `backend='torch'` writes the same
     container; all four kernels launch across the runs.
 17. the measuring scripts through their `main`, each counted, their JSON
     lines logged: scripts/torch_bench_serving.py at 2048 flat-flagship
     blocks (seek, scan, reader and encode latency, stream MB/s, the
     streamed rows byte-identical to the seeked ones), the decode marginal
     in both modes, the encode stages at num_select 8, the hierarchy's
     stages at the flagship hierarchy with the TF32 init A/B, and the mesh
     overhead at 1, 2 and 4 shards of the card, flat encode and decode;
     all four kernels launch across the runs.  17b: with the caller's TF32
     flags on (`cudnn.conv.fp32_precision = 'tf32'`,
     `set_float32_matmul_precision('high')`), a fresh CorpusEncoder writes
     phase 5's container byte for byte and k-means at phase 13a's geometry
     gives the IEEE run's centroids bit for bit, so does the init
     correlation of a 64-channel map, the flags read as set afterwards,
     and outside the pinned scope the same conv and product do move.
 18. scripts/torch_bench.py, the counterpart of `bench.py`, through its
     `main` at bench.py's full sizes, counted, every line it prints
     logged (its JSON line among them): the oracle on one block, the flat
     flagship's 16 batches of 64 blocks at num_select 1 and 8, the
     integer decode of 16384 blocks and the ordered decode of 2048, the
     2-level hierarchies on 32 x 64 and 16 x 64 blocks, k-means at 65536 x
     32 with 64 centroids and 20 iterations; each cell's first batch
     bitwise the plain version before its timed runs, every timed run's
     counts those of its warm-up; all four kernels launch, and the
     bench's own launch counts are the phase's.
 19. the transfers: scripts/torch_transfer_ab.py on this tree and on its
     parent (`build/parent` where a caller unpacked it with `git archive
     HEAD~1`, else unpacked here from the checkout's history; without
     either only this tree runs), in turns (P C C P), each a subprocess:
     at the flat flagship and the flagship hierarchy (128 blocks each)
     `CorpusEncoder.encode` and `.decode`, 3 repeats, their containers and
     rows the same in every run, bitwise the serial path's and the same
     on both trees; on this tree no synchronizing CUDA call (torch's sync
     debug mode) from `ops/pipeline.py`, `models/coder.py` or
     `runtime.py`, every host copy in the profiles "Pinned"; the
     synchronizing calls and event waits by file:line, the host-wall
     MB/s and the device's idle share of both trees logged side by side.
 20. the gates' blind spots: scripts/torch_fuzz_parity.py's --batch,
     --long, --three-level, --container-f32 and --mesh modes at fixed
     seeds, counted, every shape logged and bitwise: corpora of up to 200
     blocks (more than the card's SMs) the same at batch 1, odd and whole
     and the kernel loops the plain loops; blocks of 12288-65536 samples
     on both of the loop kernel's routes and the int8 init's global sort
     (the kernels' workspaces those the script's H100 rules predict);
     3-level hierarchies with each hier_init; 2- and 3-level containers
     with the f32 hand-off, one distributed; ragged corpora on meshes of
     2-4 shards with SP and TP; the phase fails if the shapes did not
     cover each of these.
 21. the parallel layer across cards: with 2 or more cards visible,
     scripts/torch_multicard.py --mode all --cards min(4, N) in a
     subprocess, its lines logged; any failed check fails the phase (the
     one-process mesh with shard i on card i mod N and the NCCL
     multi-process encode, each held bytewise to the same work on one
     card).  With one card it logs "[21] not run: 1 card visible", which
     is not a pass, and the line before the kernels' line says
     ``{"multicard": {"cards": 1, "ran": false}}``.

Every phase is fatal on failure.  The NumPy spec it checks against is the
port's own copy (`hsc_torch.oracle`, `hsc_torch.io`); the script fails if
JAX, optax, orbax or any module of the JAX package `hsc_tpu` was imported.  Before the
last line it prints one JSON object with every kernel (launches on the
counted hierarchical path, error against the plain version, its time as
phases 6 and 10 time it, its device time, the plain version's, the bound
computed from this run's inputs and, where one PyTorch call computes the
same function, that call's time; `launches_learning`, `launches_mesh`,
`launches_gates`, `launches_experiments`, `launches_measure`,
`launches_bench` and `launches_blind_spots` count phases 13-18 and 20), then the
card's name and power limit; the line before the kernels' says whether
phase 21 ran (``{"multicard": ...}``).  The last line is one JSON object
with the device.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = dict(
    counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,), num_select=8
)
# the flagship hierarchy of bench.py:257-262 (hier_init resolves to 'int8')
HIER = dict(
    counts=(64, 32), scales=(32, 96), block_size=16384, num_coefs=(512, 192), num_select=8
)
N_BLOCKS = 128
BATCH = 64
# one H100 SXM at its 700 W limit (NVIDIA's data sheet): device memory rate
# and the float32 rate outside the tensor cores, which the kernels' integer
# and float scalar work runs at
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn` over `reps` back-to-back calls between CUDA
    events.  Where a call's host work outlasts its kernels (the decode
    wrappers), this is the host's time per call, not the device's."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device milliseconds of one call of `fn`: `launches` calls captured in
    one CUDA graph, replayed `replays` times between CUDA events, so that no
    host work of the wrapper lies between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def device_profile(fn, trace_path: str, devices=None) -> dict:
    """Run `fn` under torch.profiler and read the device timeline back from
    its chrome trace: host wall ms, device-busy ms (union of kernel, memcpy
    and memset intervals), device ms and launches per kernel name, and device ms per
    `torch.profiler.record_function` range (the kernels, copies and fills
    launched inside it, matched by their correlation ids); per card index,
    its busy ms (``busy_ms_by_device``) and the full names of the kernels it
    ran (``kernels_by_device``).  With `devices` (several cards) each is
    synchronized before and after `fn`, else the current one after it.  A
    trace that holds no device activity at all is taken again, up to twice:
    on the H100 a later profile in a process has come back without its
    device events."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    def sync():
        for d in devices or [None]:
            torch.cuda.synchronize(d)

    device_cats = ("kernel", "gpu_memcpy", "gpu_memset")
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if devices:
                sync()
            t0 = time.perf_counter()
            fn()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            events = json.load(f).get("traceEvents", [])
        if any(e.get("cat") in device_cats for e in events):
            break
        log(f"(the profile {os.path.basename(trace_path)} holds no device activity: taken again)")
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e:
            ranges.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    launched = {}  # correlation id -> the range its launch lay in
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            ts = float(e["ts"])
            for name, spans_ in ranges.items():
                if any(lo <= ts <= hi for lo, hi in spans_):
                    launched[e["args"]["correlation"]] = name
    spans, by_name, n_by_name, by_range = [], {}, {}, {name: 0.0 for name in ranges}
    spans_by_device, kernels_by_device = {}, {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            card = int(e.get("args", {}).get("device", e.get("pid", -1)))
            spans_by_device.setdefault(card, []).append(spans[-1])
            if e["cat"] == "kernel":
                kernels_by_device.setdefault(card, set()).add(e["name"])
            key = e["name"].replace("(anonymous namespace)::", "").split("(")[0][-40:]
            by_name[key] = by_name.get(key, 0.0) + float(e["dur"]) / 1e3
            n_by_name[key] = n_by_name.get(key, 0) + 1
            name = launched.get(e.get("args", {}).get("correlation"))
            if name is not None:
                by_range[name] += float(e["dur"]) / 1e3
    return {"wall_ms": wall_ms, "busy_ms": union_ms(spans), "by_name": by_name, "n_by_name": n_by_name,
            "by_range": by_range, "busy_ms_by_device": {c: union_ms(v) for c, v in sorted(spans_by_device.items())},
            "kernels_by_device": {c: sorted(v) for c, v in sorted(kernels_by_device.items())}}


def union_ms(spans) -> float:
    """The length in ms of the union of (start, end) intervals in us."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def kernel_ms(prof: dict, *names: str) -> float:
    """Device ms per launch of the kernels `names` (substrings of the
    profile's kernel names; the first name's launches are counted)."""
    total = sum(v for k, v in prof["by_name"].items() if any(n in k for n in names))
    launches = sum(v for k, v in prof["n_by_name"].items() if names[0] in k)
    check(launches > 0, f"the profile holds no launch of {names[0]}")
    return total / launches


def fresh_ms(make, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn(make())`` over `reps` calls, each
    timed alone with CUDA events, so that making its input (a copy of the
    scores the loop kernel updates in place) stays out of the time."""
    import torch

    total = 0.0
    for _ in range(reps):
        x = make()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def card_bound(nbytes: float, nops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the scalar rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / SCALAR_OPS_PER_S * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def loop_bound(s0, params, enc) -> dict:
    """Greedy loop: the scores, steps, Gram and weights read once and the
    events written once; per accepted event K x (2W-1) updates of five
    operations each (multiply, subtract, abs, weight, max)."""
    b, k, _ = s0.shape
    lag = int(params.gram_t.shape[2])
    nbytes = 4 * (s0.numel() + 3 * b + params.gram_t.numel() + k + 3 * enc.positions.numel() + 2 * b)
    return card_bound(nbytes, int(enc.count.sum()) * k * lag * 5)


def turns(kernel_fn, plain_fn, rounds: int):
    """Alternate plain and kernel (P K K P ...) and collect both results."""
    k, p = [], []
    for r in range(rounds):
        for fn in ((plain_fn, kernel_fn) if r % 2 == 0 else (kernel_fn, plain_fn)):
            (p if fn is plain_fn else k).append(fn())
    return k, p


def wall_s(fn) -> float:
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def stats(v, unit: str, fmt: str = ".4f") -> str:
    return f"{statistics.median(v):{fmt}} {unit} [{min(v):{fmt}}..{max(v):{fmt}}, n={len(v)}]"


def profile_line(what: str, fn) -> tuple[str, dict]:
    """A profile of `fn` in one log line, and the profile."""
    prof = device_profile(fn, f"build/chip_smoke/trace_{what.replace(' ', '_')}.json")
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:6]
    ranges = "".join(f"; device ms in {k}: {v:.3f}" for k, v in sorted(prof["by_range"].items()))
    return (f"profiled {what}: wall {prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms "
            f"(idle {100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f}%); device ms by name: "
            + ", ".join(f"{k} {v:.3f}" for k, v in top) + ranges), prof


def bits_equal(a, b) -> bool:
    """Float32 tensors equal bit for bit (+0.0 and -0.0 differ)."""
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@contextlib.contextmanager
def counting_calls(module, names):
    """Count the calls of `module`'s functions `names` made through any
    module of the port that holds them, while the context is open."""
    counts = dict.fromkeys(names, 0)
    originals = {n: getattr(module, n) for n in names}

    def counted(n):
        def fn(*args, **kwargs):
            counts[n] += 1
            return originals[n](*args, **kwargs)
        return fn

    patched = [(mod, n) for mod in list(sys.modules.values())
               if getattr(mod, "__name__", "").split(".")[0] == "hsc_torch"
               for n in names if getattr(mod, n, None) is originals[n]]
    for mod, n in patched:
        setattr(mod, n, counted(n))
    try:
        yield counts
    finally:
        for mod, n in patched:
            setattr(mod, n, originals[n])


def exact_correlation(x: np.ndarray, bank: np.ndarray) -> np.ndarray:
    """Valid correlation ``[K, npos]`` of ``x [N, C]`` against ``bank [K, W,
    C]`` in float64, summed tap by tap from elementwise products: no BLAS,
    and within ~1e-15 of the real-number value at the codec's magnitudes."""
    k, w, c = bank.shape
    npos = x.shape[0] - w + 1
    out = np.zeros((k, npos))
    for u in range(w):
        for ch in range(c):
            out += np.multiply.outer(bank[:, u, ch].astype(np.float64), x[u : u + npos, ch].astype(np.float64))
    return out


def fields_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def max_abs_diff(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0 for x, y in zip(a, b))


def unit_bank(rng, k: int, w: int) -> np.ndarray:
    bank = rng.standard_normal((k, w, 1)).astype(np.float32)
    return bank / np.linalg.norm(bank, axis=(1, 2), keepdims=True)


def loop_case(dev, bank, n_raw, sw, s0, e0, *, amp_bits=16, oracle_blocks=None, **kw):
    """The loop kernel (on a copy of `s0`) bitwise the plain loop, and the
    blocks `oracle_blocks` (default: all) bitwise the oracle with `s0`
    injected.  Returns the kernel's result on the host and its max |diff|
    to the plain loop."""
    import torch

    from hsc_torch.dictionary import bank_gram
    from hsc_torch.ops import mp_kernels
    from hsc_torch.ops.encode import mp_encode_from_init_torch, quantizer_steps
    from hsc_torch.oracle.mp import mp_encode
    from hsc_torch.params import level_params_from_numpy

    gram = bank_gram(bank)
    params = level_params_from_numpy(bank, np.ascontiguousarray(gram.transpose(1, 0, 2)), n_raw=n_raw,
                                     singleton_weight=sw, device=dev)
    s0 = torch.as_tensor(s0, dtype=torch.float32).to(dev)
    e0 = torch.as_tensor(e0, dtype=torch.float32).to(dev)
    scale, inv = quantizer_steps(s0.abs().amax(dim=(1, 2)).cpu().numpy(), amp_bits)
    init = (s0, e0, torch.from_numpy(scale).to(dev), torch.from_numpy(inv).to(dev))
    kw = dict(kw, amp_bits=amp_bits)
    got = mp_kernels.mp_loop(s0.clone(), *init[1:], params, **kw)
    ref = mp_encode_from_init_torch(*init, params, **kw)
    torch.cuda.synchronize()
    what = f"K={bank.shape[0]} W={bank.shape[1]} npos={s0.shape[2]} {kw}"
    check(fields_equal(got, ref), f"mp_encode kernel != plain at {what}")
    host = [a.cpu().numpy() for a in got]
    for b in range(s0.shape[0]) if oracle_blocks is None else oracle_blocks:
        o = mp_encode(np.zeros((s0.shape[2] + bank.shape[1] - 1, 1), np.float32), bank, gram,
                      scores0=s0[b].cpu().numpy(), energy0=float(e0[b]), singleton_weight=sw, n_raw=n_raw, **kw)
        n = int(host[3][b])
        check(n == o.positions.shape[0], f"oracle count {o.positions.shape[0]} != kernel {n} at {what}, block {b}")
        for a, want in zip(host[:3], (o.positions, o.atoms, o.codes)):
            check(np.array_equal(a[b, :n], want), f"oracle events differ at {what}, block {b}")
        check(host[6][b] == np.float32(o.energy_res), f"oracle energy_res differs at {what}, block {b}")
    return host, max_abs_diff(got, ref)


def edge_decode_batch(dev, phase: int, what: str, kernel, plain, oracle, table: np.ndarray) -> float:
    """One batch at the tiled decode kernels' edges (phases 4 and 8): blocks
    of N = 70001 samples (past 65536; N % 4 != 0, so rows 1-3 start
    unaligned), atoms of width 2500 (wider than a tile) and 3001 events a
    block (M % 4 != 0; several staging chunks and a ragged one).  Block 0
    has count 0; block 1 all M events on 8 positions of one tile (stream
    order decides the ordered decode's bits); block 2 all M at uniform
    positions; block 3 a ragged count with dead events (p < 0, p > N - W,
    atoms out of range) before it.  The kernel bitwise
    the plain version on all four blocks and `oracle(stream, n)` on blocks
    0-2 (the stream's scale is the block's scalar).  Returns the kernel's
    max |diff| to the plain version."""
    import torch

    from hsc_torch.ops.decode_kernel import TILE
    from hsc_torch.oracle.mp import LevelStream

    rng = np.random.default_rng(17)
    k, w = table.shape[:2]
    n, m = 70001, 3001
    pos = rng.integers(0, n - w + 1, (4, m)).astype(np.int32)
    pos[1] = rng.choice(rng.integers(20 * TILE, 21 * TILE, 8), m)
    atm = rng.integers(0, k, (4, m)).astype(np.int32)
    cds = rng.integers(-32767, 32768, (4, m)).astype(np.int32)
    pos[3, 5], pos[3, 6], atm[3, 7], atm[3, 8] = -1, n - w + 1, k, -1
    cnt = np.array([0, m, m, 2000], np.int32)
    scalar = rng.uniform(1e-7, 1e-3, 4).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (pos, atm, cds, cnt, scalar, table)]
    got, ref = kernel(*args, n=n), plain(*args, n=n)
    torch.cuda.synchronize()
    check(bits_equal(got, ref), f"{what} kernel != plain on the edge batch")
    check(not got[0].any() and bool(got[1].any()), f"{what} edge batch: block 0 not empty or block 1 empty")
    for b in range(3):
        st = LevelStream(pos[b, :cnt[b]], atm[b, :cnt[b]], cds[b, :cnt[b]], scalar[b], 0.0, 0.0)
        check(got[b].cpu().numpy().tobytes() == oracle(st, n).tobytes(), f"{what} edge batch != oracle at block {b}")
    log(f"[{phase}] {what}: kernel == plain on an edge batch (N={n}, W={w}, "
        f"M={m}; an empty block, {m} events in one tile, dead events), == oracle on its blocks 0-2")
    return max_abs_diff([got], [ref])


def adversarial_events(rng, m_ev: int, n_map: int, c_map: int, w: int):
    """Four blocks of `m_ev` int8-init events on a map of n_map x c_map
    cells: a cell of 64 events, cells at the four-digit bound from large
    codes (blocks 0 and 1; nothing else adds to them), events at N - W <
    pos < N and off the map, counts of m_ev, m_ev / 2, 7 and 0 (an all-zero
    block).  Returns host (pos, atm, cds, cnt) and the bound codes."""
    pos = rng.integers(0, n_map, (4, m_ev)).astype(np.int32)
    atm = rng.integers(0, c_map, (4, m_ev)).astype(np.int32)
    cds = rng.integers(-32767, 32768, (4, m_ev)).astype(np.int32)
    pos[:, 1:64], atm[:, 1:64] = pos[:, :1], atm[:, :1]
    bound = 2139062143
    big = (bound, -bound, bound - 255, -bound + 1, bound)
    for blk in (0, 1):
        cds[blk, 64:69] = big
        for j in range(64, 69):  # nothing else adds to these cells
            clash = (pos[blk] == pos[blk, j]) & (atm[blk] == atm[blk, j])
            clash[64:69] = False
            cds[blk, clash] = 0
    pos[:, 69:80] = n_map - 1 - rng.integers(0, w - 1, (4, 11))
    pos[:, 80], pos[:, 81], atm[:, 82], atm[:, 83] = -1, n_map, c_map, -1
    cnt = np.array([m_ev, m_ev // 2, 7, 0], np.int32)
    return (pos, atm, cds, cnt), big


def sweep_edge_cases(dev) -> float:
    """Phase 3's edge cases of the one-pass sweep (see the module
    docstring); returns the largest kernel-vs-plain |diff| (0 when bitwise)."""
    import torch

    from hsc_torch.ops.encode import encode_init_batched

    rng = np.random.default_rng(21)
    err = 0.0
    # synthetic scores: noise and a few peaks on atom 1, one per segment of
    # 128 positions (npos 984 at S=8)
    k, w, npos = 6, 16, 8 * 128 - 40
    bank = unit_bank(rng, k, w)

    def peaked(peaks, noise=0.01):
        s0 = (rng.standard_normal((1, k, npos)) * noise).astype(np.float32)
        for t, v in peaks.items():
            s0[0, 1, t] = v
        return s0

    # segment 0's peak (125) and segment 1's (128) lie 3 apart, < 2W-1 = 31
    host, e = loop_case(dev, bank, k, 1.0, peaked({125: 2.0, 128: 1.9, 300: 1.5, 700: 1.4}), [50.0],
                        num_coefs=40, num_select=8)
    check(list(host[0][0, :2]) == [125, 300], f"the guard did not reject position 128: {host[0][0, :4]}")
    err = max(err, e)
    host, e = loop_case(dev, bank, k, 1.0, peaked({64 + 128 * j: 1.0 + 0.1 * j for j in range(8)}), [50.0],
                        num_coefs=5, num_select=8)
    check(host[3][0] == 5, "the budget did not stop the sweep at 5 events")
    err = max(err, e)
    # e_res falls by ~2.25 per accept from 20, past 20 * 0.6 at the 4th
    host, e = loop_case(dev, bank, k, 1.0, peaked({64 + 128 * j: 1.5 for j in range(8)}, noise=1e-4), [20.0],
                        num_coefs=40, num_select=8, tolerance_snr=float(-10 * np.log10(0.6)))
    check(host[3][0] == 4, f"the SNR stop did not end the sweep at 4 events ({host[3][0]})")
    err = max(err, e)
    log("[3] sweep: the 2W-1 guard, the budget and the SNR stop mid-sweep: kernel == plain == oracle")

    def real_init(k, w, n, b):
        bank = unit_bank(rng, k, w)
        xs = rng.standard_normal((b, n)).astype(np.float32)
        s0, e0, _ = encode_init_batched(torch.from_numpy(xs[:, :, None]).to(dev), torch.from_numpy(bank).to(dev))
        return bank, s0, e0

    bank, s0, e0 = real_init(80, 16, 3001, 3)
    for ns in (1, 3, 8, 16, 32, 48):
        host, e = loop_case(dev, bank, 48, 0.5, s0, e0, num_coefs=300, num_select=ns)
        check((host[3] > 0).all(), f"no events at num_select={ns}")
        err = max(err, e)
    log(f"[3] sweep: num_select 1, 3, 8, 16, 32, 48 at K=80, W=16, npos={s0.shape[2]}: kernel == plain == oracle")
    bank, s0, e0 = real_init(96, 65, 16353, 4)
    host, e = loop_case(dev, bank, 32, 0.9, s0, e0, num_coefs=192, num_select=8, oracle_blocks=(0, 3))
    err = max(err, e)
    log(f"[3] sweep: level-1 geometry K=96, W=65, npos={s0.shape[2]}, 192 coefs: kernel == plain, == oracle "
        f"on 2 blocks; mean events {float(host[3].mean()):.1f}")
    for seed in range(12):
        r = np.random.default_rng(1000 + seed)
        k, w = int(r.integers(1, 97)), int(r.integers(1, 65))
        n, m = int(r.integers(w, 12000)), int(r.integers(0, 400))
        ns, amp_bits = int(r.integers(1, 41)), int(r.integers(4, 17))
        tol = None if r.random() < 0.5 else float(r.uniform(3.0, 20.0))
        n_raw, sw = int(r.integers(1, k + 1)), float(r.choice([1.0, 0.5, 2.0]))
        bank = unit_bank(r, k, w)
        xs = r.standard_normal((4, n)).astype(np.float32)
        xs[2] = 0.0
        s0, e0, _ = encode_init_batched(torch.from_numpy(xs[:, :, None]).to(dev), torch.from_numpy(bank).to(dev))
        _, e = loop_case(dev, bank, n_raw, sw, s0, e0, amp_bits=amp_bits, oracle_blocks=(0,), num_coefs=m,
                         num_select=ns, tolerance_snr=tol)
        err = max(err, e)
    log("[3] sweep: 12 random geometries (K 1-96, W 1-64, num_select 1-40): kernel == plain, == oracle on a block")
    return err


def hierarchy(dev, card: str):
    """Phases 7-10: the int8-init and ordered-decode kernels and the
    hierarchy end to end at the flagship hierarchy.  Returns their JSON
    entries and the phase-9 launch counts of all four kernels."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from hsc_torch import MultilevelDictionary, SignalGenerator, _build, make_test_config
    from hsc_torch.ops import decode_kernel, init_kernels, mp_kernels
    from hsc_torch.ops import encode as encode_ops
    from hsc_torch.ops.decode import mp_decode_batch_torch
    from hsc_torch.ops.encode import (
        feature_map_int,
        int8_init_from_events_torch,
        mp_encode_from_init_torch,
        quantizer_steps,
    )
    from hsc_torch.io import unpack_corpus
    from hsc_torch.oracle import hierarchical_decode
    from hsc_torch.oracle.mp import (
        LevelStream,
        bank_quantize_int16,
        feature_map_int_from_events,
        int8_init_scores,
        mp_decode,
        mp_decode_integer,
        mp_encode,
        rep_quantize,
    )
    from hsc_torch.runtime import CorpusEncoder
    from hsc_torch.utils import snr_db

    cfg = make_test_config(**HIER)
    check(cfg.hier_init == "int8" and cfg.decode_mode == "integer", "flagship hierarchy resolved otherwise")
    mld = MultilevelDictionary.generate(cfg, seed=9)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(N_BLOCKS, cfg.block_size, seed=5)
    codec = CorpusEncoder(mld, device=dev)
    coder = codec.coder
    mp1 = coder.coders[1].mp
    n_raw = cfg.counts[1]
    log(f"[7] hierarchy: level 1 takes int32 maps [{BATCH}, {cfg.seq_len(1)}, {mld.num_atoms(0)}] "
        f"-> scores [{BATCH}, {mld.num_atoms(1)}, {cfg.num_positions(1)}], W={cfg.window_sizes[1]}")

    # ---- 7. int8-init kernels vs plain route vs oracle ---------------------
    enc0 = coder.coders[0].mp.compute_coefficients_batch(torch.from_numpy(xs[:BATCH]).to(dev))
    *ev0, ps, n_map = coder.handoff(0, enc0)
    c_map, w1 = mld.num_atoms(0), cfg.window_sizes[1]
    init_args = (*ev0, ps, mp1.bank_planes, mp1.bank_step)

    def init_kernel(args):
        return init_kernels.int8_init(*args, n_map=n_map, planes_cnw=mp1.init_planes)

    def init_plain(args):
        return int8_init_from_events_torch(*args, n_map=n_map)

    def init_case(args, what):
        got, ref = init_kernel(args), init_plain(args)
        check(bits_equal(got[0], ref[0]) and bits_equal(got[2], ref[2]),
              f"int8 init kernels != plain route (scores or peak) on {what}")
        rel = float(((got[1].double() - ref[1].double()).abs() / ref[1].double().abs().clamp_min(1e-300)).max())
        check(rel <= 1e-6, f"int8 init e0 off the plain route by {rel:.3g} relative on {what}")
        # max_abs_err covers what is held bitwise; e0's error is relative
        return got, max_abs_diff([got[0], got[2]], [ref[0], ref[2]]), rel

    (s0_1, e0_1, peak_1), init_err, e0_rel = init_case(init_args, f"{BATCH} real level-1 batches")
    m_int = feature_map_int(*ev0, npos=n_map, k=c_map)  # the oracle's input, off the kernels' path
    nnz = int((m_int != 0).sum())
    bq, step = bank_quantize_int16(mld.augmented(1)[:n_raw])
    check(np.float32(step) == mp1.bank_step, "bank step differs from the oracle's")
    oracle_s0 = {}
    for b in (0, 37):
        t0 = time.perf_counter()
        oracle_s0[b] = int8_init_scores(m_int[b].cpu().numpy(), bq, step, ps[b].cpu().numpy())
        check(s0_1[b].cpu().numpy().tobytes() == oracle_s0[b].tobytes(), f"int8 init != oracle at block {b}")
        log(f"[7] int8 init == oracle.int8_init_scores at block {b} ({time.perf_counter() - t0:.1f} s of NumPy)")
    # adversarial batches of 4096 events per block and, past the 8192 that
    # the cell kernel once sorted, of 8193 to 65281 (the most CodecConfig
    # admits for hier_init='int8' at amp_bits=16): up to 16384 the sort runs
    # in shared memory, past it in a global workspace
    rng = np.random.default_rng(11)
    lib = _build.load()
    routes = {}
    for m_ev in (4096, 8193, 16384, 20000, 65281):
        ev_np, big = adversarial_events(rng, m_ev, n_map, c_map, w1)
        adv = [torch.from_numpy(a).to(dev) for a in ev_np]
        adv_map = feature_map_int(*adv, npos=n_map, k=c_map)
        check(set(big) <= set(adv_map[:2].unique().tolist()), f"the adversarial map misses a bound cell (M={m_ev})")
        adv_args = (*adv, ps[:4].contiguous(), mp1.bank_planes, mp1.bank_step)
        (ak, _, apk), err, rel = init_case(adv_args, f"the adversarial batch of {m_ev} events")
        check(float(apk[3]) == 0.0 and not bool(ak[3].any()), "all-zero block has nonzero scores")
        init_err, e0_rel = max(init_err, err), max(e0_rel, rel)
        ws = lib.hsc_int8_init_workspace(m_ev)
        check(ws >= 0, f"hsc_int8_init_workspace({m_ev}) failed: {ws}")
        routes[m_ev] = "global" if ws else "shared"
        if m_ev == 20000:  # the global route's time (events, planes in; scores, e0, peak out)
            many_ms = cuda_ms(lambda: init_kernel(adv_args), 10)
            many_bound = card_bound(4 * (3 * 4 * m_ev + 2 * 4) + mp1.bank_planes.numel() + 4 * (ak.numel() + 2 * 4),
                                    int((adv_map != 0).sum()) * n_raw * w1 * 16)
            many_dev = graph_ms(lambda: init_kernel(adv_args))
            many_plain = statistics.median([cuda_ms(lambda: init_plain(adv_args), 1) for _ in range(2)])
            # the one PyTorch call for its raw rows: a float64 conv1d of the
            # map against the int16 bank codes (exact below 2^53)
            m64 = adv_map.double().transpose(1, 2).contiguous()
            bq64 = (mp1.bank_planes[..., 0].double() + 256.0 * mp1.bank_planes[..., 1].double()).permute(0, 2, 1)
            bq64 = bq64.contiguous()
            many_lib = statistics.median([cuda_ms(lambda: F.conv1d(m64, bq64), 1) for _ in range(2)])
            del m64, bq64
    check(routes[16384] == "shared" and routes[20000] == "global", f"int8 init routes {routes}")
    log(f"[7] int8 init: kernels == plain route bitwise (scores {tuple(s0_1.shape)}, peak; "
        f"e0 within {e0_rel:.3g} relative) on {BATCH} real level-1 batches ({nnz} nonzero cells, "
        f"{nnz / BATCH:.0f} per block) and on adversarial batches of M events per block, sorted in "
        f"{', '.join(f'{m}: {r}' for m, r in routes.items())} memory; == oracle on 2 blocks")
    log(f"[7] int8 init, 4 blocks of 20000 events (global-memory sort), card {card}: {many_ms:.4f} ms per call "
        f"(CUDA events, 10 calls), device {many_dev:.4f} ms (CUDA graph of 20 launches); bound {many_bound['bound_ms']:.5f} ms by "
        f"{many_bound['bound_by']}; plain route, one call: {many_plain:.3f} ms; float64 conv1d of that map against the "
        f"bank codes, one call: {many_lib:.3f} ms")

    # ---- 8. ordered-decode kernel vs plain version vs oracle --------------
    sc1, iv1 = quantizer_steps(peak_1.cpu().numpy(), cfg.amp_bits)
    enc1 = mp1.loop_stage(s0_1.clone(), e0_1, sc1, iv1)
    bank1 = coder._rep_banks[1]
    dec_args = (enc1.positions, enc1.atoms, enc1.codes, enc1.count, enc1.scale, bank1)
    got = decode_kernel.mp_decode_batch(*dec_args, n=cfg.block_size)
    ref = mp_decode_batch_torch(*dec_args, n=cfg.block_size)
    check(torch.equal(got, ref), "ordered_decode kernel != plain")
    od_err = max_abs_diff([got], [ref])
    host = [a.cpu().numpy() for a in enc1]
    top_streams = []
    for b in range(BATCH):
        n = int(host[3][b])
        st = LevelStream(host[0][b, :n], host[1][b, :n], host[2][b, :n], np.float32(host[4][b]),
                         float(host[5][b]), float(host[6][b]))
        top_streams.append(st)
        check(got[b, :, 0].cpu().numpy().tobytes() == hierarchical_decode(st, mld).tobytes(),
              f"ordered_decode != oracle at block {b}")
    log(f"[8] ordered_decode: kernel == plain == oracle.hierarchical_decode bitwise on {BATCH} top streams "
        f"(mean {float(enc1.count.float().mean()):.1f} events, bank {tuple(bank1.shape)})")
    edge_bank = np.random.default_rng(6).standard_normal((5, 2500, 1)).astype(np.float32)
    od_err = max(od_err, edge_decode_batch(dev, 8, "ordered_decode", decode_kernel.mp_decode_batch,
                                           mp_decode_batch_torch, lambda st, n: mp_decode(st, edge_bank, n),
                                           edge_bank))
    # the level-space decode of the level-1 streams: the augmented bank
    # [K, W, C] with C = the 64 level-0 atoms, rows [n, C] of the level-1 map
    n_ls = cfg.seq_len(1)
    ls_args = (*dec_args[:5], mp1.bank)

    def level_space_decode():
        return decode_kernel.mp_decode_batch(*ls_args, n=n_ls)

    got_ls = level_space_decode()
    ref_ls = mp_decode_batch_torch(*ls_args, n=n_ls)
    torch.cuda.synchronize()
    check(bits_equal(got_ls, ref_ls), "ordered_decode kernel != plain at C > 1 (level space)")
    aug1 = mld.augmented(1)
    for b in (0, 37):
        check(got_ls[b].cpu().numpy().tobytes() == mp_decode(top_streams[b], aug1, n_ls).tobytes(),
              f"level-space ordered_decode != oracle.mp.mp_decode at block {b}")
    check(coder.coders[1].reconstruct(top_streams[0]).tobytes() == got_ls[0].cpu().numpy().tobytes(),
          "ConvolutionalSparseCoder.reconstruct != the batched level-space decode")
    od_err = max(od_err, max_abs_diff([got_ls], [ref_ls]))
    ls_dev = statistics.median([graph_ms(level_space_decode) for _ in range(3)])
    ls_k, ls_p = turns(lambda: cuda_ms(level_space_decode, 20),
                       lambda: cuda_ms(lambda: mp_decode_batch_torch(*ls_args, n=n_ls), 1), 2)
    ev_ls = int(enc1.count.sum())
    k1, w_ls, c_ls = (int(v) for v in mp1.bank.shape)
    ls_bound = card_bound(12 * ev_ls + 8 * BATCH + 4 * (mp1.bank.numel() + got_ls.numel()), 3 * ev_ls * w_ls * c_ls)
    del got_ls, ref_ls
    log(f"[8] ordered_decode at C = {c_ls} (level space of level 1, bank [{k1}, {w_ls}, {c_ls}], rows "
        f"[{BATCH}, {n_ls}, {c_ls}]): kernel == plain bitwise on {BATCH} blocks, == oracle.mp.mp_decode on 2, "
        f"== the coder's single-block reconstruct; card {card}: device time {ls_dev:.4f} ms (CUDA graph of "
        f"20 launches, median of 3), host time per call {stats(ls_k, 'ms')} (20 back-to-back calls), plain "
        f"{stats(ls_p, 'ms')}; bound {ls_bound['bound_ms']:.5f} ms by {ls_bound['bound_by']}")

    # ---- 9. the hierarchy end to end, counted ------------------------------
    mld_o = MultilevelDictionary.generate(dataclasses.replace(cfg, decode_mode="ordered"), seed=9)
    codec_o = CorpusEncoder(mld_o, device=dev)
    codec_d = CorpusEncoder(mld, device=dev, distributed=True)
    codec_od = CorpusEncoder(mld_o, device=dev, distributed=True)
    # the dense route of the int8 init: the hand-off map and the torch epilogue
    dense_fns = ("feature_map_int", "int8_assemble_batched")
    with counting_calls(encode_ops, dense_fns) as dense, counted() as launches:
        blob = codec.encode(xs)
        blob2 = codec.encode(xs)
        rows = codec.decode(blob)
        blob_o = codec_o.encode(xs)
        rows_o = codec_o.decode(blob_o)
        blob_d = codec_d.encode(xs)
        rows_d = codec_d.decode(blob_d)
        blob_od = codec_od.encode(xs)
        rows_od = codec_od.decode(blob_od)
    log(f"[9] launches on the hierarchical path: {launches}; calls of the dense int8-init route: {dense}")
    check(all(v > 0 for v in launches.values()), "a kernel of the hierarchical path was never launched")
    check(not any(dense.values()), "the CUDA int8 path built a dense map or ran the torch epilogue")
    check(blob == blob2, "two encodes of one corpus gave different bytes")
    for r in (rows, rows_o, rows_d, rows_od):
        check(r.shape == (N_BLOCKS, cfg.block_size) and np.isfinite(r).all(), "bad decode output")
    hdr, blocks = unpack_corpus(blob)
    hdr_o, blocks_o = unpack_corpus(blob_o)
    check(hdr.decode_mode == "integer" and hdr_o.decode_mode == "ordered", "container headers' modes")
    rep_q, rstep = rep_quantize(mld.representations(1)[:, :, None], hdr.rep_bits)
    steps = [float(rep_quantize(mld.representations(lv)[:, :, None], hdr.rep_bits)[1])
             for lv in range(cfg.num_levels)]
    for b in range(N_BLOCKS):
        (lv, st), = blocks[b]
        (lv_o, st_o), = blocks_o[b]
        check(lv == lv_o == 1 and st.codes.tobytes() == st_o.codes.tobytes()
              and st.positions.tobytes() == st_o.positions.tobytes(), f"modes encoded block {b} differently")
        check(rows[b].tobytes() == mp_decode_integer(st, rep_q, rstep, cfg.block_size)[:, 0].tobytes(),
              f"integer decode != oracle at block {b}")
        check(rows_o[b].tobytes() == hierarchical_decode(st_o, mld_o).tobytes(),
              f"ordered decode != oracle at block {b}")
        if b < BATCH:
            check(st.codes.tobytes() == top_streams[b].codes.tobytes(), f"container top stream {b} != phase 8's")
    # level 1 against the oracle's greedy loop on the oracle's int8 init
    for b in oracle_s0:
        n0 = int(enc0.count[b])
        st0 = LevelStream(*(a[b, :n0].cpu().numpy() for a in enc0[:3]), np.float32(enc0.scale[b].item()),
                          0.0, 0.0)
        m_b = feature_map_int_from_events(st0, cfg.num_positions(0), mld.num_atoms(0))
        check(np.array_equal(m_b, m_int[b].cpu().numpy()), f"hand-off map != oracle at block {b}")
        x1 = (m_b.astype(np.float32) * np.float32(st0.scale)).astype(np.float32)
        o = mp_encode(x1, mld.augmented(1), mld.gram(1), num_coefs=cfg.num_coefs[1], amp_bits=cfg.amp_bits,
                      tolerance_snr=cfg.tolerance_snr, singleton_weight=cfg.singleton_weight, n_raw=n_raw,
                      scores0=oracle_s0[b], energy0=float(e0_1[b]), num_select=cfg.num_select)
        (_, st), = blocks[b]
        for name in ("positions", "atoms", "codes"):
            check(np.array_equal(getattr(st, name), getattr(o, name)), f"level-1 {name} != oracle at block {b}")
        check(np.float32(st.scale) == np.float32(o.scale), f"level-1 scale != oracle at block {b}")
    log("[9] level 1 == oracle mp_encode on oracle.int8_init_scores (2 blocks, port's level-0 streams)")
    for name, blob_x, rows_x, rows_top, m in (("integer", blob_d, rows_d, rows, mld), ("ordered", blob_od, rows_od, rows_o, mld_o)):
        _, blocks_x = unpack_corpus(blob_x)
        check(any(len(s) > 1 for s in blocks_x), "distributed container has no demoted events")
        for b, streams in enumerate(blocks_x):
            want = np.zeros(cfg.block_size, np.float32)
            for lv, st in streams:
                if name == "integer":
                    rq, rs = rep_quantize(m.representations(lv)[:, :, None], hdr.rep_bits)
                    want += mp_decode_integer(st, rq, rs, cfg.block_size)[:, 0]
                else:
                    want += hierarchical_decode(st, m, level=lv)
            check(rows_x[b].tobytes() == want.tobytes(), f"distributed {name} decode != oracle sum at block {b}")
        # The same events, summed per level: in ordered mode the rows differ
        # from the top-only rows only by float association.  In integer mode
        # a demoted event also decodes through its own level's quantized
        # representations, so it may move a sample by up to half of each
        # level's rep step times |c_hat|.
        slack = 1e-5 * float(np.abs(rows_top).max())
        worst = 0.0
        for b, streams in enumerate(blocks_x):
            bound = slack
            if name == "integer":
                for lv, st in streams:
                    if lv < cfg.num_levels - 1:
                        c_hat = np.abs(st.codes.astype(np.float64) * float(st.scale)).sum()
                        bound += c_hat * (steps[lv] + steps[cfg.num_levels - 1]) / 2
            d = float(np.abs(rows_x[b] - rows_top[b]).max())
            check(d <= bound, f"distributed {name} block {b} off the top-only rows by {d} > {bound}")
            worst = max(worst, d)
        log(f"[9] distributed ({name}): {len(blob_x)} vs {len(blob)} bytes top-only; rows == per-level oracle sums "
            f"bitwise; max |diff| to top-only rows {worst:.3g} (within the per-block bound)")
    plain = CorpusEncoder(mld, device=dev, backend="torch")
    plain_o = CorpusEncoder(mld_o, device=dev, backend="torch")
    with counting_calls(encode_ops, dense_fns) as dense_plain:
        check(plain.encode(xs) == blob, "backend='torch' container != backend='cuda' container")
    check(all(dense_plain.values()), f"the dense-route counter saw {dense_plain} on backend='torch'")
    check(plain.decode(blob).tobytes() == rows.tobytes(), "backend='torch' integer rows != cuda rows")
    check(plain_o.decode(blob_o).tobytes() == rows_o.tobytes(), "backend='torch' ordered rows != cuda rows")
    check(plain.decode(blob_d).tobytes() == rows_d.tobytes(), "backend='torch' distributed rows != cuda rows")
    events = sum(int(s[0][1].positions.shape[0]) for s in blocks)
    snr = float(np.mean([snr_db(xs[b], rows[b]) for b in range(N_BLOCKS)]))
    log(f"[9] {N_BLOCKS} blocks -> {len(blob)} bytes: ratio {xs.nbytes / len(blob):.2f}x, {events} top events, "
        f"mean SNR {snr:.3f} dB (integer), {float(np.mean([snr_db(xs[b], rows_o[b]) for b in range(N_BLOCKS)])):.3f} "
        f"dB (ordered); backend='torch' containers and rows identical")

    # ---- 10. timing in turns, median [range] -------------------------------
    in_k, in_p = turns(lambda: cuda_ms(lambda: init_kernel(init_args), 10),
                       lambda: cuda_ms(lambda: init_plain(init_args), 1), 4)
    handoff_ms = cuda_ms(lambda: coder.handoff(0, enc0), 10)
    # one PyTorch call for the raw rows' integer correlation: a float64
    # conv1d of the map against the int16 bank codes (exact below 2^53)
    m64 = m_int.double().transpose(1, 2).contiguous()
    bq64 = (mp1.bank_planes[..., 0].double() + 256.0 * mp1.bank_planes[..., 1].double()).permute(0, 2, 1)
    bq64 = bq64.contiguous()
    in_lib = statistics.median([cuda_ms(lambda: F.conv1d(m64, bq64), 1) for _ in range(2)])
    del m64
    def ordered_decode():
        return decode_kernel.mp_decode_batch(*dec_args, n=cfg.block_size)

    od_k, od_p = turns(lambda: (graph_ms(ordered_decode), cuda_ms(ordered_decode, 50)),
                       lambda: cuda_ms(lambda: mp_decode_batch_torch(*dec_args, n=cfg.block_size), 5), 4)
    od_dev, od_host = [d for d, _ in od_k], [h for _, h in od_k]
    sc1_t, iv1_t = torch.from_numpy(sc1).to(dev), torch.from_numpy(iv1).to(dev)
    l1_k, l1_p = turns(
        lambda: fresh_ms(s0_1.clone, lambda s: mp_kernels.mp_loop(s, e0_1, sc1_t, iv1_t, mp1.params, **mp1.settings), 3),
        lambda: fresh_ms(lambda: s0_1, lambda s: mp_encode_from_init_torch(s, e0_1, sc1_t, iv1_t, mp1.params,
                                                                           **mp1.settings), 1),
        4)
    l1_bound = loop_bound(s0_1, mp1.params, enc1)
    mb = N_BLOCKS * cfg.block_size * 4 / 1e6
    enc_k, enc_p = turns(lambda: mb / wall_s(lambda: codec.encode(xs)), lambda: mb / wall_s(lambda: plain.encode(xs)), 2)
    di_k, di_p = turns(lambda: mb / wall_s(lambda: codec.decode(blob)), lambda: mb / wall_s(lambda: plain.decode(blob)), 4)
    do_k, do_p = turns(lambda: mb / wall_s(lambda: codec_o.decode(blob_o)),
                       lambda: mb / wall_s(lambda: plain_o.decode(blob_o)), 4)
    log(f"[10] card {card}")
    b1, m1 = ev0[0].shape
    n_raw1 = int(mp1.bank_planes.shape[0])
    # events and scales read, planes read, the score buffer, e0 and peak
    # written; per nonzero cell and raw atom, W x 4 digits x 2 planes,
    # multiply and add
    init_bound = card_bound(4 * (3 * b1 * m1 + 2 * b1) + mp1.bank_planes.numel()
                            + 4 * (s0_1.numel() + e0_1.numel() + peak_1.numel()), nnz * n_raw1 * w1 * 16)
    log(f"[10] int8 level-1 init, one {BATCH}-block batch (events in; scores {tuple(s0_1.shape)}, e0, peak out): "
        f"kernels {stats(in_k, 'ms')}, plain route (dense hand-off map, float64 dense conv, torch epilogue) "
        f"{stats(in_p, 'ms')}; bound {init_bound['bound_ms']:.4f} ms by {init_bound['bound_by']}")
    log(f"[10] (float64 conv1d of the map against the bank codes, one call: {in_lib:.3f} ms; "
        f"the level-0 -> level-1 hand-off: {handoff_ms:.4f} ms of device time per batch)")
    log(f"[10] ordered decode, one {BATCH}-block batch of top streams: kernel device time {stats(od_dev, 'ms')} "
        f"(CUDA graph of 20 launches), host time per call {stats(od_host, 'ms')} (50 back-to-back calls), "
        f"plain {stats(od_p, 'ms')}")
    log(f"[10] greedy loop at level 1, one {BATCH}-block batch (K={mld.num_atoms(1)}, W={cfg.window_sizes[1]}, "
        f"{int(enc1.count.sum())} events): kernel {stats(l1_k, 'ms')}, plain {stats(l1_p, 'ms')}; "
        f"bound {l1_bound['bound_ms']:.4f} ms by {l1_bound['bound_by']}")
    log(f"[10] hierarchical CorpusEncoder.encode, {N_BLOCKS} blocks, host wall: cuda {stats(enc_k, 'MB/s', '.2f')}, "
        f"torch {stats(enc_p, 'MB/s', '.2f')}")
    log(f"[10] hierarchical decode (integer), host wall: cuda {stats(di_k, 'MB/s', '.2f')}, "
        f"torch {stats(di_p, 'MB/s', '.2f')}")
    log(f"[10] hierarchical decode (ordered), host wall: cuda {stats(do_k, 'MB/s', '.2f')}, "
        f"torch {stats(do_p, 'MB/s', '.2f')}")
    handoff = coder.handoff

    def annotated_handoff(level, enc):
        with torch.profiler.record_function("hand-off"):
            return handoff(level, enc)

    coder.handoff = annotated_handoff  # the profile splits out the hand-offs' device time
    try:
        line, prof = profile_line("hierarchical encode", lambda: codec.encode(xs))
        log("[10] " + line)
    finally:
        del coder.handoff
    # device time of one int8 init: its score kernel and cell kernel
    init_dev_ms = kernel_ms(prof, "score_kernel", "cell_kernel")
    log("[10] " + profile_line("hierarchical ordered decode", lambda: codec_o.decode(blob_o))[0])
    ev1 = int(enc1.count.sum())
    od_bound = card_bound(12 * ev1 + 8 * BATCH + 4 * (bank1.numel() + got.numel()), 3 * ev1 * int(bank1.shape[1]))
    kernels = [
        {"name": "sparse_init", "route": "cuda", "source": "hsc_torch/csrc/sparse_init.cu",
         "replaces": "hsc_tpu/ops/init_kernels.py:76, hsc_tpu/ops/encode.py:479",
         "launches": launches["sparse_init"],
         "max_abs_err": init_err, "e0_max_rel_err": e0_rel, "ms": statistics.median(in_k),
         "device_ms": init_dev_ms, "plain_ms": statistics.median(in_p), **init_bound, "library_ms": in_lib,
         "sort_routes": routes, "ms_m20000": many_ms, "device_ms_m20000": many_dev, "plain_ms_m20000": many_plain,
         "bound_ms_m20000": many_bound["bound_ms"], "library_ms_m20000": many_lib},
        {"name": "ordered_decode", "route": "cuda", "source": "hsc_torch/csrc/ordered_decode.cu",
         "replaces": "hsc_tpu/ops/decode_kernel.py:33", "launches": launches["ordered_decode"],
         "max_abs_err": od_err, "ms": statistics.median(od_host), "device_ms": statistics.median(od_dev),
         "plain_ms": statistics.median(od_p), **od_bound, "library_ms": None,
         "ms_c64": statistics.median(ls_k), "device_ms_c64": ls_dev, "plain_ms_c64": statistics.median(ls_p),
         "bound_ms_c64": ls_bound["bound_ms"]},
    ]
    return kernels, launches


def large_block(dev) -> None:
    """Phase 11: the single-level codec at 65536-sample blocks (16 atoms of
    width 32, 512 coefficients, num_select=8, integer decode; dictionary
    seed 21, signals seed 23), whose greedy loop keeps its selection cache
    in a global workspace (it does not fit the card's shared memory), on
    its own counted run."""
    import torch

    from hsc_torch import MultilevelDictionary, SignalGenerator, _build, make_test_config
    from hsc_torch.io import unpack_corpus
    from hsc_torch.ops import decode_integer_kernel, mp_kernels
    from hsc_torch.oracle.mp import mp_decode_integer, rep_quantize
    from hsc_torch.runtime import CorpusEncoder
    from hsc_torch.utils import snr_db

    cfg = make_test_config(counts=(16,), scales=(32,), block_size=65536, num_coefs=(512,), num_select=8)
    check(cfg.decode_mode == "integer", "the 65536-sample config resolved to another decode mode")
    mld = MultilevelDictionary.generate(cfg, seed=21)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(4, cfg.block_size, seed=23)
    ws = _build.load().hsc_mp_encode_workspace(mld.num_atoms(0), cfg.num_positions(0), cfg.num_select)
    check(ws > 0, f"the selection cache of npos {cfg.num_positions(0)} fits shared memory (workspace {ws})")
    codec = CorpusEncoder(mld, device=dev)
    mp_kernels.LAUNCHES = 0
    decode_integer_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    blob = codec.encode(xs)
    rows = codec.decode(blob)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mp_encode": mp_kernels.LAUNCHES, "int_decode": decode_integer_kernel.LAUNCHES}
    check(all(v > 0 for v in launches.values()), f"a kernel of the 65536-sample path was never launched: {launches}")
    plain = CorpusEncoder(mld, device=dev, backend="torch")
    check(plain.encode(xs) == blob, "65536-sample blocks: backend='torch' container != backend='cuda' container")
    check(plain.decode(blob).tobytes() == rows.tobytes(), "65536-sample blocks: backend='torch' rows != cuda rows")
    hdr, blocks = unpack_corpus(blob)
    rep_q, step = rep_quantize(mld.representations(0)[:, :, None], hdr.rep_bits)
    for b, ((_, st),) in enumerate(blocks):
        check(st.positions.shape[0] > 0, f"65536-sample block {b} emitted no events")
        check(rows[b].tobytes() == mp_decode_integer(st, rep_q, step, cfg.block_size)[:, 0].tobytes(),
              f"65536-sample decode != oracle at block {b}")
    events = sum(int(s[0][1].positions.shape[0]) for s in blocks)
    snr = float(np.mean([snr_db(xs[b], rows[b]) for b in range(len(blocks))]))
    log(f"[11] 65536-sample blocks (selection cache in a {ws}-byte global slice per block): launches {launches}; "
        f"4 blocks -> {len(blob)} bytes, {events} events, mean SNR {snr:.3f} dB, encode + decode {wall:.2f} s; "
        f"containers and rows == backend='torch', rows == oracle integer decode")


def kernel_counters():
    from hsc_torch.ops import decode_integer_kernel, decode_kernel, init_kernels, mp_kernels

    return {"mp_encode": mp_kernels, "int_decode": decode_integer_kernel,
            "sparse_init": init_kernels, "ordered_decode": decode_kernel}


@contextlib.contextmanager
def counted():
    """Every kernel's launch count set to 0 on entry; on exit the dict it
    yields holds the launches made inside."""
    mods = kernel_counters()
    for mod in mods.values():
        mod.LAUNCHES = 0
    launches = {}
    try:
        yield launches
    finally:
        launches.update({name: mod.LAUNCHES for name, mod in mods.items()})


def deep_level0(dev) -> None:
    """Phase 12a: a 2-level hierarchy whose level 0 keeps up to 20000 events
    per block (32768-sample blocks, 16 and 8 atoms of widths 32 and 64,
    num_select=8), so the level-1 int8 init sorts each block's events in a
    global workspace: 4 blocks through CorpusEncoder(device='cuda'),
    counted, containers and rows equal to backend='torch'."""
    from hsc_torch import MultilevelDictionary, SignalGenerator, _build, make_test_config
    from hsc_torch.io import unpack_corpus
    from hsc_torch.runtime import CorpusEncoder

    cfg = make_test_config(block_size=32768, counts=(16, 8), scales=(32, 64), num_coefs=(20000, 128),
                           num_select=8)
    check(cfg.hier_init == "int8" and cfg.decode_mode == "ordered" and cfg.tolerance_snr is None,
          f"the deep level-0 config resolved to {cfg.hier_init}, {cfg.decode_mode}, {cfg.tolerance_snr}")
    check(_build.load().hsc_int8_init_workspace(cfg.num_coefs[0]) > 0, "20000 events fit the shared-memory sort")
    mld = MultilevelDictionary.generate(cfg, seed=25)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(4, cfg.block_size, seed=27)
    codec = CorpusEncoder(mld, device=dev)
    n0 = codec.coder.coders[0].mp.compute_coefficients_batch(xs).count.cpu().numpy()
    check(int(n0.max()) > 8192, f"level 0 emitted at most {int(n0.max())} events a block")
    t0 = time.perf_counter()
    with counted() as launches:
        blob = codec.encode(xs)
        rows = codec.decode(blob)
    wall = time.perf_counter() - t0
    check(all(launches[k] > 0 for k in ("mp_encode", "sparse_init", "ordered_decode")),
          f"a kernel of the deep level-0 path was never launched: {launches}")
    plain = CorpusEncoder(mld, device=dev, backend="torch")
    check(plain.encode(xs) == blob, "deep level 0: backend='torch' container != backend='cuda' container")
    check(plain.decode(blob).tobytes() == rows.tobytes(), "deep level 0: backend='torch' rows != cuda rows")
    check(rows.shape == (4, cfg.block_size) and np.isfinite(rows).all(), "deep level 0: bad decode output")
    _, blocks = unpack_corpus(blob)
    log(f"[12] hierarchy with level-0 num_coefs {cfg.num_coefs[0]} (block {cfg.block_size}): level 0 emitted "
        f"{n0.tolist()} events, "
        f"level 1 {[int(s[0][1].positions.shape[0]) for s in blocks]}; launches {launches}; 4 blocks -> "
        f"{len(blob)} bytes in {wall:.2f} s; containers and rows == backend='torch'")


def serving(dev, mld, xs, blob, rows) -> None:
    """Phase 12b: the serving, rate-control and journal surfaces on the flat
    flagship's 128 blocks (`blob` and its `rows` from phase 5), counted."""
    import os
    import shutil

    from hsc_torch.io import append_index
    from hsc_torch.runtime import CorpusEncoder, CorpusReader

    codec = CorpusEncoder(mld, device=dev)
    plain = CorpusEncoder(mld, device=dev, backend="torch")
    order = np.random.default_rng(29).permutation(len(rows))[:40].tolist()
    work = os.path.join("build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "flagship.hsct")
    with counted() as launches:
        indexed = codec.encode(xs, index=True)
        with open(path, "wb") as f:
            f.write(indexed)
        picked = codec.decode_blocks(indexed, order)
        streamed = np.stack(list(codec.decode_stream(blob, indices=order)))
        with CorpusReader(path, mld, device=dev, batch_size=32) as rd:
            read = np.stack(list(rd.rows()))
            one, tail, window = rd[order[0]], rd[-1], rd[5:40]
        cbr = {mode: CorpusEncoder(mld, device=dev, target_bps=0.8, rate_mode=mode).encode(xs)
               for mode in ("block", "corpus")}
    check(launches["mp_encode"] > 0 and launches["int_decode"] > 0,
          f"a kernel of the serving path was never launched: {launches}")
    check(indexed == append_index(blob), "encode(index=True) != append_index(encode())")
    check(picked.tobytes() == rows[order].tobytes(), "decode_blocks rows != decode rows")
    check(streamed.tobytes() == rows[order].tobytes(), "decode_stream(indices=...) rows != decode rows")
    check(read.tobytes() == rows.tobytes() and one.tobytes() == rows[order[0]].tobytes()
          and tail.tobytes() == rows[-1].tobytes() and window.tobytes() == rows[5:40].tobytes(),
          "CorpusReader rows != decode rows")
    for mode, c in cbr.items():
        check(len(c) < len(blob), f"the {mode}-rate container is not smaller than the unconstrained one")
        check(CorpusEncoder(mld, device=dev, backend="torch", target_bps=0.8, rate_mode=mode).encode(xs) == c,
              f"target_bps container (rate_mode={mode!r}) != backend='torch'")
        check(codec.decode(c).tobytes() == plain.decode(c).tobytes(), f"{mode}-rate rows != backend='torch'")
    log(f"[12] serving, {len(rows)} flat-flagship blocks: launches {launches}; encode(index=True) == append_index; "
        f"decode_blocks, decode_stream(indices) on {len(order)} shuffled blocks and CorpusReader rows == decode rows; "
        f"target_bps=0.8 containers ({', '.join(f'{m}: {len(c)} bytes' for m, c in cbr.items())}, full "
        f"{len(blob)}) and rows == backend='torch'")
    jdir = os.path.join(work, "journal")
    shutil.rmtree(jdir, ignore_errors=True)
    check(CorpusEncoder(mld, device=dev, journal_dir=jdir).encode(xs) == blob, "journaled encode != encode")
    with counted() as launches:
        resumed = CorpusEncoder(mld, device=dev, journal_dir=jdir).encode(xs)
    check(resumed == blob, "journal resume != encode")
    check(not any(launches.values()), f"the journal resume launched kernels: {launches}")
    log(f"[12] journal resume: identical bytes, launches {launches}")


# phase 13a: bench.py:291-296's k-means geometry (windows, dims, centroids,
# iterations)
KMEANS = (65536, 32, 64, 20)


def sync_count(fn):
    """``(fn(), where)``: `where` lists the file:line of every synchronizing
    CUDA call `fn` made, as torch's sync debug mode reports them (its
    warning "called a synchronizing CUDA operation"; the mode's own notice
    that it is a prototype is not one)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]


def kmeans_phase(dev, card) -> dict:
    """Phase 13a: `kmeans_refine_device` at `bench.py:291-296`'s geometry,
    against the same call on the CPU, with no host sync in its loop."""
    import torch

    from hsc_torch.learn import kmeans_refine_device

    m, d, k, iters = KMEANS
    rng = np.random.default_rng(0)
    flat = rng.standard_normal((m, d)).astype(np.float32)
    cents = rng.standard_normal((k, d)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    w_d, c_d = torch.from_numpy(flat).to(dev), torch.from_numpy(cents).to(dev)
    kmeans_refine_device(w_d, c_d, iterations=iters)  # warm
    torch.cuda.synchronize()
    (got_c, got_o), syncs = sync_count(lambda: kmeans_refine_device(w_d, c_d, iterations=iters))
    _, control = sync_count(lambda: got_o.cpu())
    check(len(control) >= 1, "the sync counter saw no sync in a device-to-host copy")
    check(not syncs, f"kmeans_refine_device synced the host {len(syncs)} times, at {syncs}")
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        kmeans_refine_device(w_d, c_d, iterations=iters)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    want_c, want_o = kmeans_refine_device(torch.from_numpy(flat), torch.from_numpy(cents), iterations=iters)
    cpu_s = time.perf_counter() - t0
    c_err = float((got_c.cpu() - want_c).abs().max())
    o_rel = float(((got_o.cpu().double() - want_o.double()) / want_o.double()).abs().max())
    check(c_err <= 1e-5, f"k-means centroids on the card off the CPU's by {c_err:.3g}")
    check(o_rel <= 1e-5, f"k-means objectives on the card off the CPU's by {o_rel:.3g} relative")
    ms = statistics.median(times)
    rate = m * iters / ms / 1e3
    log(f"[13] k-means refine, {m} windows x {d}, {k} centroids, {iters} iterations: {len(syncs)} host syncs "
        f"(torch's sync debug mode; a copy-back counts {len(control)}); centroids within {c_err:.3g} of the CPU's, objectives within "
        f"{o_rel:.3g} relative; card {card}: {stats(times, 'ms')} (CUDA events, 5 runs) = {rate:.2f} M "
        f"window-assignments/s; the CPU run took {cpu_s:.2f} s")
    # device busy against wall: are the iterations' ~25 small ops launch-bound?
    line, prof = profile_line("k-means refine", lambda: kmeans_refine_device(w_d, c_d, iterations=iters))
    log("[13] " + line)
    return {"kmeans_ms": ms, "kmeans_mwindows_s": rate, "kmeans_device_busy_ms": prof["busy_ms"]}


def trainer_phase(dev, card) -> tuple[dict, dict]:
    """Phase 13b: `MultilevelTrainer` at the flagship hierarchy, counted and
    profiled, its level-0 encode held to the plain loop, then the learned
    dictionary through CorpusEncoder."""
    import torch

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.learn import MultilevelTrainer
    from hsc_torch.learn.trainer import _partial_config
    from hsc_torch.models.coder import ConvolutionalMatchingPursuit
    from hsc_torch.ops.encode import feature_map
    from hsc_torch.runtime import CorpusEncoder
    from hsc_torch.utils import snr_db

    cfg = make_test_config(**HIER)
    xs = SignalGenerator(MultilevelDictionary.generate(cfg, seed=9), rates=2e-3).generate_signals(
        BATCH, cfg.block_size, seed=5)

    def train():
        """One training run -> (dictionary, host seconds per stage, the
        level hand-off maps)."""
        trainer = MultilevelTrainer(cfg, num_windows=4096, iterations=20, seed=0, device=dev)
        spans, maps = {}, {}

        def timed(name, fn):
            def stage(level, *args):
                t0 = time.perf_counter()
                out = fn(level, *args)
                torch.cuda.synchronize()
                spans[f"{name} {level}"] = time.perf_counter() - t0
                if name == "encode":
                    maps[level] = out
                return out
            return stage

        trainer._learn_level = timed("learn", trainer._learn_level)
        trainer._encode_level = timed("encode", trainer._encode_level)
        return trainer.train(xs), spans, maps

    with counted() as launches:
        t0 = time.perf_counter()
        learned, spans, maps = train()
        wall = time.perf_counter() - t0
    check(launches["mp_encode"] > 0, f"the trainer never launched the greedy-loop kernel: {launches}")
    runs = []
    _, prof = profile_line("multilevel trainer", lambda: runs.append(train()))
    again = runs[0][0]
    check(all(a.tobytes() == b.tobytes() for a, b in zip(learned.dicts, again.dicts)),
          "two trainer runs gave different dictionaries")
    for d in learned.dicts:
        norms = np.linalg.norm(d.reshape(d.shape[0], -1), axis=1)
        check(np.isfinite(d).all() and np.allclose(norms, 1.0, atol=1e-5), "learned atoms not unit-norm")
    t_plain = time.perf_counter()
    mld0 = MultilevelDictionary(_partial_config(cfg, 1), learned.dicts[:1])
    mp = ConvolutionalMatchingPursuit(mld0.augmented(0), mld0.gram(0), num_coefs=cfg.num_coefs[0],
                                      amp_bits=cfg.amp_bits, tolerance_snr=cfg.tolerance_snr, n_raw=cfg.counts[0],
                                      backend="torch", device=dev)
    plain = feature_map(mp.compute_coefficients_batch(xs), npos=cfg.num_positions(0), k=mld0.num_atoms(0))
    check(plain.cpu().numpy().tobytes() == maps[0].tobytes(),
          "the trainer's level-0 hand-off map != the plain loop's (backend='torch')")
    t_plain = time.perf_counter() - t_plain
    codec = CorpusEncoder(learned, device=dev)
    with counted() as codec_launches:
        blob = codec.encode(xs)
        rows = codec.decode(blob)
    check(rows.shape == xs.shape and np.isfinite(rows).all(), "learned dictionary: bad decode output")
    check(all(v > 0 for k, v in codec_launches.items() if k != "ordered_decode"),
          f"a kernel of the learned dictionary's codec was never launched: {codec_launches}")
    snr = float(np.mean([snr_db(xs[b], rows[b]) for b in range(len(xs))]))
    busy = prof["busy_ms"] / 1e3
    log(f"[13] MultilevelTrainer, flagship hierarchy ({BATCH} blocks, 4096 windows, 20 iterations): launches "
        f"{launches}; a second run bitwise the same; level-0 hand-off map ({tuple(maps[0].shape)}) == the plain "
        f"loop's ({t_plain:.1f} s); card {card}: wall {wall:.3f} s (by stage: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in spans.items())
        + f"); profiled run: wall {prof['wall_ms'] / 1e3:.3f} s, device busy {busy:.3f} s, host "
        f"{prof['wall_ms'] / 1e3 - busy:.3f} s")
    log(f"[13] learned dictionary through CorpusEncoder: {len(xs)} blocks -> {len(blob)} bytes, ratio "
        f"{xs.nbytes / len(blob):.2f}x, mean SNR {snr:.3f} dB; launches {codec_launches}")
    return launches, {"trainer_wall_s": wall, "trainer_device_s": busy, "trainer_host_s": prof["wall_ms"] / 1e3 - busy,
                      "learned_ratio": xs.nbytes / len(blob), "learned_snr_db": snr}


def online_phase(dev, card, xs) -> tuple[dict, dict]:
    """Phase 13c: the online learner at the flat flagship, counted, with
    `_OverlapAdd` held to the plain decode and to float64 autograd."""
    import torch

    from hsc_torch import make_test_config
    from hsc_torch.dictionary import bank_gram
    from hsc_torch.learn import OnlineConvolutionalDictionaryLearner
    from hsc_torch.learn.online import _OverlapAdd
    from hsc_torch.models.coder import ConvolutionalMatchingPursuit
    from hsc_torch.ops.decode import mp_decode_batch_torch

    cfg = make_test_config(**FLAGSHIP)
    k, w = cfg.counts[0], cfg.scales[0]
    bank0 = unit_bank(np.random.default_rng(0), k, w)
    xb = xs[:BATCH]

    def run():
        learner = OnlineConvolutionalDictionaryLearner(bank0, num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits,
                                                       device=dev)
        step_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            learner.step(xb)  # returns the loss as a float: the step has ended
            step_s.append(time.perf_counter() - t0)
        return learner, step_s

    with counted() as launches:
        first, step_s = run()
    second, _ = run()
    check(launches["mp_encode"] > 0 and launches["ordered_decode"] > 0,
          f"the online learner did not launch both kernels: {launches}")
    losses = first.loss_history
    check(losses[-1] < losses[0], f"the online loss did not fall: {losses}")
    check(bits_equal(first.bank.detach(), second.bank.detach()), "two online runs gave different banks")
    # the first step's events, through _OverlapAdd and the plain decode
    mp = ConvolutionalMatchingPursuit(bank0, bank_gram(bank0), num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits,
                                      device=dev)
    enc = mp.compute_coefficients_batch(xb)
    ev = (enc.positions, enc.atoms, enc.codes, enc.count, enc.scale)
    n = cfg.block_size
    bank = torch.from_numpy(bank0).to(dev).requires_grad_(True)
    x_t = torch.from_numpy(xb[:, :, None]).to(dev)
    recon = _OverlapAdd.apply(bank, *ev, n)
    check(bits_equal(recon.detach(), mp_decode_batch_torch(*ev, bank.detach(), n=n)),
          "_OverlapAdd forward != the plain ordered decode")
    (grad,) = torch.autograd.grad((x_t - recon).square().sum(), bank)
    b64 = bank.detach().double().requires_grad_(True)
    (want,) = torch.autograd.grad((x_t.double() - mp_decode_batch_torch(*ev, b64, n=n)).square().sum(), b64)
    g_err = float((grad.double() - want).abs().max() / want.abs().max())
    check(g_err <= 1e-4, f"_OverlapAdd gradient off float64 autograd by {g_err:.3g} of its largest entry")
    step_ms = 1e3 * statistics.median(step_s)
    log(f"[13] online learner, flat flagship ({BATCH} blocks, bank [{k}, {w}, 1], {cfg.num_coefs[0]} coefs, 5 steps): "
        f"launches {launches}; loss {losses[0]:.6g} -> {losses[-1]:.6g}; two runs bitwise the same bank; "
        f"_OverlapAdd forward == plain decode bitwise, gradient within {g_err:.3g} (of its largest entry) of "
        f"float64 autograd; card {card}: {stats([1e3 * v for v in step_s], 'ms', '.2f')} per step (host wall)")
    return launches, {"online_step_ms": step_ms, "online_grad_rel_err": g_err}


def rate_curve_phase(dev, mld, xs) -> dict:
    """Phase 13d: `rate_distortion_curve(use_device=True)` against the
    oracle's curve on 2 flagship blocks."""
    from hsc_torch.analysis import rate_distortion_curve

    budgets = [8, 32, 64]
    with counted() as launches:
        device = rate_distortion_curve(mld, xs[:2], budgets, use_device=True, device=dev)
    oracle = rate_distortion_curve(mld, xs[:2], budgets, use_device=False)
    check(launches["mp_encode"] > 0 and launches["ordered_decode"] > 0,
          f"the rate curve did not launch both kernels: {launches}")
    for (ro, so), (rd, sd) in zip(oracle, device):
        check(ro == rd, f"rate curve on the card: rate {rd} != the oracle's {ro}")
        check(abs(so - sd) < 0.15, f"rate curve on the card: SNR {sd} dB, the oracle's {so} dB")
    log(f"[13] rate_distortion_curve(use_device=True), 2 flagship blocks, budgets {budgets}: launches {launches}; "
        f"rates == oracle, SNR within 0.15 dB: " + ", ".join(f"{r:.4f} b/s {s:.3f} dB (oracle {so:.3f})"
                                                             for (r, s), (_, so) in zip(device, oracle)))
    return launches


def cli_phase(dev) -> None:
    """Phase 13e: the CLI in subprocesses with no --device, on a small
    corpus of the flagship hierarchy; the in-process decode it is held to
    runs on `dev`."""
    import os
    import shutil

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.analysis import corpus_rates
    from hsc_torch.io import iter_blocks, peek_corpus_header
    from hsc_torch.runtime import CorpusEncoder

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke", "cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = make_test_config(**HIER)
    xs = SignalGenerator(MultilevelDictionary.generate(cfg, seed=9), rates=2e-3).generate_signals(
        8, cfg.block_size, seed=5)
    path = {name: os.path.join(work, name) for name in ("sig.npy", "d.npz", "c.hsct", "rows.npy", "r13.npy")}
    np.save(path["sig.npy"], xs.reshape(-1))

    def cli(*args):
        return subprocess.Popen([sys.executable, "-m", "hsc_torch.cli", *args], cwd=root, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def finish(proc, what):
        out, err = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"hsc_torch.cli {what} failed ({proc.returncode}): {err[-2000:]}")
        return out

    t0 = time.perf_counter()
    finish(cli("learn", "--input", path["sig.npy"], "--output", path["d.npz"],
               "--counts", ",".join(map(str, cfg.counts)), "--scales", ",".join(map(str, cfg.scales)),
               "--block-size", str(cfg.block_size), "--learn-coefs", ",".join(map(str, cfg.num_coefs)),
               "--num-select", str(cfg.num_select), "--num-windows", "512", "--iterations", "5"), "learn")
    t_learn = time.perf_counter() - t0
    finish(cli("encode", "--dict", path["d.npz"], "--input", path["sig.npy"], "--output", path["c.hsct"]), "encode")
    procs = {"info": cli("info", "--input", path["c.hsct"]),
             "decode": cli("decode", "--dict", path["d.npz"], "--input", path["c.hsct"], "--output", path["rows.npy"]),
             "decode --range": cli("decode", "--dict", path["d.npz"], "--input", path["c.hsct"],
                                   "--output", path["r13.npy"], "--range", "1:3")}
    outs = {what: finish(proc, what) for what, proc in procs.items()}
    wall = time.perf_counter() - t0
    mld = MultilevelDictionary.load(path["d.npz"])
    check(mld.config.counts == cfg.counts and mld.config.num_select == cfg.num_select, "learned config differs")
    with open(path["c.hsct"], "rb") as f:
        blob = f.read()
    rows = np.load(path["rows.npy"])
    check(rows.tobytes() == CorpusEncoder(mld, device=dev).decode(blob).tobytes(),
          f"CLI decode rows != an in-process CorpusEncoder(device={str(dev)!r}).decode")
    check(np.load(path["r13.npy"]).tobytes() == rows[1:3].tobytes(), "CLI decode --range 1:3 != rows[1:3]")
    doc = json.loads(outs["info"])
    rates = corpus_rates(peek_corpus_header(blob)[0], iter_blocks(blob))
    rates["per_level_payload_bits"] = {str(k): v for k, v in rates["per_level_payload_bits"].items()}
    check(doc["blocks"] == len(xs) and doc["file_bytes"] == len(blob)
          and all(doc[k] == v for k, v in rates.items()), "CLI info != analysis.corpus_rates of the container")
    log(f"[13] CLI (python -m hsc_torch.cli, no --device): learn of 2 levels ({t_learn:.1f} s), encode, then info, "
        f"decode and decode --range 1:3 in parallel, {wall:.1f} s in all; {len(xs)} blocks -> {len(blob)} bytes "
        f"(ratio {doc['compression_ratio']:.2f}); rows == in-process CorpusEncoder decode bitwise, range rows == "
        f"rows[1:3], info == analysis.corpus_rates")


def learning(dev, card, mld, xs) -> dict:
    """Phase 13: learning and the CLI on the card.  Returns the numbers it
    measured and the launches of the in-process learning paths (trainer,
    online learner, rate curve), counted each on its own."""
    t0 = time.perf_counter()
    out = kmeans_phase(dev, card)
    trainer_launches, numbers = trainer_phase(dev, card)
    out.update(numbers)
    online_launches, numbers = online_phase(dev, card, xs)
    out.update(numbers)
    curve_launches = rate_curve_phase(dev, mld, xs)
    cli_phase(dev)
    out["launches"] = {k: trainer_launches[k] + online_launches[k] + curve_launches[k] for k in trainer_launches}
    out["seconds"] = time.perf_counter() - t0
    log(f"[13] learning and the CLI took {out['seconds']:.1f} s; launches on the learning paths {out['launches']}")
    return out


# phase 14: every mesh is 4 shards of the first card
MESH_SHARDS = 4
# phase 14b: a 3-level hierarchy the card had not run (level 2: 16 raw atoms
# of width 193 over the 96-channel level-1 map), on 32 blocks
HIER3 = dict(counts=(64, 32, 16), scales=(32, 96, 288), block_size=16384, num_coefs=(512, 192, 64), num_select=8)


def mesh_of(axis: str):
    from hsc_torch.parallel import make_mesh

    return make_mesh({axis: MESH_SHARDS}, devices=["cuda:0"] * MESH_SHARDS)


def init_batch_check(dev, mld, xs) -> None:
    """Phase 14a, first: the level-0 init of 64 flagship blocks is the same
    bits at batch 64, 32, 17 and 1 (a shard's batch is not the local
    path's where the corpus is ragged)."""
    import torch

    from hsc_torch.ops.encode import encode_init_batched
    from hsc_torch.params import level_params_from_mld

    bank = level_params_from_mld(mld, 0, dev).bank
    x = torch.from_numpy(xs[:BATCH, :, None]).to(dev)
    want = encode_init_batched(x, bank)
    for bs in (32, 17, 1):
        parts = [encode_init_batched(x[i : i + bs], bank) for i in range(0, BATCH, bs)]
        for j, name in enumerate(("scores", "e0", "peak")):
            got = torch.cat([p[j] for p in parts])
            if not bits_equal(got, want[j]):
                diff = got != want[j]
                log(f"[14] init at batch {bs}: {name} differs from batch {BATCH} first at "
                    f"{[int(v) for v in diff.nonzero()[0]]}, {int(diff.sum())} cells, max |diff| "
                    f"{float((got - want[j]).abs().max()):.3g}")
            check(bits_equal(got, want[j]), f"the level-0 init at batch {bs} != at batch {BATCH} ({name})")
    log(f"[14] the level-0 init of {BATCH} flagship blocks: scores, e0 and peak bitwise the same at batch "
        f"{BATCH}, 32, 17 and 1")


def dp_codec(dev, card, mld, xs, blob, rows) -> tuple[dict, dict]:
    """Phase 14a: CorpusEncoder on the 4-shard mesh at the flat flagship's
    128 blocks of phase 5, counted, its container and rows byte-identical
    to the local path's (and a ragged corpus of 101 blocks), timed in turns
    with the local path."""
    from hsc_torch.runtime import CorpusEncoder

    cfg = mld.config
    bs = 32
    local = CorpusEncoder(mld, device=dev, batch_size=bs)
    with counted() as launches:
        sharded = CorpusEncoder(mld, device=dev, batch_size=bs, mesh=mesh_of("data"))
        got = sharded.encode(xs)
        got_rows = sharded.decode(got)
    want = {"mp_encode": MESH_SHARDS * -(-len(xs) // (bs * MESH_SHARDS)),
            "int_decode": MESH_SHARDS * -(-len(xs) // bs), "sparse_init": 0, "ordered_decode": 0}
    check(launches == want, f"mesh codec launches {launches}, expected {want}")
    check(got == local.encode(xs), "mesh container != the local batch_size=32 container")
    check(got == blob, "mesh container != phase 5's batch_size=64 container")
    check(got_rows.tobytes() == rows.tobytes(), "mesh decode rows != phase 5's rows")
    ragged = xs[:101]
    rb = sharded.encode(ragged)
    check(rb == local.encode(ragged), "mesh container of 101 blocks != the local one")
    check(sharded.decode(rb).tobytes() == local.decode(rb).tobytes(), "mesh rows of 101 blocks != the local ones")
    mb = len(xs) * cfg.block_size * 4 / 1e6
    enc_m, enc_l = turns(lambda: mb / wall_s(lambda: sharded.encode(xs)), lambda: mb / wall_s(lambda: local.encode(xs)), 4)
    dec_m, dec_l = turns(lambda: mb / wall_s(lambda: sharded.decode(got)), lambda: mb / wall_s(lambda: local.decode(got)), 4)
    log(f"[14] DP codec, {len(xs)} flat-flagship blocks, batch_size {bs}, {MESH_SHARDS} shards of cuda:0: launches "
        f"{launches}; container == local batch 32 == phase 5's batch 64, rows == phase 5's, 101 blocks (padded) == "
        f"local; card {card}")
    log(f"[14] DP encode {stats(enc_m, 'MB/s', '.2f')} vs local {stats(enc_l, 'MB/s', '.2f')}; DP decode "
        f"{stats(dec_m, 'MB/s', '.2f')} vs local {stats(dec_l, 'MB/s', '.2f')} (host wall, in turns)")
    return launches, {"dp_encode_mb_s": statistics.median(enc_m), "local32_encode_mb_s": statistics.median(enc_l),
                      "dp_decode_mb_s": statistics.median(dec_m), "local32_decode_mb_s": statistics.median(dec_l)}


def dp_hierarchy(dev) -> dict:
    """Phase 14b: the hierarchical DP codec on the 4-shard mesh (16 blocks a
    shard) at the flagship hierarchy (int8 hand-off), the same with
    hier_init='f32', and a 3-level hierarchy: each container byte-identical
    to the local path's (batch 64, as phase 9) and backend='torch''s, and
    the top streams through `DataParallelDecoder` in both modes bitwise the
    local and plain decodes.  Returns the launches, counted."""
    import torch

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.io import unpack_corpus
    from hsc_torch.runtime import CorpusEncoder

    total = dict.fromkeys(kernel_counters(), 0)
    for name, kw, nb in (("int8", HIER, N_BLOCKS), ("f32", dict(HIER, hier_init="f32"), N_BLOCKS),
                         ("3-level", HIER3, 32)):
        cfg = make_test_config(**kw)
        mld = MultilevelDictionary.generate(cfg, seed=9)
        xs = SignalGenerator(mld, rates=2e-3).generate_signals(nb, cfg.block_size, seed=5)
        local = CorpusEncoder(mld, device=dev)
        plain = CorpusEncoder(mld, device=dev, backend="torch")
        t0 = time.perf_counter()
        with counted() as launches:
            sharded = CorpusEncoder(mld, device=dev, batch_size=BATCH // MESH_SHARDS, mesh=mesh_of("data"))
            blob = sharded.encode(xs)
            rows = sharded.decode(blob)
            _, blocks = unpack_corpus(blob)
            streams = [s[0][1] for s in blocks]
            by_mode = {m: sharded.dp_dec.decode_batch_device(streams, mode=m).cpu() for m in ("integer", "ordered")}
        wall = time.perf_counter() - t0
        for k, v in launches.items():
            total[k] += v
        want_init = "sparse_init" if cfg.hier_init == "int8" else None
        check(launches["mp_encode"] > 0 and (want_init is None or launches[want_init] > 0)
              and launches["int_decode"] > 0 and launches["ordered_decode"] > 0,
              f"{name} hierarchy on the mesh: a kernel was never launched: {launches}")
        check(blob == local.encode(xs), f"{name} hierarchy: mesh container != local container")
        check(blob == plain.encode(xs), f"{name} hierarchy: mesh container != backend='torch' container")
        check(rows.tobytes() == local.decode(blob).tobytes(), f"{name} hierarchy: mesh rows != local rows")
        for m, got in by_mode.items():
            check(bits_equal(got, local.coder.reconstruct_batch_device(streams, mode=m).cpu())
                  and bits_equal(got, plain.coder.reconstruct_batch_device(streams, mode=m).cpu()),
                  f"{name} hierarchy: DataParallelDecoder {m} rows != local or plain rows")
        events = [int(s.positions.shape[0]) for s in streams]
        log(f"[14] {name} hierarchy (counts {cfg.counts}, scales {cfg.scales}, num_coefs {cfg.num_coefs}, hier_init "
            f"{cfg.hier_init}), {nb} blocks on the mesh: launches {launches}; {len(blob)} bytes "
            f"(ratio {xs.nbytes / len(blob):.2f}x, top events mean {np.mean(events):.1f}); container == local == "
            f"backend='torch'; DataParallelDecoder rows in both modes == local == plain; {wall:.2f} s")
        del local, plain, sharded
        torch.cuda.empty_cache()
    return total


def single_block_mesh(dev, card) -> tuple[dict, dict]:
    """Phases 14c-d: SP on one 65536-sample block of phase 11's config on
    {'seq': 4}, TP on one flat-flagship block on {'model': 4}, both of
    cuda:0.  Given the single-device init, bitwise the local kernel loop at
    num_select 1 and 8 and at an SNR stop; with their own init, either the
    same stream or a first differing event where their init is within 1e-5
    of the peak of the single-device one."""
    import torch

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.ops import mp_kernels
    from hsc_torch.ops.encode import encode_init_batched, quantizer_steps
    from hsc_torch.params import level_params_from_mld
    from hsc_torch.parallel.sp import sp_init, sp_loop, sp_shard_scores
    from hsc_torch.parallel.tp import tp_init, tp_loop, tp_shard_scores

    numbers = {}
    for mode, kw, seeds in (("sp", dict(counts=(16,), scales=(32,), block_size=65536, num_coefs=(512,)), (21, 23)),
                            ("tp", FLAGSHIP, (7, 3))):
        cfg = make_test_config(**kw)
        mld = MultilevelDictionary.generate(cfg, seed=seeds[0])
        x = SignalGenerator(mld, rates=2e-3).generate_signals(1, cfg.block_size, seed=seeds[1])[0]
        params = level_params_from_mld(mld, 0, dev)
        s0, e0, peak = encode_init_batched(torch.from_numpy(x[None, :, None]).to(dev), params.bank)
        sc, iv = quantizer_steps(peak.cpu().numpy(), cfg.amp_bits)
        sc_t, iv_t = torch.from_numpy(sc).to(dev), torch.from_numpy(iv).to(dev)
        axis = "seq" if mode == "sp" else "model"
        mesh = mesh_of(axis)
        gram = params.gram_t if mode == "sp" else torch.from_numpy(mld.gram(0)).to(dev)
        shards = (sp_shard_scores(mesh, s0[0], cfg.block_size) if mode == "sp" else tp_shard_scores(mesh, s0[0]))
        loop = sp_loop if mode == "sp" else tp_loop
        for ns, tol in ((1, None), (8, None), (8, 5.0)):
            kw_l = dict(num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, num_select=ns, tolerance_snr=tol)
            want = mp_kernels.mp_loop(s0.clone(), e0, sc_t, iv_t, params, **kw_l)
            t0 = time.perf_counter()
            got = loop(mesh, shards, e0[0], sc[0], iv[0], gram, **kw_l)
            n = int(got.count)  # waits for the loop
            dt = time.perf_counter() - t0
            check(n == int(want.count[0]) and n > 0, f"{mode} ns={ns} tol={tol}: count {n} != {int(want.count[0])}")
            for f in ("positions", "atoms", "codes"):
                check(torch.equal(getattr(got, f)[:n], getattr(want, f)[0, :n]),
                      f"{mode} ns={ns} tol={tol}: {f} != the local kernel loop's")
            check(got.energy_res.item() == want.energy_res[0].item(), f"{mode} ns={ns} tol={tol}: energy_res differs")
            numbers[f"{mode}_s_ns{ns}" + ("_snr" if tol else "")] = dt
            log(f"[14] {mode.upper()} on {MESH_SHARDS} shards of cuda:0, one block of {cfg.block_size} samples "
                f"({cfg.counts[0]} atoms of width {cfg.scales[0]}), ns={ns} tol={tol}, given the local init: "
                f"{n} events bitwise the local kernel loop; {dt:.3f} s per block; card {card}")
        # un-injected: the sharded init, then the contract of ROADMAP "How a slice is held"
        init = sp_init if mode == "sp" else tp_init
        own_s0, own_e0, own_peak = init(mesh, x, params.bank)
        full = torch.cat(own_s0, dim=1)[:, : s0.shape[2]] if mode == "sp" else torch.cat(own_s0)
        err = float((full - s0[0]).abs().max())
        check(err <= 1e-5 * float(peak[0]), f"{mode} init off the local init by {err:.3g} (peak {float(peak[0]):.4g})")
        kw_l = dict(num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, num_select=8)
        o_sc, o_iv = quantizer_steps(own_peak.cpu().numpy(), cfg.amp_bits)
        own = loop(mesh, own_s0, own_e0, o_sc, o_iv, gram, **kw_l)
        want = mp_kernels.mp_loop(s0.clone(), e0, sc_t, iv_t, params, **kw_l)
        n, m = int(own.count), int(want.count[0])
        fields = [torch.cat([getattr(own, f)[:n].cpu(), torch.zeros(max(m - n, 0), dtype=torch.int32)])[:max(n, m)]
                  for f in ("positions", "atoms", "codes")]
        ref = [torch.cat([getattr(want, f)[0, :m].cpu(), torch.zeros(max(n - m, 0), dtype=torch.int32)])[:max(n, m)]
               for f in ("positions", "atoms", "codes")]
        differ = [j for j in range(max(n, m)) if any(int(a[j]) != int(b[j]) for a, b in zip(fields, ref))]
        if not differ and n == m:
            log(f"[14] {mode.upper()} with its own init (within {err / float(peak[0]):.3g} of the peak of the local "
                f"init): the local stream, {n} events, bitwise")
        else:
            j = differ[0] if differ else min(n, m)
            t, f = int(ref[0][min(j, len(ref[0]) - 1)]), int(ref[1][min(j, len(ref[1]) - 1)])
            d = float((full[f, t] - s0[0, f, t]).abs())
            log(f"[14] {mode.upper()} with its own init: the streams first differ at event {j} (local: position {t}, "
                f"atom {f}); the inits differ there by {d:.3g}, within 1e-5 of the peak {float(peak[0]):.4g}")
    return numbers


def mesh_learning(dev, card, xs) -> tuple[dict, dict]:
    """Phase 14e: distributed k-means at `bench.py:291-296`'s geometry on
    {'data': 4}, timed, bitwise run to run and atom for atom the local
    loop's; the online learner on the mesh at the flat flagship (64
    blocks, 5 steps), counted, bitwise run to run, its first step within
    1e-4 (loss, relative) and 1e-5 (bank) of the local learner's."""
    import torch

    from hsc_torch import make_test_config
    from hsc_torch.learn import OnlineConvolutionalDictionaryLearner, kmeans_refine_device
    from hsc_torch.parallel import distributed_kmeans

    m, d, k, iters = KMEANS
    rng = np.random.default_rng(0)
    flat = rng.standard_normal((m, d)).astype(np.float32)
    cents = rng.standard_normal((k, d)).astype(np.float32)
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    w_d, c_d = torch.from_numpy(flat).to(dev), torch.from_numpy(cents).to(dev)
    mesh = mesh_of("data")
    first = distributed_kmeans(mesh, w_d, c_d, iters)
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        again = distributed_kmeans(mesh, w_d, c_d, iters)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        check(bits_equal(again[0], first[0]) and bits_equal(again[1], first[1]), "distributed k-means differs run to run")
    local_c, local_o = kmeans_refine_device(w_d, c_d, iterations=iters)
    sims = (first[0] @ local_c.T).abs()
    cos = float(sims.max(dim=1).values.min())
    check(cos > 0.99, f"a distributed k-means atom has no local counterpart (min max |cos| {cos:.4f})")
    o_rel = float(((first[1] - local_o) / local_o).abs().max())
    ms = statistics.median(times)
    log(f"[14] distributed k-means, {m} windows x {d}, {k} centroids, {iters} iterations on {MESH_SHARDS} shards: "
        f"{stats(times, 'ms')} (CUDA events, 5 runs) = {m * iters / ms / 1e3:.2f} M window-assignments/s; bitwise run "
        f"to run; every atom within |cos| >= {cos:.6f} of the local loop's, objectives within {o_rel:.3g} relative; "
        f"card {card}")

    cfg = make_test_config(**FLAGSHIP)
    bank0 = unit_bank(np.random.default_rng(0), cfg.counts[0], cfg.scales[0])
    xb = xs[:BATCH]

    def run(with_mesh):
        learner = OnlineConvolutionalDictionaryLearner(bank0, num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits,
                                                       mesh=mesh if with_mesh else None, device=dev)
        step_s, banks = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            learner.step(xb)  # returns the loss as a float: the step has ended
            step_s.append(time.perf_counter() - t0)
            banks.append(learner.bank.detach().clone())
        return learner, step_s, banks

    with counted() as launches:
        a, step_s, banks_a = run(True)
    check(launches["mp_encode"] > 0 and launches["ordered_decode"] > 0,
          f"the mesh online learner did not launch both kernels: {launches}")
    b, _, _ = run(True)
    check(bits_equal(a.bank.detach(), b.bank.detach()) and a.loss_history == b.loss_history,
          "two mesh online runs gave different banks")
    loc, loc_s, banks_l = run(False)
    l_rel = abs(a.loss_history[0] - loc.loss_history[0]) / abs(loc.loss_history[0])
    b_err = float((banks_a[0] - banks_l[0]).abs().max())
    check(l_rel <= 1e-4 and b_err <= 1e-5, f"mesh online step 1: loss off by {l_rel:.3g} relative, bank by {b_err:.3g}")
    drift = float((banks_a[-1] - banks_l[-1]).abs().max())
    log(f"[14] online learner on {MESH_SHARDS} shards, {BATCH} flat-flagship blocks, 5 steps: launches {launches}; "
        f"bitwise run to run; step 1 loss within {l_rel:.3g} relative and bank within {b_err:.3g} of the local "
        f"learner's; after 5 steps the banks differ by {drift:.3g}; per step {stats(step_s, 's')} vs local "
        f"{stats(loc_s, 's')}")
    return launches, {"dist_kmeans_ms": ms, "online_mesh_step_s": statistics.median(step_s),
                      "online_local_step_s": statistics.median(loc_s)}


def mesh_cli(dev, mld, xs) -> None:
    """Phase 14f: `python -m hsc_torch.cli encode --mesh 1 --device cuda`
    gives the bytes of an encode with no mesh; `--mesh N` past the visible
    cards exits naming them."""
    import os
    import shutil

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke", "cli_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    mld.save(os.path.join(work, "d.npz"))
    np.save(os.path.join(work, "sig.npy"), xs[:8].reshape(-1))

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "hsc_torch.cli", "encode", "--dict", os.path.join(work, "d.npz"),
                               "--input", os.path.join(work, "sig.npy"), "--device", "cuda", *args], cwd=root,
                              capture_output=True, text=True, timeout=300)

    outs = {tag: cli("--output", os.path.join(work, f"{tag}.hsct"), *extra)
            for tag, extra in (("local", []), ("mesh1", ["--mesh", "1"]))}
    for tag, proc in outs.items():
        check(proc.returncode == 0, f"CLI encode ({tag}) failed: {proc.stderr[-2000:]}")
    with open(os.path.join(work, "local.hsct"), "rb") as f, open(os.path.join(work, "mesh1.hsct"), "rb") as g:
        check(f.read() == g.read(), "CLI encode --mesh 1 != CLI encode with no mesh")
    visible = torch.cuda.device_count()
    bad = cli("--output", os.path.join(work, "bad.hsct"), "--mesh", str(visible + 1))
    want = f"--mesh {visible + 1}: only {visible} device(s) visible"
    check(bad.returncode != 0 and want in bad.stderr, f"CLI --mesh {visible + 1}: {bad.returncode}, {bad.stderr[-500:]}")
    check(not os.path.exists(os.path.join(work, "bad.hsct")), "CLI --mesh past the cards wrote a file")
    log(f"[14] CLI encode --mesh 1 --device cuda == no mesh, bytewise; --mesh {visible + 1} exits: {want!r}")


def parallel(dev, card, mld, xs, blob, rows) -> dict:
    """Phase 14: the parallel layer on 4-shard meshes of the one card.
    Returns the measured numbers and the launches of the mesh paths (the DP
    codec, the hierarchies, the online learner), counted each on its own."""
    t0 = time.perf_counter()
    init_batch_check(dev, mld, xs)
    launches, out = dp_codec(dev, card, mld, xs, blob, rows)
    for k, v in dp_hierarchy(dev).items():
        launches[k] += v
    out.update(single_block_mesh(dev, card))
    online_launches, numbers = mesh_learning(dev, card, xs)
    out.update(numbers)
    for k, v in online_launches.items():
        launches[k] += v
    mesh_cli(dev, mld, xs)
    check(all(v > 0 for v in launches.values()), f"a kernel was never launched on the mesh paths: {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(f"[14] the parallel layer took {out['seconds']:.1f} s; launches on the mesh paths {launches}")
    return out


# phase 15a: scripts/torch_fuzz_parity.py at fixed seeds (base seed 1: seeds
# 1000-1007, of which 4 draw a window of 130 or more), shapes per mode
FUZZ_BASE_SEED = 1
FUZZ_SHAPES = {"flat": 8, "hierarchical": 4, "container": 4}


def odd_width_int_decode(dev) -> None:
    """Phase 15b, the parity gauntlet's check 5b
    (scripts/check_tpu_parity.py:330-360): the integer-decode kernel at W =
    33, 48 and 59, the widths at which the reference's kernel once wrote
    wrong rows (K 24, 3000-sample blocks, 96 random events, counts 96 and
    48), bitwise its plain version and `oracle.mp.mp_decode_integer`."""
    import torch

    from hsc_torch.ops import decode_integer_kernel
    from hsc_torch.ops.decode import mp_decode_integer_batch_torch
    from hsc_torch.oracle.mp import LevelStream, mp_decode_integer

    drng = np.random.default_rng(99)
    kdec, ndec, mdec = 24, 3000, 96
    for wdec in (33, 48, 59):
        nposd = ndec - wdec + 1
        dpos = drng.integers(0, nposd, (2, mdec)).astype(np.int32)
        datm = drng.integers(0, kdec, (2, mdec)).astype(np.int32)
        dcds = drng.integers(-32767, 32768, (2, mdec)).astype(np.int32)
        dcnt = np.array([mdec, mdec // 2], np.int32)
        dstp = np.float32([1e-4, 2e-4])
        drep = drng.integers(-2047, 2048, (kdec, wdec, 1)).astype(np.int32)
        args = [torch.from_numpy(a).to(dev) for a in (dpos, datm, dcds, dcnt, dstp, drep)]
        got = decode_integer_kernel.mp_decode_integer_batch(*args, n=ndec)
        check(bits_equal(got, mp_decode_integer_batch_torch(*args, n=ndec)),
              f"int_decode kernel != plain at W={wdec}")
        for b in range(2):
            st = LevelStream(dpos[b, :dcnt[b]], datm[b, :dcnt[b]], dcds[b, :dcnt[b]], np.float32(1), 0.0, 0.0)
            check(got[b].cpu().numpy().tobytes() == mp_decode_integer(st, drep, dstp[b], ndec).tobytes(),
                  f"int_decode kernel != oracle at W={wdec}, block {b}")


def gates(dev) -> dict:
    """Phase 15: the hardware gates.  (a) scripts/torch_fuzz_parity.py's
    three modes at fixed seeds; (b) gauntlet check 5b; (c) gauntlet check 7,
    the greedy-loop kernel at W = 160 (8 atoms, 24 coefficients,
    2048-sample blocks, dictionary seed 44, signals seed 93), bitwise the
    plain loop and the oracle given its init.  Returns the launches of all
    three, counted, and the phase's seconds."""
    import importlib
    import os

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config

    t_phase = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    fuzz = importlib.import_module("torch_fuzz_parity")
    total = dict.fromkeys(kernel_counters(), 0)
    runs = {"flat": fuzz.run_shape, "hierarchical": fuzz.run_hier_shape, "container": fuzz.run_container_shape}
    for mode, n in FUZZ_SHAPES.items():
        seeds = [FUZZ_BASE_SEED * 1000 + i for i in range(n)]
        t0 = time.perf_counter()
        with counted() as launches:
            results = [runs[mode](seed, dev) for seed in seeds]
        for r in results:
            log(f"[15] {mode} {json.dumps(r)}")
        bad = [(r["seed"], r["diff"]) for r in results if not r["ok"]]
        check(not bad, f"phase 15 {mode} fuzz: shapes differ: {bad}")
        want = {"flat": ("mp_encode",), "hierarchical": ("mp_encode", "int_decode", "ordered_decode"),
                "container": ("mp_encode",)}[mode]
        check(all(launches[k] > 0 for k in want), f"phase 15 {mode} fuzz never launched {want}: {launches}")
        if mode == "flat":
            wide = sum(r["w"] >= 130 for r in results)
            check(wide >= 2, f"phase 15 flat fuzz drew {wide} windows of 130 or more, fewer than 2")
        for k, v in launches.items():
            total[k] += v
        log(f"[15a] {mode} fuzz, seeds {seeds[0]}-{seeds[-1]}: {n}/{n} shapes bitwise (see the lines above); "
            f"launches {launches}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with counted() as launches:
        odd_width_int_decode(dev)
    check(launches["int_decode"] == 3, f"check 5b launches {launches}")
    log(f"[15b] gauntlet check 5b: int_decode kernel at W = 33, 48, 59 (K 24, N 3000, 96 events, counts [96, 48]) "
        f"== plain == oracle bitwise; {time.perf_counter() - t0:.1f} s")
    for k, v in launches.items():
        total[k] += v
    t0 = time.perf_counter()
    cfg = make_test_config(counts=(8,), scales=(160,), num_coefs=(24,), block_size=2048)
    mld = MultilevelDictionary.generate(cfg, seed=44)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(2, cfg.block_size, seed=93)
    with counted() as launches:
        r = fuzz.flat_parity(mld, xs, dev)
    check(r["ok"], f"gauntlet check 7 (W=160): {r['diff']}")
    check(launches["mp_encode"] == 1, f"check 7 launches {launches}")
    for k, v in launches.items():
        total[k] += v
    log(f"[15c] gauntlet check 7: mp_encode kernel at W = 160 (K 8, 24 coefficients, N 2048; events "
        f"{r['events']}) == plain == oracle bitwise; {time.perf_counter() - t0:.1f} s")
    seconds = time.perf_counter() - t_phase
    log(f"[15] the hardware gates took {seconds:.1f} s; launches {total}")
    return {"launches": total, "seconds": seconds}


# phase 20: scripts/torch_fuzz_parity.py's modes for the gates' blind spots,
# each at a fixed base seed (seeds base * 1000 + i) and shape count, drawn so
# that the shapes cover what the phase checks they cover
BLIND_SPOTS = {"batch": (2, 3), "long": (2, 6), "three_level": (3, 2), "container_f32": (2, 3), "mesh": (2, 3)}


def blind_spots(dev, card) -> dict:
    """Phase 20: the gates' blind spots.  scripts/torch_fuzz_parity.py's
    --batch, --long, --three-level, --container-f32 and --mesh modes at
    `BLIND_SPOTS`' seeds, counted, every shape logged, fatal on any shape
    that differs.  Then what the shapes covered: at least 2 long shapes
    whose level-0 loop keeps its selection cache in a global workspace and
    2 in shared memory (the kernels' own answers, which on a card with the
    H100's 227 KiB opt-in must be the script's H100 rules), at least 1
    whose level-1 int8 init sorts in a global workspace, a corpus of more
    blocks than the card has SMs, a 3-level shape with each hier_init, an
    f32 container that is distributed and keeps a level below the top, a
    mesh shape that ran `sp_loop` and `tp_loop`, and every kernel launched.
    Returns the launches and the phase's seconds."""
    import importlib
    import os

    import torch

    t_phase = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    fuzz = importlib.import_module("torch_fuzz_parity")
    total = dict.fromkeys(kernel_counters(), 0)
    results = {}
    for mode, (base, n) in BLIND_SPOTS.items():
        seeds = [base * 1000 + i for i in range(n)]
        t0 = time.perf_counter()
        with counted() as launches:
            results[mode] = [fuzz.MODES[mode][0](seed, dev) for seed in seeds]
        for r in results[mode]:
            log(f"[20] {mode} {json.dumps(r)}")
        bad = [(r["seed"], r["diff"]) for r in results[mode] if not r["ok"]]
        check(not bad, f"phase 20 {mode}: shapes differ: {bad}")
        for k, v in launches.items():
            total[k] += v
        log(f"[20] {mode}, base seed {base}, seeds {seeds[0]}-{seeds[-1]}: {n}/{n} shapes bitwise; launches "
            f"{launches}; {time.perf_counter() - t0:.1f} s")
    props = torch.cuda.get_device_properties(0)
    long = results["long"]
    if props.shared_memory_per_block_optin == fuzz.H100_SMEM_OPTIN:
        off = [(r["seed"], r["mp_workspace_bytes"], r["h100_rule_mp_workspace_bytes"], r["int8_sort_workspace_ints"],
                r["h100_rule_int8_sort_workspace_ints"]) for r in long
               if (r["mp_workspace_bytes"], r["int8_sort_workspace_ints"])
               != (r["h100_rule_mp_workspace_bytes"], r["h100_rule_int8_sort_workspace_ints"])]
        check(not off, f"phase 20: the kernels' workspaces differ from the script's H100 rules: {off}")
    routes = [r["mp_workspace_bytes"][0] > 0 for r in long]
    sorts = sum((r["int8_sort_workspace_ints"] or 0) > 0 for r in long)
    widest = max(r["blocks"] for r in results["batch"])
    inits = sorted({r["hier_init"] for r in results["three_level"]})
    dist = [r["seed"] for r in results["container_f32"]
            if r["hier_init"] == "f32" and r["distributed"] and any(len(s) > 1 for s in r["streams"])]
    meshes = sum(r["sp_tp"] for r in results["mesh"])
    check(sum(routes) >= 2 and routes.count(False) >= 2,
          f"phase 20: long shapes on the loop's workspace / shared-memory routes {sum(routes)} / "
          f"{routes.count(False)}, fewer than 2 each")
    check(sorts >= 1, "phase 20: no long shape took the int8 init's global sort")
    check(widest > props.multi_processor_count,
          f"phase 20: the widest corpus, {widest} blocks, does not pass the card's {props.multi_processor_count} SMs")
    check(inits == ["f32", "int8"], f"phase 20: the 3-level shapes drew hier_init {inits}")
    check(dist, "phase 20: no f32 container was distributed with a level below the top")
    check(meshes >= 1, "phase 20: no mesh shape ran sp_loop and tp_loop")
    check(all(v > 0 for v in total.values()), f"phase 20: a kernel never launched: {total}")
    seconds = time.perf_counter() - t_phase
    log(f"[20] coverage: long shapes on the loop's workspace / shared-memory route {sum(routes)} / "
        f"{routes.count(False)}, on the int8 init's global sort {sorts}; widest corpus {widest} blocks on "
        f"{props.multi_processor_count} SMs; 3-level hier_init {inits}; distributed f32 containers {dist}; "
        f"mesh shapes with SP and TP {meshes}")
    log(f"[20] the gates' blind spots took {seconds:.1f} s; launches {total}; card {card}")
    return {"launches": total, "seconds": seconds}


# phase 21: scripts/torch_multicard.py on up to this many cards
MULTICARD_MAX = 4


def multicard() -> dict:
    """Phase 21: scripts/torch_multicard.py --mode all on min(4, N) cards in
    a subprocess, each line it prints logged; with one card visible it does
    not run.  Returns ``{"cards", "ran"}`` and, where it ran, its checks
    and seconds."""
    import os

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        log(f"[21] not run: {n} card visible")
        return {"cards": n, "ran": False}
    cards = min(MULTICARD_MAX, n)
    torch.cuda.empty_cache()  # the subprocess's processes share the cards
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(here, "scripts", "torch_multicard.py"), "--mode", "all",
                           "--cards", str(cards)], capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines:
        log(f"[21] {line}")
    check(proc.returncode == 0 and lines, f"phase 21: torch_multicard.py exited {proc.returncode}: "
                                          f"{proc.stderr[-3000:]}")
    summary = json.loads(lines[-1])
    check(summary["ok"] and summary["cards"] == cards, f"phase 21: torch_multicard.py failed: {summary}")
    seconds = time.perf_counter() - t0
    log(f"[21] {summary['checks']} checks on {cards} cards passed bytewise; {seconds:.1f} s")
    return {"cards": cards, "ran": True, "checks": summary["checks"], "seconds": seconds}


# phase 16: the experiment drivers, each run into a fresh directory.  (a) the
# flat flagship at the main path's width and batch; (b) the experiment's own
# 2-level defaults; (c) the audio driver's defaults (16 s of music) and (d)
# 16 s each of music and speech in integer mode at a corpus-wide 0.5 bits a
# sample.  The audio runs' NumPy-oracle R-D prefix is cut to 1 block and 2
# budgets (PERF.md §4).
AUDIO_RD = ["--rd-blocks", "1", "--budget-sweep", "16,128"]
EXPERIMENTS = (
    ("a", "torch_run_experiment", ["--counts", "64", "--scales", "32", "--num-coefs", "512", "--block-size", "16384",
                                   "--num-select", "8", "--decode-mode", "integer", "--blocks", "64",
                                   "--rate", "2e-3"]),
    ("b", "torch_run_experiment", []),
    ("c", "torch_run_audio_experiment", AUDIO_RD),
    ("d", "torch_run_audio_experiment", [*AUDIO_RD, "--synth", "both", "--decode-mode", "integer",
                                         "--target-bps", "0.5", "--rate-mode", "corpus"]),
)
EXPERIMENT_FILES = {
    "torch_run_experiment": ("truth_dict.npz", "learned_dict.npz", "corpus.hsct", "metrics.jsonl", "report.json",
                             "journal", "ckpt/trainer_state.npz"),
    "torch_run_audio_experiment": ("corpus_in.wav", "learned_dict.npz", "corpus.hsct", "decoded.wav",
                                   "metrics.jsonl", "report.json", "ckpt/trainer_state.npz"),
}


def experiment_corpus(args, out: str) -> np.ndarray:
    """The corpus a driver run encoded, made again from its files."""
    from hsc_torch import MultilevelDictionary, SignalGenerator
    from hsc_torch.signal import load_wav_blocks

    if hasattr(args, "synth"):
        return load_wav_blocks(f"{out}/corpus_in.wav", args.block_size)
    truth = MultilevelDictionary.load(f"{out}/truth_dict.npz")
    return SignalGenerator(truth, rates=args.rate).generate_signals(args.blocks, args.block_size, seed=args.seed + 1)


def experiments(dev, card) -> dict:
    """Phase 16: `scripts/torch_run_experiment.py` and
    `scripts/torch_run_audio_experiment.py` through their `main`, each run
    counted.  Every run writes its files (its figures too where matplotlib
    imports; else one line names them); the audio runs assert a byte-identical
    re-encode and `decode_stream` == `decode` on the card; each container
    decodes on the card bitwise the oracle's decode of its unpacked streams
    on its first and last block, and equals the container `backend='torch'`
    writes from the same corpus.  Across the runs every kernel launches.
    Returns the launches of all runs and the phase's seconds."""
    import importlib
    import importlib.util
    import io
    import os
    import shutil

    from hsc_torch import MultilevelDictionary
    from hsc_torch.io import unpack_corpus
    from hsc_torch.oracle import hierarchical_decode
    from hsc_torch.oracle.mp import mp_decode_integer, rep_quantize
    from hsc_torch.runtime import CorpusEncoder

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "scripts"))
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    total = dict.fromkeys(kernel_counters(), 0)
    for tag, script, extra in EXPERIMENTS:
        driver = importlib.import_module(script)
        out = os.path.join(root, "build", "chip_smoke", "experiments", tag)
        shutil.rmtree(out, ignore_errors=True)  # a stale ckpt/ would resume the trainer
        argv = ["--outdir", out, "--device", str(dev), *extra]
        printed = io.StringIO()
        t0 = time.perf_counter()
        try:
            with counted() as launches, contextlib.redirect_stdout(printed):
                report = driver.main(argv)
        finally:  # what the driver printed, also when it failed
            for line in printed.getvalue().splitlines():
                log(f"[16{tag}]   {line}")
        wall = time.perf_counter() - t0
        for k, v in launches.items():
            total[k] += v
        args = driver.parse_args(argv)
        missing = [f for f in EXPERIMENT_FILES[script] if not os.path.exists(os.path.join(out, f))]
        check(not missing, f"phase 16{tag}: {script} wrote no {missing}")
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
        skip_line = "figures not written (matplotlib is not installed): " in printed.getvalue()
        check(bool(pngs) == have_mpl != skip_line,
              f"phase 16{tag}: matplotlib {'imports' if have_mpl else 'is absent'}, figures {pngs}, "
              f"skip line printed: {skip_line}")

        learned = MultilevelDictionary.load(os.path.join(out, "learned_dict.npz"))
        with open(os.path.join(out, "corpus.hsct"), "rb") as f:
            blob = f.read()
        cfg, blocks = unpack_corpus(blob)
        top = cfg.num_levels - 1
        ends = (0, len(blocks) - 1)
        rows = CorpusEncoder(learned, device=dev).decode_blocks(blob, list(ends))
        rep_q, step = rep_quantize(learned.representations(top)[:, :, None], cfg.rep_bits)
        for i, b in enumerate(ends):
            (_, st), = blocks[b]
            want = (mp_decode_integer(st, rep_q, step, cfg.block_size)[:, 0] if cfg.decode_mode == "integer"
                    else hierarchical_decode(st, learned))
            check(rows[i].tobytes() == want.tobytes(), f"phase 16{tag}: block {b} decodes != the oracle")
        corpus = experiment_corpus(args, out)
        plain = CorpusEncoder(learned, device=dev, backend="torch", target_bps=getattr(args, "target_bps", None),
                              rate_mode=getattr(args, "rate_mode", "block"))
        check(plain.encode(corpus) == blob, f"phase 16{tag}: backend='torch' container != backend='cuda' container")

        enc = report["encode"]
        steps = {"corpus": report["corpus"].get("seconds", report["corpus"].get("seconds_wall")),
                 "learning": report["learning"]["seconds"], "encode": enc["seconds"]}
        steps["R-D, analysis, figures"] = wall - sum(steps.values())
        log(f"[16{tag}] {script} {' '.join(extra) or '(defaults)'}: {len(blocks)} blocks of {cfg.block_size}, "
            f"levels {cfg.counts}, {cfg.decode_mode}, hier_init {cfg.hier_init}; launches {launches} "
            f"(launched: {', '.join(k for k, v in launches.items() if v) or 'none'}); card {card}: wall {wall:.2f} s ("
            + ", ".join(f"{k} {v:.2f} s" for k, v in steps.items())
            + f"); ratio {enc['compression_ratio']:.2f}x, {enc['bits_per_sample']:.4f} bits/sample, mean SNR "
            f"{enc['mean_snr_db']:.3f} dB"
            + (f", corpus SNR {enc['corpus_snr_db']:.3f} dB, re-encode and decode_stream byte-identical"
               if "corpus_snr_db" in enc else "")
            + f"; blocks {ends} == oracle decode; container == backend='torch'")
    check(all(v > 0 for v in total.values()), f"phase 16: a kernel never launched across the drivers: {total}")
    seconds = time.perf_counter() - t_phase
    log(f"[16] the experiment drivers took {seconds:.1f} s; launches {total}")
    return {"launches": total, "seconds": seconds}


# phase 17: the measuring scripts through their `main`, each run counted.
# Serving at 2048 blocks (a corpus past phase 5's 128), the decode marginal
# in both modes, the encode stages at num_select 8, the hierarchy's stages at
# the flagship hierarchy with the TF32 init A/B, the mesh overhead at 1, 2
# and 4 shards of the one card, flat encode and decode.
MEASURES = (
    ("serving", "torch_bench_serving", ["--blocks", "2048"]),
    ("decode", "torch_bench_decode_marginal", ["--mode", "both"]),
    ("stages", "torch_bench_encode_stages", ["--ns", "8"]),
    ("hier", "torch_bench_hier_stages", ["--config", "flagship", "--init-ab"]),
    ("mesh", "torch_bench_scaling", ["--max-shards", "4"]),
    ("mesh-decode", "torch_bench_scaling", ["--max-shards", "4", "--decode"]),
)


def measures(dev, card) -> dict:
    """Phase 17: scripts/torch_bench_*.py through their `main` on the card,
    in-process, each run counted and its JSON lines logged.  A failed
    assertion in a script (the serving script's streamed rows against its
    seeked rows) fails the phase.  Across the runs all four kernels launch.
    Returns the launches of all runs, each run's output and the phase's
    seconds."""
    import importlib
    import io
    import os

    import torch

    t_phase = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    total = dict.fromkeys(kernel_counters(), 0)
    outputs = {}
    for tag, script, extra in MEASURES:
        argv = ["--device", str(dev), *extra]
        printed = io.StringIO()
        t0 = time.perf_counter()
        try:
            with counted() as launches, contextlib.redirect_stdout(printed):
                outputs[tag] = importlib.import_module(script).main(argv)
        finally:  # what the script printed, also when it failed
            for line in printed.getvalue().splitlines():
                log(f"[17 {tag}]   {line}")
        for k, v in launches.items():
            total[k] += v
        log(f"[17 {tag}] {script} {' '.join(extra)}: launches {launches}; card {card}; "
            f"{time.perf_counter() - t0:.1f} s")
    shared = outputs["mesh"]["shards_share_one_device"]
    check(shared == (torch.cuda.device_count() < 4), f"phase 17: shards_share_one_device is {shared}")
    check(all(v > 0 for v in total.values()), f"phase 17: a kernel never launched across the scripts: {total}")
    seconds = time.perf_counter() - t_phase
    log(f"[17] the measuring scripts took {seconds:.1f} s; launches {total}")
    return {"launches": total, "outputs": outputs, "seconds": seconds}


def bench(dev, card) -> dict:
    """Phase 18: scripts/torch_bench.py through its `main` on the card at
    bench.py's sizes, in-process and counted, every line it prints
    (stdout and stderr) logged.  A failed check in the bench fails the
    phase.  Returns the launches, the bench's JSON line and the phase's
    seconds."""
    import importlib
    import io
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    torch_bench = importlib.import_module("torch_bench")
    log(f"[18] bench.py's cells: {json.dumps(torch_bench.CARD)}")
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with counted() as launches, contextlib.redirect_stdout(printed), contextlib.redirect_stderr(printed):
            out = torch_bench.main(["--device", str(dev)])
    finally:  # what the bench printed, also when it failed
        for line in printed.getvalue().splitlines():
            log(f"[18]   {line}")
    seconds = time.perf_counter() - t0
    check(out["launches"] == launches, f"phase 18: the bench counted {out['launches']}, the phase {launches}")
    check(all(v > 0 for v in launches.values()), f"phase 18: a kernel never launched in the bench: {launches}")
    log(f"[18] torch_bench.py: launches {launches}; card {card}; {seconds:.1f} s")
    return {"launches": launches, "output": out, "seconds": seconds}


# phase 19: the trees' turns (each a subprocess of scripts/torch_transfer_ab.py)
TRANSFER_TURNS = ("parent", "tree", "tree", "parent")


def parent_tree() -> str | None:
    """The parent tree's root: `build/parent` where a caller unpacked it,
    else `git archive HEAD~1` unpacked there when the checkout has its
    history; None when neither is at hand."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "build", "parent")
    if os.path.isfile(os.path.join(path, "hsc_torch", "__init__.py")):
        return path
    if not os.path.isdir(os.path.join(here, ".git")):
        return None
    archive = subprocess.run(["git", "-C", here, "archive", "HEAD~1"], capture_output=True, timeout=60)
    if archive.returncode != 0:  # e.g. a clone of depth 1
        log(f"[19] git archive HEAD~1 failed: {archive.stderr.decode().strip()}")
        return None
    os.makedirs(path, exist_ok=True)
    subprocess.run(["tar", "-x", "-C", path], input=archive.stdout, check=True, timeout=60)
    return path


def transfers(card) -> None:
    """Phase 19: the corpus encode and decode of this tree against its
    parent's, through scripts/torch_transfer_ab.py (one subprocess per
    turn, its lines logged).  Fails on a run whose bytes differ from the
    serial path's, from another run's or from the other tree's; on a
    synchronizing call from the batch loops' files on this tree; on a
    pageable host copy in this tree's profiles."""
    import os

    import torch

    torch.cuda.empty_cache()  # the subprocesses share the card
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    parent = parent_tree()
    if parent is None:
        log("[19] no parent tree (no build/parent, no git history): this tree alone")
    runs = {"parent": [], "tree": []}
    for label in TRANSFER_TURNS if parent else ("tree",):
        cmd = [sys.executable, os.path.join(here, "scripts", "torch_transfer_ab.py"), "--label", label]
        if label == "parent":
            cmd += ["--root", parent]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        lines = proc.stdout.splitlines()
        for line in lines[:-1] if proc.returncode == 0 else lines:
            log(f"[19] {line}")
        check(proc.returncode == 0, f"phase 19: torch_transfer_ab.py --label {label} exited "
                                    f"{proc.returncode}: {proc.stderr[-3000:]}")
        runs[label].append(json.loads(lines[-1]))
    for name in ("flat", "hier"):
        cells = {label: [r[name] for r in rs] for label, rs in runs.items() if rs}
        got = {(c["container_sha256"], c["rows_sha256"]) for cs in cells.values() for c in cs}
        check(len(got) == 1, f"phase 19 {name}: containers or rows differ between runs or trees: {got}")
        for c in cells["tree"]:
            check(c["loop_file_syncs"] == 0, f"phase 19 {name}: this tree synchronized in the batch loops: "
                                             f"{c['encode_syncs']} {c['decode_syncs']}")
            for what, p in c["profile"].items():
                host = [k for k in p["copies"] if "HtoD" in k or "DtoH" in k]
                check(host and all("Pinned" in k for k in host),
                      f"phase 19 {name} {what}: host copies not all pinned: {p['copies']}")
        for label, cs in cells.items():
            enc = [v for c in cs for v in c["encode_mb_s"]]
            dec = [v for c in cs for v in c["decode_mb_s"]]
            idle = [round(100 * c["profile"][w]["idle"], 1) for c in cs for w in ("encode", "decode")]
            syncs = [sum(c[f"{w}_syncs"].values()) for c in cs for w in ("encode", "decode")]
            waits = [sum(c[f"{w}_event_waits"].values()) for c in cs for w in ("encode", "decode")]
            loop = [c["loop_file_syncs"] for c in cs]
            log(f"[19] {name} {label}: encode {stats(enc, 'MB/s', '.2f')}, decode {stats(dec, 'MB/s', '.2f')}; "
                f"syncs (encode, decode per run) {syncs}, of them from the batch loops' files {loop}; event "
                f"waits {waits}; device idle % (encode, decode per run) {idle}")
    log(f"[19] containers and rows the same in {sum(len(r) for r in runs.values())} runs x 3 repeats, "
        f"bitwise the serial path; card {card}; {time.perf_counter() - t0:.1f} s")


def flag_flips(dev, mld, xs, blob) -> None:
    """Phase 17b: the caller's TF32 flags move nothing.  With
    `cudnn.conv.fp32_precision = 'tf32'` and
    `torch.set_float32_matmul_precision('high')` set, a fresh
    CorpusEncoder writes phase 5's container for the flat flagship's 128
    blocks byte for byte, the init correlation of a 64-channel map (the
    flagship level 1's width, as an f32 hand-off, SP or TP feed it) is
    bitwise its IEEE value, and k-means at phase 13a's geometry gives the
    centroids it gives under IEEE flags, bit for bit; afterwards the flags
    read what was set.  The controls: outside `spec_numerics` the same
    64-channel conv and the k-means product do move under TF32, so the
    checks check something (cuDNN takes no TF32 path for the
    single-channel level-0 conv: it is unmoved either way)."""
    import torch
    import torch.nn.functional as F

    from hsc_torch.device import spec_numerics
    from hsc_torch.learn import kmeans_refine_device
    from hsc_torch.ops.correlate import correlate_bank_torch
    from hsc_torch.runtime import CorpusEncoder

    b = torch.backends
    m, d, k, iters = KMEANS
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(dev)
    cents = torch.from_numpy(rng.standard_normal((k, d)).astype(np.float32)).to(dev)
    cents = cents / torch.linalg.vector_norm(cents, dim=1, keepdim=True)
    fmap = torch.from_numpy(rng.standard_normal((4, 4096, 64)).astype(np.float32)).to(dev)
    bank = torch.from_numpy(rng.standard_normal((96, 65, 64)).astype(np.float32)).to(dev)

    def raw_conv():
        return F.conv1d(fmap.transpose(1, 2).contiguous(), bank.permute(0, 2, 1).contiguous())

    with spec_numerics():
        want_c = kmeans_refine_device(flat, cents, iterations=iters)[0]
        exact_conv, exact_mm = raw_conv(), flat @ cents.T
    want_s = correlate_bank_torch(fmap, bank)
    check(torch.equal(want_s, exact_conv), "the pinned correlation != the IEEE conv under default flags")
    legacy, conv = torch.get_float32_matmul_precision(), b.cudnn.conv.fp32_precision
    try:
        b.cudnn.conv.fp32_precision = "tf32"
        torch.set_float32_matmul_precision("high")
        flags = (b.cudnn.conv.fp32_precision, b.cuda.matmul.fp32_precision, b.cudnn.deterministic,
                 b.cudnn.benchmark)
        moved = {"conv": float((raw_conv() - exact_conv).abs().max()),
                 "matmul": float((flat @ cents.T - exact_mm).abs().max())}
        got_blob = CorpusEncoder(mld, device=dev).encode(xs)
        got_s = correlate_bank_torch(fmap, bank)
        got_c = kmeans_refine_device(flat, cents, iterations=iters)[0]
        torch.cuda.synchronize()
        after = (b.cudnn.conv.fp32_precision, b.cuda.matmul.fp32_precision, b.cudnn.deterministic,
                 b.cudnn.benchmark)
    finally:
        torch.set_float32_matmul_precision(legacy)
        b.cudnn.conv.fp32_precision = conv
    check(all(v > 0 for v in moved.values()), f"phase 17b: an unpinned op did not move under TF32: {moved}")
    check(got_blob == blob, "phase 17b: the container moved under the TF32 flags")
    check(torch.equal(got_s, want_s), "phase 17b: the 64-channel init correlation moved under the TF32 flags")
    check(torch.equal(got_c, want_c), "phase 17b: k-means centroids moved under the TF32 flags")
    check(after == flags and flags[:2] == ("tf32", "tf32"), f"phase 17b: flags {flags} read {after} after the run")
    log(f"[17b] TF32 flags (cudnn.conv {flags[0]}, cuda.matmul {flags[1]}): {len(xs)} flat-flagship blocks -> "
        f"phase 5's container byte for byte; a 64-channel init correlation (4 x 4096 x 64 against 96 x 65) and "
        f"k-means ({m} x {d}, {k} centroids, {iters} iterations) bitwise the IEEE runs; flags unchanged after "
        f"({after}); controls, outside the pinned scope: the conv off by {moved['conv']:.3g}, the k-means "
        f"product by {moved['matmul']:.3g}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch import _build
    from hsc_torch.ops import decode_integer_kernel, decode_kernel, mp_kernels
    from hsc_torch.ops.decode import mp_decode_integer_batch_torch
    from hsc_torch.ops.encode import encode_init_batched, mp_encode_from_init_torch, quantizer_steps
    from hsc_torch.params import level_params_from_mld
    from hsc_torch.io import unpack_corpus
    from hsc_torch.oracle.mp import (
        LevelStream,
        correlate_bank,
        mp_decode_integer,
        mp_encode,
        rep_quantize,
    )
    from hsc_torch.runtime import CorpusEncoder
    from hsc_torch.utils import snr_db

    # ---- 1. device and toolchain ------------------------------------------
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"[1] nvcc: {run([_build._nvcc(), '--version']).splitlines()[-1]}")
    dev = torch.device("cuda")

    # ---- 2. build ----------------------------------------------------------
    _build.load()
    log(f"[2] built {_build.library_path()} in {_build.BUILD_SECONDS:.1f} s")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[2]   {line.strip()}")

    cfg = make_test_config(**FLAGSHIP)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(N_BLOCKS, cfg.block_size, seed=3)
    params = level_params_from_mld(mld, 0, dev)
    bank, gram = mld.augmented(0), mld.gram(0)
    settings = dict(num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits)

    # ---- 3. greedy-loop kernel vs plain version vs oracle ------------------
    xb = xs[:BATCH].copy()
    xb[BATCH - 1] = 0.0  # an all-zero block emits nothing
    s0, e0, peak = encode_init_batched(torch.from_numpy(xb[:, :, None]).to(dev), params.bank)
    sc_np, iv_np = quantizer_steps(peak.cpu().numpy(), cfg.amp_bits)
    scale, inv = torch.from_numpy(sc_np).to(dev), torch.from_numpy(iv_np).to(dev)
    s0_host, e0_host = s0.cpu().numpy(), e0.cpu().numpy()
    # the init runs in full f32 (TF32 off): within 1e-5 of the peak of the
    # exact correlation — TF32 would miss by ~1e-3.  The oracle's float32
    # einsum goes through the host's BLAS, so it is logged beside, not held.
    for b in (0, 37):
        exact = exact_correlation(xb[b][:, None], bank)
        err = np.abs(s0_host[b] - exact)
        diff, spec_diff = float(err.max()), float(np.abs(correlate_bank(xb[b][:, None], bank) - exact).max())
        if diff > 1e-5 * float(peak[b]):
            k, t = np.unravel_index(int(err.argmax()), err.shape)
            log(f"[3] block {b}: init {s0_host[b, k, t]!r} at atom {k}, position {t}; exact {exact[k, t]!r}; "
                f"{int((err > 1e-5 * float(peak[b])).sum())} cells off; oracle einsum off exact by {spec_diff:.3g}")
        check(diff <= 1e-5 * float(peak[b]), f"init off the exact correlation by {diff:.3g} at block {b}")
        log(f"[3] init vs exact correlation, block {b}: max |diff| / peak = {diff / float(peak[b]):.3g} "
            f"(oracle float32 einsum: {spec_diff / float(peak[b]):.3g})")
    encodes = {}
    mp_err = 0.0
    for ns, tol in ((8, None), (1, None), (3, None), (8, 5.0)):
        kw = dict(settings, num_select=ns, tolerance_snr=tol)
        s0_k = s0.clone()  # the kernel updates its scores in place
        got = mp_kernels.mp_loop(s0_k, e0, scale, inv, params, **kw)
        ref = mp_encode_from_init_torch(s0, e0, scale, inv, params, **kw)
        torch.cuda.synchronize()
        check(torch.equal(s0.cpu(), torch.from_numpy(s0_host)), "the plain loop modified its scores0")
        check(not torch.equal(s0_k, s0), "mp_loop did not update its scores in place")
        check(fields_equal(got, ref), f"mp_encode kernel != plain at num_select={ns} tol={tol}")
        mp_err = max(mp_err, max_abs_diff(got, ref))
        check(int(got.count[BATCH - 1]) == 0, "all-zero block emitted events")
        for b in (0, 37):
            o = mp_encode(xb[b][:, None], bank, gram, scores0=s0_host[b], energy0=float(e0_host[b]),
                          num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, tolerance_snr=tol,
                          num_select=ns)
            n = int(got.count[b])
            check(n == o.positions.shape[0], f"oracle count {o.positions.shape[0]} != kernel {n} (ns={ns}, b={b})")
            for name, a in (("positions", got.positions), ("atoms", got.atoms), ("codes", got.codes)):
                check(np.array_equal(a[b, :n].cpu().numpy(), getattr(o, name)),
                      f"oracle {name} differ (ns={ns}, tol={tol}, b={b})")
        encodes[(ns, tol)] = got
        log(f"[3] mp_encode ns={ns} tol={tol}: kernel == plain bitwise (7 fields x {BATCH} blocks), "
            f"== oracle on 2 blocks; mean events {float(got.count.float().mean()):.1f}")
    enc = encodes[(8, None)]
    mp_err = max(mp_err, sweep_edge_cases(dev))

    # ---- 4. integer-decode kernel vs plain version vs oracle ---------------
    rep_q, step = params.rep_q, params.rep_step
    amp = torch.from_numpy((sc_np * np.float32(step)).astype(np.float32)).to(dev)
    dec_args = (enc.positions, enc.atoms, enc.codes, enc.count, amp, rep_q)
    got = decode_integer_kernel.mp_decode_integer_batch(*dec_args, n=cfg.block_size)
    ref = mp_decode_integer_batch_torch(*dec_args, n=cfg.block_size)
    check(torch.equal(got, ref), "int_decode kernel != plain")
    rep_np = rep_q.cpu().numpy()
    host = [a.cpu().numpy() for a in enc]
    for b in range(BATCH):
        n = int(host[3][b])
        st = LevelStream(host[0][b, :n], host[1][b, :n], host[2][b, :n], np.float32(sc_np[b]), 0.0, 0.0)
        check(got[b].cpu().numpy().tobytes() == mp_decode_integer(st, rep_np, step, cfg.block_size).tobytes(),
              f"int_decode != oracle at block {b}")
    # adversarial wrap: 512 max codes x max rep codes at one position
    wrap_rep = np.full((2, 32, 1), 4095, np.int32)
    wrap_rep[1] *= -1
    m = cfg.num_coefs[0]
    wpos = np.zeros((2, m), np.int32)
    wpos[1] = np.arange(m) % 97
    watm = np.stack([np.zeros(m, np.int32), np.arange(m, dtype=np.int32) % 2])
    wcds = np.full((2, m), 32767, np.int32)
    wcnt = np.array([m, m - 5], np.int32)
    wamp = np.array([2e-8, 3e-8], np.float32)
    t_args = [torch.from_numpy(a).to(dev) for a in (wpos, watm, wcds, wcnt, wamp, wrap_rep)]
    got_w = decode_integer_kernel.mp_decode_integer_batch(*t_args, n=cfg.block_size)
    check(torch.equal(got_w, mp_decode_integer_batch_torch(*t_args, n=cfg.block_size)),
          "int_decode kernel != plain on the wraparound batch")
    for b in range(2):
        st = LevelStream(wpos[b, :wcnt[b]], watm[b, :wcnt[b]], wcds[b, :wcnt[b]], np.float32(1), 0.0, 0.0)
        o = mp_decode_integer(st, wrap_rep, wamp[b], cfg.block_size)
        check(got_w[b].cpu().numpy().tobytes() == o.tobytes(), f"wraparound block {b} != oracle")
    check(bool((got_w[0] < 0).any()), "the wraparound batch did not wrap")
    dec_err = max_abs_diff([got, got_w], [ref, mp_decode_integer_batch_torch(*t_args, n=cfg.block_size)])
    edge_rep = np.random.default_rng(5).integers(-4095, 4096, (5, 2500, 1)).astype(np.int32)
    dec_err = max(dec_err, edge_decode_batch(
        dev, 4, "int_decode", decode_integer_kernel.mp_decode_integer_batch, mp_decode_integer_batch_torch,
        lambda st, n: mp_decode_integer(st, edge_rep, np.float32(1), n), edge_rep))
    log(f"[4] int_decode: kernel == plain == oracle bitwise on {BATCH} encoded blocks and a wrapping batch")

    # ---- 5. the main path, counted -----------------------------------------
    codec = CorpusEncoder(mld, device="cuda")
    mp_kernels.LAUNCHES = 0
    decode_integer_kernel.LAUNCHES = 0
    blob = codec.encode(xs)
    blob2 = codec.encode(xs)
    decoded = codec.decode(blob)
    launches = {"mp_encode": mp_kernels.LAUNCHES, "int_decode": decode_integer_kernel.LAUNCHES}
    log(f"[5] launches on the main path: {launches}")
    check(all(v > 0 for v in launches.values()), "a kernel of the main path was never launched")
    check(blob == blob2, "two encodes of one corpus gave different bytes")
    check(decoded.shape == (N_BLOCKS, cfg.block_size) and np.isfinite(decoded).all(), "bad decode output")
    hdr_cfg, blocks = unpack_corpus(blob)
    rep_o, step_o = rep_quantize(mld.representations(0)[:, :, None], hdr_cfg.rep_bits)
    check(hdr_cfg.decode_mode == "integer", "flagship did not resolve to integer decode")
    for b, streams in enumerate(blocks):
        (level, st), = streams
        check(decoded[b].tobytes() == mp_decode_integer(st, rep_o, step_o, cfg.block_size)[:, 0].tobytes(),
              f"main-path decode != oracle at block {b}")
    events = sum(int(s[0][1].positions.shape[0]) for s in blocks)
    snr = float(np.mean([snr_db(xs[b], decoded[b]) for b in range(N_BLOCKS)]))
    ratio = xs.nbytes / len(blob)
    log(f"[5] {N_BLOCKS} blocks -> {len(blob)} bytes: ratio {ratio:.2f}x, {events} events, "
        f"mean SNR {snr:.3f} dB; decode bitwise the oracle")

    # ---- 6. timing: plain and kernel in turns (P K K P ...), median [range] --
    kw8 = dict(settings, num_select=8)
    mp_k, mp_p = turns(
        lambda: fresh_ms(s0.clone, lambda s: mp_kernels.mp_loop(s, e0, scale, inv, params, **kw8), 3),
        lambda: fresh_ms(lambda: s0, lambda s: mp_encode_from_init_torch(s, e0, scale, inv, params, **kw8), 1),
        4)
    def int_decode():
        return decode_integer_kernel.mp_decode_integer_batch(*dec_args, n=cfg.block_size)

    # the kernel's device time (a CUDA graph of 20 launches) and the host
    # time per call (50 back-to-back calls), in turns with the plain version
    dec_k, dec_p = turns(lambda: (graph_ms(int_decode), cuda_ms(int_decode, 50)),
                         lambda: cuda_ms(lambda: mp_decode_integer_batch_torch(*dec_args, n=cfg.block_size), 10), 4)
    dec_dev, dec_host = [d for d, _ in dec_k], [h for _, h in dec_k]
    mb = N_BLOCKS * cfg.block_size * 4 / 1e6
    plain = CorpusEncoder(mld, device="cuda", backend="torch")
    check(plain.encode(xs) == blob, "backend='torch' container != backend='cuda' container")
    check(plain.decode(blob).tobytes() == decoded.tobytes(), "backend='torch' decode != backend='cuda' decode")
    enc_k, enc_p = turns(lambda: mb / wall_s(lambda: codec.encode(xs)),
                         lambda: mb / wall_s(lambda: plain.encode(xs)), 2)
    dc_k, dc_p = turns(lambda: mb / wall_s(lambda: codec.decode(blob)),
                       lambda: mb / wall_s(lambda: plain.decode(blob)), 4)
    mp_ms, mp_plain_ms = statistics.median(mp_k), statistics.median(mp_p)
    dec_ms, dec_dev_ms, dec_plain_ms = statistics.median(dec_host), statistics.median(dec_dev), statistics.median(dec_p)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = BATCH * -(-cfg.block_size // decode_kernel.TILE)
    check(ctas >= sms, f"a {BATCH}-block decode is {ctas} CTAs, fewer than the card's {sms} SMs")
    mp_bound = loop_bound(s0, params, enc)
    ev = int(enc.count.sum())
    dec_bound = card_bound(12 * ev + 8 * BATCH + 4 * (rep_q.numel() + got.numel()), 2 * ev * int(rep_q.shape[1]))
    log(f"[6] card {card}")
    log(f"[6] greedy loop, one {BATCH}-block batch (ns=8, {ev} events): kernel {stats(mp_k, 'ms')}, "
        f"plain {stats(mp_p, 'ms')}; bound {mp_bound['bound_ms']:.4f} ms by {mp_bound['bound_by']}")
    log(f"[6] integer decode, one {BATCH}-block batch ({ctas} CTAs on {sms} SMs): kernel device time "
        f"{stats(dec_dev, 'ms')} (CUDA graph of 20 launches), host time per call {stats(dec_host, 'ms')} "
        f"(50 back-to-back calls), plain {stats(dec_p, 'ms')}; bound {dec_bound['bound_ms']:.5f} ms by "
        f"{dec_bound['bound_by']}")
    log(f"[6] CorpusEncoder.encode, {N_BLOCKS} blocks, host wall: cuda {stats(enc_k, 'MB/s', '.2f')}, "
        f"torch {stats(enc_p, 'MB/s', '.2f')}")
    log(f"[6] CorpusEncoder.decode, {N_BLOCKS} blocks, host wall: cuda {stats(dc_k, 'MB/s', '.2f')}, "
        f"torch {stats(dc_p, 'MB/s', '.2f')}")
    log(f"[6] device-only rates: greedy loop {BATCH * cfg.block_size * 4 / 1e3 / mp_ms:.2f} MB/s, "
        f"integer decode {BATCH * cfg.block_size * 4 / 1e3 / dec_dev_ms:.2f} MB/s")
    x_dev = torch.from_numpy(xb[:, :, None]).to(dev)
    init_ms = cuda_ms(lambda: encode_init_batched(x_dev, params.bank), 5)
    log(f"[6] init (conv + energy + peak), one {BATCH}-block batch: {init_ms:.3f} ms")
    profs = {}
    for what, fn in (("encode", lambda: codec.encode(xs)), ("decode", lambda: codec.decode(blob))):
        line, profs[what] = profile_line(what, fn)
        log("[6] " + line)
    mp_dev_ms = kernel_ms(profs["encode"], "mp_encode_kernel")

    # the JSON line reports every kernel's launches on the hierarchical path
    # (phase 9), which runs all four; phase 5's counts were checked above
    hier_kernels, launches = hierarchy(dev, card)
    large_block(dev)
    deep_level0(dev)
    serving(dev, mld, xs, blob, decoded)
    learned = learning(dev, card, mld, xs)
    meshed = parallel(dev, card, mld, xs, blob, decoded)
    gated = gates(dev)
    experimented = experiments(dev, card)
    measured = measures(dev, card)
    flag_flips(dev, mld, xs, blob)
    benched = bench(dev, card)
    transfers(card)
    blind = blind_spots(dev, card)
    cards = multicard()

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hsc_tpu", "optax", "orbax"))
    check(not loaded, f"JAX, optax, orbax or the JAX package was imported: {loaded}")
    # no single PyTorch call computes the greedy loop or either decode's
    # event walk, so their library_ms is null
    kernels = [
        {"name": "mp_encode", "route": "cuda", "source": "hsc_torch/csrc/mp_encode.cu",
         "replaces": "hsc_tpu/ops/mp_kernels.py:83", "launches": launches["mp_encode"],
         "max_abs_err": mp_err, "ms": mp_ms, "device_ms": mp_dev_ms, "plain_ms": mp_plain_ms, **mp_bound,
         "library_ms": None},
        {"name": "int_decode", "route": "cuda", "source": "hsc_torch/csrc/int_decode.cu",
         "replaces": "hsc_tpu/ops/decode_integer_kernel.py:61", "launches": launches["int_decode"],
         "max_abs_err": dec_err, "ms": dec_ms, "device_ms": dec_dev_ms, "plain_ms": dec_plain_ms, **dec_bound,
         "library_ms": None},
        *hier_kernels,
    ]
    for row in kernels:  # phases 13's to 18's and 20's counts, beside the main path's
        row["launches_learning"] = learned["launches"][row["name"]]
        row["launches_mesh"] = meshed["launches"][row["name"]]
        row["launches_gates"] = gated["launches"][row["name"]]
        row["launches_experiments"] = experimented["launches"][row["name"]]
        row["launches_measure"] = measured["launches"][row["name"]]
        row["launches_bench"] = benched["launches"][row["name"]]
        row["launches_blind_spots"] = blind["launches"][row["name"]]
    log(f"[end] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"multicard": cards}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
