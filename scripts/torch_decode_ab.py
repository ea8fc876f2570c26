#!/usr/bin/env python3
"""Time both decode kernels of one tree of the port on an NVIDIA card, for
comparing two trees in one chip call.

    python3 scripts/torch_decode_ab.py [--root DIR] [--label NAME]
    python3 scripts/torch_decode_ab.py --variant "-DHSC_DECODE_RUN=16" [--variant ...]

`--root` is the tree whose `hsc_torch` is imported (default: this
repository); run a parent tree unpacked from `git archive` and this one in
turns (P C C P) in one call.  On one 64-block batch it times the integer
decode at the flat flagship (dictionary seed 7, signals seed 3, the events
of the greedy-loop kernel at num_select 8) and the ordered decode at the
flagship hierarchy's top streams (dictionary seed 9, signals seed 5, the
level-1 events), each as:

  - device time per call: 20 calls captured in one CUDA graph, replayed 10
    times between CUDA events (median and range of 5);
  - kernel time per launch in `torch.profiler` (10 back-to-back calls);
  - host time per call: 50 back-to-back calls between CUDA events (median
    and range of 5), which is the wrapper's cost once it outlasts the
    kernel;
  - device time per call as above with every block's count set to 0: the
    launch, the staging round trip and the stores of zeros, with no event
    work;

and each codec's `CorpusEncoder.decode` of 128 blocks (host wall, MB/s,
median and range of 5).  The last line is one JSON object with these
numbers and the card.

With `--variant`, it instead builds this tree's two decode sources once as
shipped and once per variant (each a string of nvcc flags, e.g. the tile
shape `-DHSC_DECODE_THREADS=128 -DHSC_DECODE_RUN=16` of
`hsc_torch/csrc/decode_tiles.cuh`) into libraries of their own, prints each
build's ptxas report, and prints each build's device time per call (CUDA
graph, median and range of 5, the builds in turns) and whether its rows are
bitwise the shipped build's.  The variant builds are used by nothing else.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_BLOCKS, BATCH, REPS = 128, 64, 5


def _smoke():
    """This repository's chip_smoke.py (its configurations and timing
    helpers), whatever tree `hsc_torch` comes from."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(flags: list[str], tag: int):
    """This tree's decode sources built with extra nvcc `flags` into a
    library of their own: an object the wrappers launch through (as
    `_build._lib`), and the build's ptxas report."""
    import ctypes
    import types

    from hsc_torch import _build

    out = os.path.join(ROOT, "build", "decode_variants")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, f"libdecode_{os.getpid()}_{tag}.so")
    srcs = [os.path.join(ROOT, "hsc_torch", "csrc", f) for f in ("int_decode.cu", "ordered_decode.cu")]
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", lib_path, *srcs],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with {flags}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for name in ("hsc_int_decode", "hsc_ordered_decode"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    # the wrappers' error check reads the message from the port's library
    entry = types.SimpleNamespace(hsc_int_decode=lib.hsc_int_decode, hsc_ordered_decode=lib.hsc_ordered_decode,
                                  hsc_cuda_error_string=_build.load().hsc_cuda_error_string)
    report = [line.strip() for line in (proc.stdout + proc.stderr).splitlines() if "registers" in line]
    return entry, report


def variants(smoke, calls: dict, flag_sets: list[str]) -> None:
    import torch

    from hsc_torch import _build

    shipped = _build.load()
    builds = [("shipped", *build([], 0))] + [(f, *build(f.split(), i + 1)) for i, f in enumerate(flag_sets)]
    for label, _, report in builds:
        print(f"== {label}: " + "; ".join(report), flush=True)
    times = {(label, name): [] for label, *_ in builds for name in calls}
    same = {}
    for _ in range(REPS):
        for label, lib, _ in builds:
            _build._lib = lib
            for name, call in calls.items():
                times[label, name].append(smoke.graph_ms(call))
                got = call()
                torch.cuda.synchronize()
                _build._lib = builds[0][1]
                ref = call()
                _build._lib = lib
                same[label, name] = same.get((label, name), True) and torch.equal(got.view(torch.int32),
                                                                                    ref.view(torch.int32))
    _build._lib = shipped
    for (label, name), t in times.items():
        print(f"{label} {name}: device {smoke.stats(t, 'ms', '.5f')} (graph); rows "
              f"{'bitwise the shipped build' if same[label, name] else 'DIFFER from the shipped build'}",
              flush=True)


def _summary(v: list[float]) -> dict:
    return {"median": statistics.median(v), "min": min(v), "max": max(v), "n": len(v)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="tree whose hsc_torch is imported")
    ap.add_argument("--label", default="change")
    ap.add_argument("--variant", action="append", default=[], help="nvcc flags of a variant build")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import hsc_torch
    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.ops import decode_integer_kernel, decode_kernel, init_kernels, mp_kernels
    from hsc_torch.ops.encode import encode_init_batched, quantizer_steps
    from hsc_torch.params import level_params_from_mld
    from hsc_torch.runtime import CorpusEncoder

    smoke = _smoke()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[{args.label}] hsc_torch from {os.path.dirname(hsc_torch.__file__)}; card {smi}", flush=True)

    # the flat flagship's events (chip_smoke.py phases 3-4)
    cfg = make_test_config(**smoke.FLAGSHIP)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(N_BLOCKS, cfg.block_size, seed=3)
    params = level_params_from_mld(mld, 0, dev)
    s0, e0, peak = encode_init_batched(torch.from_numpy(xs[:BATCH, :, None]).to(dev), params.bank)
    sc, iv = quantizer_steps(peak.cpu().numpy(), cfg.amp_bits)
    enc = mp_kernels.mp_loop(s0, e0, torch.from_numpy(sc).to(dev), torch.from_numpy(iv).to(dev), params,
                             num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, num_select=cfg.num_select)
    amp = torch.from_numpy((sc * np.float32(params.rep_step)).astype(np.float32)).to(dev)
    int_args = (enc.positions, enc.atoms, enc.codes, enc.count, amp, params.rep_q)
    codec = CorpusEncoder(mld, device=dev)
    blob = codec.encode(xs)

    # the flagship hierarchy's top streams (chip_smoke.py phases 7-8)
    hcfg = make_test_config(**smoke.HIER, decode_mode="ordered")
    hmld = MultilevelDictionary.generate(hcfg, seed=9)
    hxs = SignalGenerator(hmld, rates=2e-3).generate_signals(N_BLOCKS, hcfg.block_size, seed=5)
    hcodec = CorpusEncoder(hmld, device=dev)
    coder = hcodec.coder
    mp1 = coder.coders[1].mp
    enc0 = coder.coders[0].mp.compute_coefficients_batch(torch.from_numpy(hxs[:BATCH]).to(dev))
    *ev0, ps, n_map = coder.handoff(0, enc0)
    s0_1, e0_1, peak_1 = init_kernels.int8_init(*ev0, ps, mp1.bank_planes, mp1.bank_step, n_map=n_map,
                                                planes_cnw=mp1.init_planes)
    sc1, iv1 = quantizer_steps(peak_1.cpu().numpy(), hcfg.amp_bits)
    enc1 = mp1.loop_stage(s0_1, e0_1, sc1, iv1)
    ord_args = (enc1.positions, enc1.atoms, enc1.codes, enc1.count, enc1.scale, coder._rep_banks[1])
    hblob = hcodec.encode(hxs)
    torch.cuda.synchronize()

    calls = {"int_decode": lambda: decode_integer_kernel.mp_decode_integer_batch(*int_args, n=cfg.block_size),
             "ordered_decode": lambda: decode_kernel.mp_decode_batch(*ord_args, n=hcfg.block_size)}
    no_events = torch.zeros_like(enc.count)
    empty_calls = {
        "int_decode": lambda: decode_integer_kernel.mp_decode_integer_batch(
            *int_args[:3], no_events, *int_args[4:], n=cfg.block_size),
        "ordered_decode": lambda: decode_kernel.mp_decode_batch(*ord_args[:3], no_events, *ord_args[4:],
                                                                n=hcfg.block_size)}
    if args.variant:
        variants(smoke, calls, args.variant)
        return 0
    result = {"label": args.label, "card": smi}
    mb = N_BLOCKS * cfg.block_size * 4 / 1e6
    for (name, call), codec_, blob_ in zip(calls.items(), (codec, hcodec), (blob, hblob)):
        host = [smoke.cuda_ms(call, 50) for _ in range(REPS)]
        prof = smoke.device_profile(lambda: [call() for _ in range(10)],
                                    f"build/decode_ab/trace_{args.label}_{name}.json")
        keys = list(prof["by_name"])  # the calls launch nothing but their kernel
        profiled = sum(prof["by_name"].values()) / sum(prof["n_by_name"].values())
        rates = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            codec_.decode(blob_)
            torch.cuda.synchronize()
            rates.append(mb / (time.perf_counter() - t0))
        # last: a wrapper that sets a function attribute per call may not be
        # capturable, and then only the profile gives its device time
        try:
            device = [smoke.graph_ms(call) for _ in range(REPS)]
            empty = [smoke.graph_ms(empty_calls[name]) for _ in range(REPS)]
        except RuntimeError as e:
            print(f"[{args.label}] {name}: no CUDA graph ({e})", flush=True)
            device = empty = None
        result[name] = {"device_ms": device and _summary(device), "empty_device_ms": empty and _summary(empty),
                        "profiled_kernel_ms": profiled, "kernels": keys, "host_ms": _summary(host),
                        "decode_mb_s": _summary(rates)}
        graph = (f"{smoke.stats(device, 'ms', '.5f')} (graph; no events: {smoke.stats(empty, 'ms', '.5f')})"
                 if device else "not measured")
        print(f"[{args.label}] {name}: device {graph}, profiled kernel {profiled:.5f} ms, "
              f"host per call {smoke.stats(host, 'ms', '.5f')}; CorpusEncoder.decode "
              f"{smoke.stats(rates, 'MB/s', '.2f')}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
