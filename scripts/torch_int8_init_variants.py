#!/usr/bin/env python3
"""Time versions of the int8-init kernels against each other on an NVIDIA card.

    python3 scripts/torch_int8_init_variants.py [variant.cu ...]

Builds `hsc_torch/csrc/sparse_init.cu` and each `variant.cu` given (another
version of the kernels with the same C entry point `hsc_int8_init`) into
libraries of their own, prints each build's ptxas report (registers,
shared memory, spills), and runs each through `ops.init_kernels.int8_init`
on the level-0 events of one real 64-block encode at the flagship hierarchy
of `bench.py:257-262` (dictionary seed 9, signals seed 5; level 1 scores 96
atoms of width 65 at 16289 positions).  For each it prints the time of one
call (CUDA events, median and range of 5 runs of 10 calls, the builds in
turns) and whether the score buffer and the peak are bitwise the shipped
build's.  The variant builds are used by nothing else.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(src: str, tag: int):
    from hsc_torch import _build

    out = os.path.join(ROOT, "build", "int8_init_variants")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, f"libint8_init_{os.getpid()}_{tag}.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib_path, src],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.hsc_int8_init.argtypes = _build._SIGNATURES["hsc_int8_init"]
    lib.hsc_int8_init.restype = ctypes.c_int
    # the wrapper's workspace query is the variant's where it has one, and
    # its error check reads the message from the port's library
    try:
        workspace = lib.hsc_int8_init_workspace
        workspace.argtypes = _build._SIGNATURES["hsc_int8_init_workspace"]
        workspace.restype = ctypes.c_int
    except AttributeError:
        workspace = _build.load().hsc_int8_init_workspace
    entry = types.SimpleNamespace(hsc_int8_init=lib.hsc_int8_init, hsc_int8_init_workspace=workspace,
                                  hsc_cuda_error_string=_build.load().hsc_cuda_error_string)
    report = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if "registers" in line or "spill" in line or "Function properties" in line]
    return entry, report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_int8_init_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from hsc_torch import MultilevelDictionary, SignalGenerator, _build, make_test_config
    from hsc_torch.ops import init_kernels
    from hsc_torch.runtime import CorpusEncoder

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    cfg = make_test_config(counts=(64, 32), scales=(32, 96), block_size=16384, num_coefs=(512, 192),
                           num_select=8)
    mld = MultilevelDictionary.generate(cfg, seed=9)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(64, cfg.block_size, seed=5)
    coder = CorpusEncoder(mld, device=dev).coder
    enc0 = coder.coders[0].mp.compute_coefficients_batch(torch.from_numpy(xs).to(dev))
    mp1 = coder.coders[1].mp
    *events, ps, n_map = coder.handoff(0, enc0)

    def call():
        return init_kernels.int8_init(*events, ps, mp1.bank_planes, mp1.bank_step, n_map=n_map,
                                      planes_cnw=mp1.init_planes)

    sources = [os.path.join(ROOT, "hsc_torch", "csrc", "sparse_init.cu"), *sys.argv[1:]]
    libs = []
    for tag, src in enumerate(sources):
        lib, report = build(src, tag)
        libs.append(lib)
        print(f"== {os.path.relpath(src, ROOT)}")
        for line in report:
            print(f"   {line}")
    _build._lib = libs[0]
    ref = call()
    torch.cuda.synchronize()
    times = [[] for _ in libs]
    for _ in range(5):
        for i, lib in enumerate(libs):
            _build._lib = lib
            call()  # warm
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            torch.cuda.synchronize()
            times[i].append(start.elapsed_time(end) / 10)
    for src, lib, t in zip(sources, libs, times):
        _build._lib = lib
        got = call()
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in ((got[0], ref[0]), (got[2], ref[2])))
        print(f"{os.path.relpath(src, ROOT)}: {statistics.median(t):.4f} ms [{min(t):.4f}..{max(t):.4f}, n={len(t)}]; "
              f"scores and peak {'bitwise the shipped build' if same else 'DIFFER from the shipped build'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
