#!/usr/bin/env python3
"""Where the greedy-loop kernel's time goes, phase by phase, on an NVIDIA card.

    python3 scripts/torch_mp_loop_phases.py [variant.cu ...]

Builds `hsc_torch/csrc/mp_encode.cu` a second time with
-DHSC_MP_PHASE_CLOCKS (thread 0 of every CTA then adds up the cycles of the
first pass that builds the selection cache and of the sweep phases: A, C's
parallel gather, C's serial walk and D, each up to the barrier that ends it)
and runs it through `ops.mp_kernels.mp_loop` on one
64-block batch of each of the two loop geometries `chip_smoke.py` times: the
flat flagship (K=64, W=32, 512 coefficients) and level 1 of the flagship
hierarchy (K=96, W=65, 192 coefficients, the int8 init of a real level-0
encode), both at num_select=8.  For each it prints the kernel's time (CUDA
events, median of 5 launches on fresh copies of the scores), the sweeps per
block, and each phase's cycles per sweep and share of a block's cycles; the
shares times the kernel time give each phase's time.  Each `variant.cu`
given (another version of the kernel with the same C entry points) is built
and measured the same way, in turn, for comparisons within one run.  The
instrumented builds are used by nothing else.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_instrumented(src: str, tag: int):
    from hsc_torch import _build

    out = os.path.join(ROOT, "build", "mp_loop_phases")
    os.makedirs(out, exist_ok=True)
    lib_path = os.path.join(out, f"libmp_phases_{os.getpid()}_{tag}.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DHSC_MP_PHASE_CLOCKS", "-shared", "-o", lib_path, src],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for name in ("hsc_mp_encode", "hsc_mp_encode_workspace"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.hsc_mp_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.hsc_mp_phase_cycles.restype = ctypes.c_int
    lib.hsc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hsc_cuda_error_string.restype = ctypes.c_char_p
    return lib, [line.strip() for line in (proc.stdout + proc.stderr).splitlines() if "registers" in line]


def phases(lib, name, s0, e0, scale, inv, params, settings):
    import torch

    from hsc_torch import _build
    from hsc_torch.ops import mp_kernels

    _build._lib = lib  # mp_loop launches the instrumented build
    buf = (ctypes.c_ulonglong * 6)()
    ms = []
    for rep in range(6):
        s = s0.clone()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        enc = mp_kernels.mp_loop(s, e0, scale, inv, params, **settings)
        end.record()
        torch.cuda.synchronize()
        _build.check(lib, lib.hsc_mp_phase_cycles(ctypes.addressof(buf)), "hsc_mp_phase_cycles")
        if rep:  # the first launch warms up
            ms.append(start.elapsed_time(end))
            cycles = np.array(buf[:], dtype=np.float64)
    b = s0.shape[0]
    sweeps = cycles[5] / b
    block = cycles[:5].sum() / b
    kernel_ms = statistics.median(ms)
    print(f"{name}: kernel {kernel_ms:.4f} ms [{min(ms):.4f}..{max(ms):.4f}, n={len(ms)}], "
          f"{int(enc.count.sum())} events, {sweeps:.1f} sweeps per block, {block:.0f} cycles per block")
    for i, what in enumerate(("first pass", "A argmax", "C gather", "C walk", "D updates")):
        per = cycles[i] / b / (1 if i == 0 else sweeps)
        share = cycles[i] / b / block
        print(f"  {what:18s} {per:10.0f} cycles{' per sweep' if i else ''}  {100 * share:5.1f}%  "
              f"~{share * kernel_ms:.4f} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mp_loop_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
    from hsc_torch.ops.encode import encode_init_batched, quantizer_steps
    from hsc_torch.params import level_params_from_mld
    from hsc_torch.runtime import CorpusEncoder

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")

    def steps(peak):
        sc, iv = quantizer_steps(peak.cpu().numpy(), 16)
        return torch.from_numpy(sc).to(dev), torch.from_numpy(iv).to(dev)

    # level 1 of the flagship hierarchy: the int8 init of a real level-0 encode
    cfg2 = make_test_config(counts=(64, 32), scales=(32, 96), block_size=16384, num_coefs=(512, 192),
                            num_select=8)
    mld2 = MultilevelDictionary.generate(cfg2, seed=9)
    xs2 = SignalGenerator(mld2, rates=2e-3).generate_signals(64, cfg2.block_size, seed=5)
    coder = CorpusEncoder(mld2, device=dev).coder
    enc0 = coder.coders[0].mp.compute_coefficients_batch(torch.from_numpy(xs2).to(dev))
    mp1 = coder.coders[1].mp
    s0_1, e0_1, peak_1 = mp1.init_int_batched(*coder.handoff(0, enc0))
    # the flat flagship
    cfg = make_test_config(counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,), num_select=8)
    mld = MultilevelDictionary.generate(cfg, seed=7)
    xs = SignalGenerator(mld, rates=2e-3).generate_signals(64, cfg.block_size, seed=3)
    params = level_params_from_mld(mld, 0, dev)
    s0, e0, peak = encode_init_batched(torch.from_numpy(xs[:, :, None]).to(dev), params.bank)
    torch.cuda.synchronize()

    sources = [os.path.join(ROOT, "hsc_torch", "csrc", "mp_encode.cu"), *sys.argv[1:]]
    for tag, src in enumerate(sources):
        lib, ptxas = build_instrumented(src, tag)
        print(f"== {os.path.relpath(src, ROOT)}")
        for line in ptxas:
            print(f"instrumented build: {line}")
        phases(lib, "flat flagship (K=64, W=32)", s0, e0, *steps(peak), params,
               dict(num_coefs=512, amp_bits=16, num_select=8))
        phases(lib, "hierarchy level 1 (K=96, W=65)", s0_1, e0_1, *steps(peak_1), mp1.params, mp1.settings)
    return 0


if __name__ == "__main__":
    sys.exit(main())
