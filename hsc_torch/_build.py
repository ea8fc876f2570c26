"""Build-on-first-use of the port's CUDA kernels (`hsc_torch/csrc/*.cu`).

The same content-hashed idea as `hsc_tpu.io.native`: the sources and flags
are hashed, the library goes to ``build/hsc_torch_kernels/<hash>/`` at the
repository root, and a changed source can never load a stale binary.
`nvcc` compiles every source at once, one process each, and links one
shared library with a plain C interface, loaded with `ctypes` — no PyTorch
headers, so the build takes seconds.  There is no fallback: a missing
`nvcc` or a failed build raises.

Flags: ``sm_90a`` (Hopper), and ``-fmad=false`` so the compiler never
contracts a multiply and an add into one FMA — the codec's float32 spec
rounds every product and every sum (docs/DESIGN.md "Numerical
reproducibility"); the kernels also spell the roundings out with
``__fmul_rn``/``__fadd_rn``/``__fsub_rn``.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "hsc_torch_kernels")
_TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *_ARCH,
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
# what the last build printed (ptxas register / shared-memory report) and
# how long it took; empty when the library came from the build cache
BUILD_LOG = ""
BUILD_SECONDS = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # pointers, then ints/floats, then the stream; returns cudaError_t (the
    # workspace query returns bytes, or a cudaError_t negated)
    "hsc_mp_encode": [_P] * 11 + [_I] * 6 + [_F, _I, _F, _P, _P],
    "hsc_mp_encode_workspace": [_I] * 3,
    "hsc_int_decode": [_P] * 7 + [_I] * 5 + [_P],
    "hsc_int8_init": [_P] * 11 + [_F] + [_I] * 7 + [_P],
    "hsc_int8_init_workspace": [_I],
    "hsc_ordered_decode": [_P] * 7 + [_I] * 6 + [_P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists(_TOOLKIT_NVCC):
        path = _TOOLKIT_NVCC
    if path is None:
        raise RuntimeError(
            "nvcc not found: the hsc_torch CUDA kernels are built from "
            "hsc_torch/csrc on first use and need the CUDA toolkit"
        )
    return path


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], "libhsc_torch_kernels.so")


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed.  Raises on any failure."""
    global _lib, BUILD_LOG, BUILD_SECONDS
    if _lib is not None:  # the wrappers call this on every launch
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # build to a pid-suffixed name and rename: rename is atomic, so a
            # concurrent process never loads a half-written library
            tmp = f"{path}.tmp{os.getpid()}"
            t0 = time.perf_counter()
            nvcc = _nvcc()
            objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for src, obj in zip(_sources(), objs)
            ]
            logs = [p.communicate(timeout=600)[0] for p in procs]
            link = None
            if all(p.returncode == 0 for p in procs):
                link = subprocess.run(
                    [nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                    capture_output=True, text=True, timeout=600,
                )
                logs.append(link.stdout + link.stderr)
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
            BUILD_SECONDS = time.perf_counter() - t0
            BUILD_LOG = "".join(logs)
            if link is None or link.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.hsc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.hsc_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch(name: str, device, *args) -> None:
    """Call the C entry point `name` with `args` and the current stream of
    CUDA `device` (the kernel launches on that device), and raise if it
    returns an error."""
    import torch

    lib = load()
    # a device switch is host work on every call: only when needed
    same = device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, f"{name} launch")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.hsc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
