"""ctypes bindings for the native C++ bit packer (hsc_torch/csrc/bitpack.cpp).

Compiled on demand with g++.  The build cache is keyed on a hash of the
source (build/hsc_torch_bitpack/libhscbitpack-<hash>.so at the repository
root, which .gitignore lists), so a stale or foreign binary can never shadow
a changed bitpack.cpp — mtimes are meaningless after a git checkout.  Every
call site falls back to the vectorized-NumPy packer when the toolchain is
unavailable (set HSC_TPU_NO_NATIVE=1 to force the fallback); both give the
same bytes.

The port's own copy of `hsc_tpu/io/native.py` (and of `native/bitpack.cpp`):
only the source and build paths differ, and tests/test_torch_copies.py holds
the packed bytes equal to the original's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "bitpack.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hsc_torch_bitpack")

_lib = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libhscbitpack-{digest}.so")


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("HSC_TPU_NO_NATIVE"):
        return None
    try:
        path = _lib_path()
        if not os.path.exists(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            # compile to a pid-suffixed temp and rename into place: rename
            # is atomic, so concurrent builders (multihost encode on a
            # shared filesystem) can never dlopen a half-written library
            tmp = f"{path}.tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.hsc_pack_events.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.hsc_unpack_events.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.hsc_pack_rice.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.hsc_pack_rice.restype = ctypes.c_int64
        lib.hsc_unpack_rice.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.hsc_unpack_rice.restype = ctypes.c_int64
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def pack_events(values: np.ndarray, widths: list[int]) -> bytes | None:
    """Native MSB-first pack; None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = values.shape[0]
    total = sum(widths)
    out = np.zeros((n * total + 7) // 8, dtype=np.uint8)
    if n:
        vals = np.ascontiguousarray(values, dtype=np.uint64)
        w = np.asarray(widths, dtype=np.int32)
        lib.hsc_pack_events(
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(n),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(len(widths)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
    return out.tobytes()


def pack_rice(
    pos: np.ndarray,
    atoms: np.ndarray,
    amps: np.ndarray,
    k: int,
    escape: int,
    pb: int,
    ab: int,
    cb: int,
) -> bytes | None:
    """Native Rice payload pack (events pre-sorted by position); None if the
    native library is unavailable.  Byte-identical to bitstream._pack_rice's
    Python loop (the semantic definition)."""
    lib = _load()
    if lib is None:
        return None
    n = int(pos.shape[0])
    out = np.zeros((n * (escape + pb + ab + cb) + 7) // 8 + 1, dtype=np.uint8)
    if n == 0:
        return b""
    p = np.ascontiguousarray(pos, dtype=np.int64)
    at = np.ascontiguousarray(atoms, dtype=np.uint64)
    am = np.ascontiguousarray(amps, dtype=np.uint64)
    nbytes = lib.hsc_pack_rice(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        at.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        am.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(n),
        ctypes.c_int32(k), ctypes.c_int32(escape),
        ctypes.c_int32(pb), ctypes.c_int32(ab), ctypes.c_int32(cb),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out[:nbytes].tobytes()


def unpack_rice(
    data: bytes, n: int, k: int, escape: int, pb: int, ab: int, cb: int
) -> tuple[np.ndarray, int] | None:
    """Native Rice payload unpack -> (vals [n, 3] uint64 of (absolute
    position, atom, raw amplitude), consumed bytes); None if unavailable.
    Raises ValueError on a truncated buffer."""
    lib = _load()
    if lib is None:
        return None
    vals = np.zeros((n, 3), dtype=np.uint64)
    if n == 0:
        return vals, 0
    buf = np.frombuffer(data, dtype=np.uint8)
    consumed = lib.hsc_unpack_rice(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.shape[0]), ctypes.c_int64(n),
        ctypes.c_int32(k), ctypes.c_int32(escape),
        ctypes.c_int32(pb), ctypes.c_int32(ab), ctypes.c_int32(cb),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if consumed < 0:
        raise ValueError("rice payload truncated")
    return vals, int(consumed)


def unpack_events(data: bytes, n: int, widths: list[int]) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = np.zeros((n, len(widths)), dtype=np.uint64)
    if n:
        buf = np.frombuffer(data, dtype=np.uint8)
        w = np.asarray(widths, dtype=np.int32)
        lib.hsc_unpack_events(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n),
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(len(widths)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
    return out
