"""ctypes binding for the batched block-record packer and unpacker
(hsc_torch/csrc/record_pack.cpp).

`pack_records` writes a batch's fixed-entropy top-form block records in one
native call into one buffer and slices them out, each byte-identical to
`runtime._emit_record(cfg, stream, False)`; `runtime.CorpusEncoder.
_emit_batched` takes it where every block would get that form.
`unpack_records` is the inverse for a decode chunk: the records at given
offsets of a container straight into the padded arrays of its decode
unit, equal to `io.bitstream.unpack_block` then `models.coder.pad_streams`;
`runtime.CorpusEncoder._chunks` takes it for fixed-entropy containers, and
where it gives up unpacks block by block and pads the streams into the
same arrays.  The library is compiled on demand with g++, cached under
``build/hsc_torch_record_pack/`` at the repository root keyed on a hash of
the source, as `io.native` builds `csrc/bitpack.cpp`.  When g++ is
missing, the build fails or ``HSC_TPU_NO_NATIVE`` is set, `available()` is
False and the encoder packs, and the decode unpacks, block by block.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from .config import CodecConfig

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "csrc", "record_pack.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hsc_torch_record_pack")

# widest event (position + atom + amplitude bits) the native loop packs
MAX_EVENT_BITS = 64
# bytes of a record before its payload: n_streams, level, n, scale
RECORD_HEADER_BYTES = 10

_lib = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"librecordpack-{digest}.so")


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
            # a pid-suffixed temp renamed into place, so no concurrent
            # build loads a half-written library
            tmp = f"{path}.tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.SubprocessError):
        return None
    p = ctypes.c_void_p
    i32 = ctypes.c_int32
    lib.hsc_pack_records.argtypes = [p] * 5 + [i32] * 6 + [p, p]
    lib.hsc_pack_records.restype = ctypes.c_int64
    i64 = ctypes.c_int64
    lib.hsc_unpack_records.argtypes = (
        [p, i64, p] + [i32] * 6 + [i64, i64, i32] + [p] * 5
    )
    lib.hsc_unpack_records.restype = i32
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def event_bits_ok(cfg: CodecConfig, level: int) -> bool:
    """Whether the native loop packs events of `level` (at most 64 bits)."""
    return cfg.event_bits(level) <= MAX_EVENT_BITS


def pack_records(cfg: CodecConfig, level: int, streams) -> list[bytes]:
    """Block records (``u8 1`` then the level's fixed-entropy stream) of
    `streams`, in order, from one native call.  The streams' positions,
    atoms and codes are read as int32.  Requires `available()` and
    `event_bits_ok(cfg, level)`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native record packer is not available")
    nb = len(streams)
    if nb == 0:
        return []
    counts = np.fromiter((len(s.positions) for s in streams), np.int32, nb)
    if not (
        np.array_equal(counts, np.fromiter((len(s.atoms) for s in streams), np.int32, nb))
        and np.array_equal(counts, np.fromiter((len(s.codes) for s in streams), np.int32, nb))
    ):
        raise ValueError("a stream's positions, atoms and codes differ in length")
    scales = np.fromiter((s.scale for s in streams), np.float32, nb)
    pos = np.concatenate([s.positions for s in streams], dtype=np.int32)
    atom = np.concatenate([s.atoms for s in streams], dtype=np.int32)
    code = np.concatenate([s.codes for s in streams], dtype=np.int32)
    ebits = cfg.event_bits(level)
    out = np.empty(
        RECORD_HEADER_BYTES * nb + (pos.shape[0] * ebits + 7 * nb) // 8, np.uint8
    )
    offsets = np.empty(nb + 1, np.int64)
    total = lib.hsc_pack_records(
        pos.ctypes.data, atom.ctypes.data, code.ctypes.data,
        counts.ctypes.data, scales.ctypes.data, nb, level,
        cfg.pos_bits(level), cfg.atom_bits(level), cfg.amp_bits, cfg.amp_maxcode,
        offsets.ctypes.data, out.ctypes.data,
    )
    if total < 0:
        raise ValueError(f"cannot pack {ebits}-bit events natively")
    blob = out[:total].tobytes()
    ends = offsets.tolist()
    return [blob[ends[b] : ends[b + 1]] for b in range(nb)]


def unpack_records(cfg: CodecConfig, level: int, data, offsets, cap: int):
    """The padded decode arrays ``(pos, atm, cds, cnt, scl)`` ([B, cap]
    int32 three times, [B] int32, [B] float32) of the blocks whose records
    start at `offsets` in `data` (bytes, an mmap or any buffer, read in
    place), from one native call: equal to `io.bitstream.unpack_block` of
    each then `models.coder.pad_streams(streams, cap)`.  None where the
    library is not available, or a record is not one fixed-entropy stream
    of `level`, holds more than `cap` events, runs past the buffer or fails
    a range check of `unpack_stream`: the caller then unpacks those blocks
    one by one, which raises the per-block error."""
    lib = _load()
    if lib is None or cfg.entropy != "fixed":
        return None
    # a view for the call alone: an mmap with a view open cannot close
    buf = np.frombuffer(data, np.uint8)
    offs = np.ascontiguousarray(offsets, np.int64)
    nb = offs.shape[0]
    events = np.empty((3, nb, cap), np.int32)
    cnt = np.empty(nb, np.int32)
    scl = np.empty(nb, np.float32)
    status = lib.hsc_unpack_records(
        buf.ctypes.data, buf.shape[0], offs.ctypes.data, nb, level,
        cfg.pos_bits(level), cfg.atom_bits(level), cfg.amp_bits, cfg.amp_maxcode,
        cfg.num_positions(level), cfg.counts_with_singletons[level], cap,
        events[0].ctypes.data, events[1].ctypes.data, events[2].ctypes.data,
        cnt.ctypes.data, scl.ctypes.data,
    )
    if status:
        return None
    return events[0], events[1], events[2], cnt, scl
