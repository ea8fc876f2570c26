"""ctypes binding for the batched block-record packer and unpackers
(hsc_torch/csrc/record_pack.cpp).

`pack_records` writes a batch's fixed-entropy top-form block records in one
native call into one buffer and slices them out, each byte-identical to
`runtime._emit_record(cfg, stream, False)`; `runtime.CorpusEncoder.
_emit_batched` takes it where every block would get that form.
`unpack_records` is the inverse for a decode chunk: the records at given
offsets of a container straight into the padded arrays of its decode
unit, equal to `io.bitstream.unpack_block` then `models.coder.pad_streams`;
`runtime.CorpusEncoder._chunks` takes it for fixed-entropy containers.
Where it gives up, `unpack_level_records` takes records of several levels
(the distributed form) into one padded array set per level, equal to
`unpack_block` then `CorpusEncoder._units`; where that gives up too, the
chunk unpacks block by block and pads the streams into the same arrays.
The library is compiled on demand with g++, cached under
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


class _LevelRows(ctypes.Structure):
    """`LevelRows` of csrc/record_pack.cpp: one level's geometry and
    capacity in, the number of its rows out, and where they go."""

    _fields_ = [
        ("pos_bits", ctypes.c_int32),
        ("atom_bits", ctypes.c_int32),
        ("num_positions", ctypes.c_int64),
        ("num_atoms", ctypes.c_int64),
        ("cap", ctypes.c_int32),
        ("rows", ctypes.c_int32),
    ] + [(name, ctypes.c_void_p) for name in ("pos", "atom", "code", "counts", "scales", "ids")]


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
    lib.hsc_unpack_level_records.argtypes = (
        [p, i64, p] + [i32] * 4 + [ctypes.POINTER(_LevelRows)]
    )
    lib.hsc_unpack_level_records.restype = i32
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


def unpack_level_records(cfg: CodecConfig, data, offsets, caps):
    """The decode units ``[(ids, level, (pos, atm, cds, cnt, scl))]`` of the
    blocks whose records start at `offsets` in `data` (read in place, as
    `unpack_records` reads it), from one native call: one unit a level held
    by some block, ascending, each holding the padded arrays ([rows,
    caps[level]] int32 three times, [rows] int32, [rows] float32) of the
    blocks that hold a stream of that level and those blocks' indices in
    `offsets` (a list, ascending).  Equal to `io.bitstream.unpack_block` of
    each then `runtime.CorpusEncoder._units`.  None where the library is not
    available, the entropy is not fixed, or a record's levels are not
    strictly ascending below ``cfg.num_levels``, or a stream holds more than
    its level's cap, runs past the buffer or fails a range check of
    `unpack_stream`: the caller then unpacks those blocks one by one."""
    lib = _load()
    if lib is None or cfg.entropy != "fixed":
        return None
    buf = np.frombuffer(data, np.uint8)
    offs = np.ascontiguousarray(offsets, np.int64)
    nb = offs.shape[0]
    levels = (_LevelRows * cfg.num_levels)()
    arrays = []
    for level, lv in enumerate(levels):
        events = np.empty((3, nb, caps[level]), np.int32)
        cnt = np.empty(nb, np.int32)
        scl = np.empty(nb, np.float32)
        ids = np.empty(nb, np.int32)
        lv.pos_bits, lv.atom_bits = cfg.pos_bits(level), cfg.atom_bits(level)
        lv.num_positions = cfg.num_positions(level)
        lv.num_atoms = cfg.counts_with_singletons[level]
        lv.cap = caps[level]
        lv.pos, lv.atom, lv.code = (e.ctypes.data for e in events)
        lv.counts, lv.scales, lv.ids = cnt.ctypes.data, scl.ctypes.data, ids.ctypes.data
        arrays.append((events, cnt, scl, ids))
    status = lib.hsc_unpack_level_records(
        buf.ctypes.data, buf.shape[0], offs.ctypes.data, nb,
        cfg.amp_bits, cfg.amp_maxcode, cfg.num_levels, levels,
    )
    if status:
        return None
    units = []
    for level, (lv, (events, cnt, scl, ids)) in enumerate(zip(levels, arrays)):
        r = lv.rows
        if r:
            units.append((ids[:r].tolist(), level, (events[0, :r], events[1, :r], events[2, :r], cnt[:r], scl[:r])))
    return units
