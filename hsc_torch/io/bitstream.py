"""Bit-packed stream format (v2) — the codec's on-disk contract.

The reference's entropy stage is *accounting only* (`hsc/analysis.py ::
calculateInformationRate(s)` computes bits/s but serializes nothing —
SURVEY.md §1 note).  BASELINE.json requires a real bitstream with bit-exact
decode, so this module defines it:

  corpus  := magic "HSCT" | u8 version=2 | u32 cfg_len | cfg JSON | u32 n_blocks
             | block*
  block   := u8 n_streams | stream*
  stream  := u8 level | u32 n_events | f32 scale | [u8 rice_k] | payload
  payload (entropy='fixed'): per event, MSB-first:
             position (pos_bits(level)) | atom (atom_bits(level)) |
             code+maxcode (amp_bits, unsigned offset)
  payload (entropy='rice'): events sorted by position (stable); per event:
             position-delta Rice-coded with parameter rice_k (quotient in
             unary — q ones then a zero — then k remainder bits; quotients
             >= 24 escape to 24 ones + a raw pos_bits value) | atom | amp
             fields as in 'fixed'

The decoder sums contributions in stream order (the bit-exactness surface —
see `hsc_tpu.oracle.mp.mp_decode`): selection order for 'fixed', position-
sorted order for 'rice' — both fully determined by the stream bytes.
Field widths are fully determined by the config in the header, so decode needs
no out-of-band information.  Packing is vectorized NumPy on the host
(SURVEY.md §7 H4 — variable-length streams do not fit XLA's static shapes; a
C++ packer drop-in lives in `native/` if host packing ever bottlenecks).

Version history (docs/FORMAT.md is the full spec):
  v1 — fixed/rice entropy, ordered float32 decode only.  (Round-1 docs
       loosely called the rice addition "v2"; the byte written was always 1 —
       entropy mode lives in the header config JSON, not the version byte.)
  v2 — header config gains decode_mode ('ordered' | 'integer') and rep_bits;
       'integer' is the order-free mod-2^32 reconstruction
       (`oracle.mp.mp_decode_integer`) that decodes on the MXU.  Event
       payloads are unchanged; v1 containers decode as before (missing
       config keys default to the v1 behavior).

The port's own copy of `hsc_tpu/io/bitstream.py`: the container bytes and
the NumPy spec depend on this code, so it is copied verbatim, quirks
included, and tests/test_torch_copies.py holds it equal to the original.
"""

from __future__ import annotations

import struct

import numpy as np

from ..config import CodecConfig
from ..oracle.mp import LevelStream
from . import native

MAGIC = b"HSCT"
VERSION = 2
SUPPORTED_VERSIONS = (1, 2)


def _pack_bits(values: np.ndarray, widths: list[int]) -> bytes:
    """Pack rows of unsigned field `values [n, nfields]` using `widths` bits
    per field, MSB-first, padded to a byte boundary.

    Dispatches to the native C++ packer (`native/bitpack.cpp` via
    `io.native`) when available; the NumPy path below is the byte-identical
    fallback and the semantic definition.
    """
    n = values.shape[0]
    if n == 0:
        return b""
    out = native.pack_events(values, widths)
    if out is not None:
        return out
    total = sum(widths)
    bits = np.zeros((n, total), dtype=np.uint8)
    col = 0
    for j, wbits in enumerate(widths):
        v = values[:, j].astype(np.uint64)
        for b in range(wbits):
            bits[:, col + b] = (v >> np.uint64(wbits - 1 - b)) & np.uint64(1)
        col += wbits
    flat = bits.reshape(-1)
    return np.packbits(flat).tobytes()


def _unpack_bits(data: bytes, n: int, widths: list[int]) -> np.ndarray:
    """Inverse of `_pack_bits`: returns `[n, nfields]` uint64."""
    total = sum(widths)
    if n == 0:
        return np.zeros((0, len(widths)), dtype=np.uint64)
    out = native.unpack_events(data, n, widths)
    if out is not None:
        return out
    flat = np.unpackbits(np.frombuffer(data, dtype=np.uint8), count=n * total)
    bits = flat.reshape(n, total)
    out = np.zeros((n, len(widths)), dtype=np.uint64)
    col = 0
    for j, wbits in enumerate(widths):
        v = np.zeros(n, dtype=np.uint64)
        for b in range(wbits):
            v = (v << np.uint64(1)) | bits[:, col + b].astype(np.uint64)
        out[:, j] = v
        col += wbits
    return out


_RICE_ESCAPE = 24  # unary quotients cap; above this, raw pos_bits follow

_RICE_HEAD_FMT = "<BIfB"  # level u8, n u32, scale f32, rice_k u8
RICE_HEADER_BYTES = struct.calcsize(_RICE_HEAD_FMT)


def stream_num_bytes(cfg: CodecConfig, level: int, n_events: int) -> int:
    """Exact serialized size of one 'fixed' stream (header + padded payload).
    ('rice' streams are variable-length: measure with len(pack_stream).)"""
    payload_bits = n_events * cfg.event_bits(level)
    return 1 + 4 + 4 + (payload_bits + 7) // 8


def _rice_k(
    cfg: CodecConfig, level: int, n_events: int, deltas: np.ndarray | None = None
) -> int:
    """Deterministic Rice parameter.

    With the sorted position deltas available, k is chosen by exact exhaustive
    search (the true payload size for every k <= pos_bits is a cheap
    vectorized sum — ties break to the smaller k); the decoder reads k from
    the stream header, so better choices are transparently compatible.
    Without deltas, the round-1 heuristic (~log2 of the mean delta)."""
    pb = cfg.pos_bits(level)
    if deltas is not None and n_events > 0:
        d = deltas.astype(np.int64)[None, :]  # [1, n]
        ks = np.arange(pb + 1, dtype=np.int64)[:, None]  # [pb+1, 1]
        q = d >> ks
        bits = np.where(q >= _RICE_ESCAPE, _RICE_ESCAPE + pb, q + 1 + ks)
        return int(np.argmin(bits.sum(axis=1)))
    npos = max(cfg.num_positions(level), 1)
    mean = max(npos // max(n_events, 1), 1)
    k = int(mean).bit_length() - 1
    return max(0, min(k, pb))


def _pack_rice(cfg: CodecConfig, level: int, stream: LevelStream) -> bytes:
    """Position-sorted, delta-Rice payload (entropy='rice').

    Dispatches to the native C++ coder (`native/bitpack.cpp ::
    hsc_pack_rice`) when available; the Python loop below is the
    byte-identical semantic definition."""
    n = int(stream.positions.shape[0])
    order = np.argsort(stream.positions, kind="stable")
    pos = stream.positions[order].astype(np.int64)
    atm = stream.atoms[order].astype(np.uint64)
    amp = (stream.codes[order].astype(np.int64) + cfg.amp_maxcode).astype(np.uint64)
    deltas = np.diff(pos, prepend=0)
    k = _rice_k(cfg, level, n, deltas)
    ab, pb, cb = cfg.atom_bits(level), cfg.pos_bits(level), cfg.amp_bits

    head = struct.pack(_RICE_HEAD_FMT, level, n, float(stream.scale), k)
    payload_native = native.pack_rice(pos, atm, amp, k, _RICE_ESCAPE, pb, ab, cb)
    if payload_native is not None:
        return head + payload_native

    chunks: list[np.ndarray] = []

    def put(value: int, width: int) -> None:
        if width:
            bits = (int(value) >> np.arange(width - 1, -1, -1)) & 1
            chunks.append(bits.astype(np.uint8))

    ones = np.ones(_RICE_ESCAPE, dtype=np.uint8)
    for i in range(n):
        d = int(deltas[i])
        q = d >> k
        if q >= _RICE_ESCAPE:
            chunks.append(ones)
            put(int(pos[i]), pb)  # escape: raw absolute position
        else:
            if q:
                chunks.append(ones[:q])
            chunks.append(np.zeros(1, dtype=np.uint8))
            put(d & ((1 << k) - 1) if k else 0, k)
        put(int(atm[i]), ab)
        put(int(amp[i]), cb)
    if not chunks:
        payload = b""
    else:
        payload = np.packbits(np.concatenate(chunks)).tobytes()
    return head + payload


class _BitReader:
    def __init__(self, data: bytes, off: int):
        self._bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8, offset=off))
        self._i = 0

    def _bit(self) -> int:
        if self._i >= self._bits.shape[0]:
            # same contract as the native coder: truncation is a ValueError
            raise ValueError("rice payload truncated")
        v = int(self._bits[self._i])
        self._i += 1
        return v

    def take(self, width: int) -> int:
        v = 0
        for _ in range(width):
            v = (v << 1) | self._bit()
        return v

    def unary(self, cap: int) -> int:
        q = 0
        while q < cap and self._bit() == 1:
            q += 1
        return q

    def consumed_bytes(self) -> int:
        return (self._i + 7) // 8


def _unpack_rice(
    cfg: CodecConfig, data: bytes, off: int
) -> tuple[int, LevelStream, int]:
    level, n, scale, k = struct.unpack_from(_RICE_HEAD_FMT, data, off)
    off += RICE_HEADER_BYTES
    if level >= cfg.num_levels:
        raise ValueError(f"stream level {level} out of range")
    ab, pb, cb = cfg.atom_bits(level), cfg.pos_bits(level), cfg.amp_bits
    # resource-bound sanity: every event costs at least 1 + ab + cb bits, so
    # a corrupt count cannot force a huge allocation or a long scan
    min_bits = n * (1 + ab + cb)
    if min_bits > 8 * (len(data) - off):
        raise ValueError(
            f"rice stream claims {n} events but only "
            f"{len(data) - off} bytes remain"
        )
    # bound the bit-reader's window by the worst-case stream length so
    # decoding block i of a large corpus does not unpack every later block
    max_bits = n * (_RICE_ESCAPE + pb + ab + cb)
    window = data[off : off + (max_bits + 7) // 8 + 1]
    decoded = native.unpack_rice(window, n, k, _RICE_ESCAPE, pb, ab, cb)
    if decoded is not None:
        vals, consumed = decoded
        return level, _validate_stream(cfg, level, LevelStream(
            positions=vals[:, 0].astype(np.int32),
            atoms=vals[:, 1].astype(np.int32),
            codes=(vals[:, 2].astype(np.int64) - cfg.amp_maxcode).astype(np.int32),
            scale=np.float32(scale), energy0=0.0, energy_res=0.0,
        )), off + consumed
    rd = _BitReader(data[: off + (max_bits + 7) // 8 + 1], off)
    positions = np.zeros(n, np.int32)
    atoms = np.zeros(n, np.int32)
    codes = np.zeros(n, np.int32)
    prev = 0
    for i in range(n):
        q = rd.unary(_RICE_ESCAPE)
        if q >= _RICE_ESCAPE:
            prev = rd.take(pb)
        else:
            prev = prev + ((q << k) | (rd.take(k) if k else 0))
        positions[i] = prev
        atoms[i] = rd.take(ab)
        codes[i] = rd.take(cb) - cfg.amp_maxcode
    off += rd.consumed_bytes()
    return level, _validate_stream(cfg, level, LevelStream(
        positions=positions, atoms=atoms, codes=codes,
        scale=np.float32(scale), energy0=0.0, energy_res=0.0,
    )), off


def _validate_stream(cfg: CodecConfig, level: int, stream: LevelStream) -> LevelStream:
    """Range-check decoded event fields against the config geometry.

    Bit-widths are ceil(log2(...)), so a corrupt (or hostile) payload can
    carry positions/atoms past the valid range while still parsing — and the
    decode kernels write at position-derived VMEM offsets, so out-of-range
    values must be rejected here, not downstream."""
    npos = cfg.num_positions(level)
    ka = cfg.counts_with_singletons[level]
    if stream.positions.size:
        pmax = int(stream.positions.max())
        pmin = int(stream.positions.min())
        if pmin < 0 or pmax >= npos:
            raise ValueError(
                f"corrupt stream: position {pmax if pmax >= npos else pmin} "
                f"outside [0, {npos}) at level {level}"
            )
        amax = int(stream.atoms.max())
        if amax >= ka:
            raise ValueError(
                f"corrupt stream: atom {amax} outside [0, {ka}) at level {level}"
            )
        # amp_bits codes span [0, 2^amp_bits) raw but the encoder only emits
        # biased values in [0, 2*maxcode]; a raw 2^amp_bits - 1 would decode
        # to maxcode + 1, outside anything in-spec arithmetic assumes
        cmax = int(stream.codes.max())
        cmin = int(stream.codes.min())
        if cmin < -cfg.amp_maxcode or cmax > cfg.amp_maxcode:
            raise ValueError(
                f"corrupt stream: code {cmax if cmax > cfg.amp_maxcode else cmin} "
                f"outside [-{cfg.amp_maxcode}, {cfg.amp_maxcode}] at level {level}"
            )
    return stream


def pack_stream(cfg: CodecConfig, level: int, stream: LevelStream) -> bytes:
    if cfg.entropy == "rice":
        return _pack_rice(cfg, level, stream)
    n = int(stream.positions.shape[0])
    maxcode = cfg.amp_maxcode
    widths = [cfg.pos_bits(level), cfg.atom_bits(level), cfg.amp_bits]
    vals = np.zeros((n, 3), dtype=np.uint64)
    vals[:, 0] = stream.positions.astype(np.uint64)
    vals[:, 1] = stream.atoms.astype(np.uint64)
    vals[:, 2] = (stream.codes.astype(np.int64) + maxcode).astype(np.uint64)
    head = struct.pack("<BIf", level, n, float(stream.scale))
    return head + _pack_bits(vals, widths)


def unpack_stream(cfg: CodecConfig, data: bytes, off: int) -> tuple[int, LevelStream, int]:
    """Returns (level, stream, new_offset)."""
    if cfg.entropy == "rice":
        return _unpack_rice(cfg, data, off)
    level, n, scale = struct.unpack_from("<BIf", data, off)
    off += struct.calcsize("<BIf")
    if level >= cfg.num_levels:
        raise ValueError(f"stream level {level} out of range")
    widths = [cfg.pos_bits(level), cfg.atom_bits(level), cfg.amp_bits]
    nbytes = (n * sum(widths) + 7) // 8
    if nbytes > len(data) - off:
        raise ValueError(
            f"stream claims {n} events but only {len(data) - off} bytes remain"
        )
    vals = _unpack_bits(data[off : off + nbytes], n, widths)
    off += nbytes
    maxcode = cfg.amp_maxcode
    stream = LevelStream(
        positions=vals[:, 0].astype(np.int32),
        atoms=vals[:, 1].astype(np.int32),
        codes=(vals[:, 2].astype(np.int64) - maxcode).astype(np.int32),
        scale=np.float32(scale),
        energy0=0.0,
        energy_res=0.0,
    )
    return level, _validate_stream(cfg, level, stream), off


def pack_corpus(
    cfg: CodecConfig,
    blocks: list[list[tuple[int, LevelStream]]],
    index: bool = False,
) -> bytes:
    """Serialize a corpus: `blocks[b]` is a list of (level, stream) pairs —
    normally one top-level stream per block; distributed representations may
    carry several levels.  `index=True` appends the seek-index footer using
    the offsets the packer already knows (no re-scan — `append_index` on an
    existing blob costs a header walk, which for 'rice' is a decode pass)."""
    cfg_json = cfg.to_json().encode()
    out = [MAGIC, struct.pack("<BI", VERSION, len(cfg_json)), cfg_json]
    out.append(struct.pack("<I", len(blocks)))
    off = sum(len(p) for p in out)
    offsets = np.empty(len(blocks) + 1, np.int64)
    for b, streams in enumerate(blocks):
        offsets[b] = off
        rec = [struct.pack("<B", len(streams))]
        for level, stream in streams:
            rec.append(pack_stream(cfg, level, stream))
        out.extend(rec)
        off += sum(len(p) for p in rec)
    offsets[len(blocks)] = off
    if index:
        out.append(_index_footer(offsets))
    return b"".join(out)


def peek_corpus_header(data: bytes) -> tuple[CodecConfig, int]:
    """Parse ONLY the container header: returns (config, n_blocks) without
    touching any stream payload — O(header) for arbitrarily large corpora
    (used to pre-size streaming decode outputs)."""
    cfg, n_blocks, _ = _parse_corpus_header(data)
    return cfg, n_blocks


def _parse_corpus_header(data: bytes) -> tuple[CodecConfig, int, int]:
    """Shared header parse: returns (config, n_blocks, offset of block 0)."""
    if data[:4] != MAGIC:
        raise ValueError("bad magic")
    version, cfg_len = struct.unpack_from("<BI", data, 4)
    if version not in SUPPORTED_VERSIONS:
        raise ValueError(f"unsupported version {version}")
    off = 4 + struct.calcsize("<BI")
    raw = data[off : off + cfg_len].decode()
    import json as _json

    d = _json.loads(raw)
    if "decode_mode" not in d:
        # container written before format v2 existed: v1 reconstruction is
        # stream-order float32 — never let the config default (auto ->
        # integer) reinterpret an old stream's arithmetic
        d["decode_mode"] = "ordered"
    cfg = CodecConfig.from_json(_json.dumps(d))
    off += cfg_len
    (n_blocks,) = struct.unpack_from("<I", data, off)
    return cfg, n_blocks, off + 4


def unpack_corpus(data: bytes) -> tuple[CodecConfig, list[list[tuple[int, LevelStream]]]]:
    cfg, n_blocks, off = _parse_corpus_header(data)
    if n_blocks > len(data) - off:  # every block costs >= 1 byte (n_streams)
        raise ValueError(
            f"corpus claims {n_blocks} blocks but only "
            f"{len(data) - off} bytes remain"
        )
    blocks = []
    for _ in range(n_blocks):
        streams, off = unpack_block(cfg, data, off)
        blocks.append(streams)
    return cfg, blocks


def iter_blocks(data: bytes):
    """Lazily yield each block's ``[(level, stream)]`` in container order —
    the streaming counterpart of `unpack_corpus` (one block's events in
    memory at a time; pair with an mmap'd container for O(1) footprint)."""
    cfg, n_blocks, off = _parse_corpus_header(data)
    for _ in range(n_blocks):
        streams, off = unpack_block(cfg, data, off)
        yield streams


def unpack_block(
    cfg: CodecConfig, data: bytes, off: int
) -> tuple[list[tuple[int, LevelStream]], int]:
    """Unpack ONE block record at byte offset `off` (the u8 n_streams byte):
    returns (streams, new_offset).  With a block offset (`scan_block_offsets`
    or the seek-index footer) this is the random-access decode entry — no
    preceding block is touched."""
    (n_streams,) = struct.unpack_from("<B", data, off)
    off += 1
    streams = []
    for _ in range(n_streams):
        level, stream, off = unpack_stream(cfg, data, off)
        streams.append((level, stream))
    return streams, off


def scan_block_offsets(data: bytes) -> tuple[CodecConfig, np.ndarray]:
    """Walk the container once and return (config, offsets) where
    ``offsets[b]`` is the byte offset of block b's record and ``offsets[-1]``
    is the end of the block region (= start of any trailing footer).

    'fixed' streams are skipped from their headers alone (payload size is a
    pure function of the event count — no event decoding); 'rice' payloads
    are variable-length with no recorded byte size, so skipping one costs a
    decode pass (native-coder fast, ~50 µs/1000 events).  Corpora that need
    many random accesses should carry the O(1) seek-index footer
    (`append_index`) instead of re-scanning."""
    cfg, n_blocks, off = _parse_corpus_header(data)
    offsets = np.empty(n_blocks + 1, np.int64)
    fixed = cfg.entropy != "rice"
    for b in range(n_blocks):
        offsets[b] = off
        (n_streams,) = struct.unpack_from("<B", data, off)
        off += 1
        for _ in range(n_streams):
            if fixed:
                level, n, _scale = struct.unpack_from("<BIf", data, off)
                if level >= cfg.num_levels:
                    raise ValueError(f"stream level {level} out of range")
                off += stream_num_bytes(cfg, level, n)
                if off > len(data):
                    raise ValueError("stream overruns the container")
            else:
                _level, _stream, off = unpack_stream(cfg, data, off)
    offsets[n_blocks] = off
    return cfg, offsets


# -- seek-index footer (optional, backward compatible) -----------------------
#
#   footer := "HSCI" | u32 n_blocks | u64 offsets[n_blocks + 1] | u32 crc32
#             | u32 footer_len | "HSCI"
#
# Appended AFTER the block region.  `unpack_corpus` reads exactly n_blocks
# records and ignores trailing bytes, so indexed containers decode everywhere
# a plain container does; readers that know the footer get O(1) block seeks
# (`read_index`), others fall back to `scan_block_offsets`.  The trailing
# (footer_len, magic) pair makes the footer discoverable from the file tail
# without knowing n_blocks; crc32 covers the offsets so a torn/corrupt footer
# degrades to a scan instead of mis-seeking.

INDEX_MAGIC = b"HSCI"
_INDEX_TAIL = struct.calcsize("<I") + 4  # footer_len + trailing magic


def _index_footer(offsets: np.ndarray) -> bytes:
    payload = struct.pack("<I", len(offsets) - 1) + offsets.astype(
        "<u8"
    ).tobytes()
    crc = _crc32(payload)
    footer = INDEX_MAGIC + payload + struct.pack("<I", crc)
    return footer + struct.pack("<I", len(footer) + _INDEX_TAIL) + INDEX_MAGIC


def append_index(blob: bytes) -> bytes:
    """Return `blob` with the seek-index footer appended (idempotent: an
    already-indexed container is returned unchanged).  Costs one header walk
    of the blob ('rice' payloads decode to find their ends) — when packing
    fresh, prefer `pack_corpus(..., index=True)`, which knows the offsets
    for free."""
    if read_index(blob) is not None:
        return blob
    _cfg, offsets = scan_block_offsets(blob)
    return blob + _index_footer(offsets)


def read_index(data: bytes) -> np.ndarray | None:
    """Parse the seek-index footer: block offsets ``[n_blocks + 1]`` i64, or
    None when the container carries no (intact) footer."""
    if len(data) < _INDEX_TAIL or bytes(data[-4:]) != INDEX_MAGIC:
        return None
    (footer_len,) = struct.unpack_from("<I", data, len(data) - _INDEX_TAIL)
    start = len(data) - footer_len
    if footer_len < _INDEX_TAIL + 12 or start < 0:
        return None
    if bytes(data[start : start + 4]) != INDEX_MAGIC:
        return None
    payload = data[start + 4 : len(data) - _INDEX_TAIL - 4]
    (crc,) = struct.unpack_from(
        "<I", data, len(data) - _INDEX_TAIL - 4
    )
    if _crc32(payload) != crc:
        return None
    (n_blocks,) = struct.unpack_from("<I", payload, 0)
    if len(payload) != 4 + 8 * (n_blocks + 1):
        return None
    offsets = np.frombuffer(payload, dtype="<u8", offset=4).astype(np.int64)
    return offsets


def _crc32(payload: bytes) -> int:
    import zlib

    return zlib.crc32(bytes(payload)) & 0xFFFFFFFF
