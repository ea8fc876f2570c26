"""The container format (v2, entropy 'fixed'): a frozen reader and writer.

A plain NumPy copy of what the benchmark needs of the port's
`hsc_torch/io/bitstream.py` and `runtime._join_container` (docs/FORMAT.md):

  corpus  := "HSCT" | u8 version=2 | u32 cfg_len | cfg JSON | u32 n_blocks
             | block* | [index footer]
  block   := u8 n_streams | stream*
  stream  := u8 level | u32 n_events | f32 scale | payload
  payload := per event, MSB-first: position | atom | code + maxcode
  footer  := "HSCI" | u32 n_blocks | u64 offsets[n_blocks + 1] | u32 crc32
             | u32 footer_len | "HSCI"

The writer makes the restore cell's container from events the benchmark
draws itself; the reader parses what the port wrote, for the reference to
judge.  Only the 'fixed' entropy mode is here: every configuration of the
benchmark states it.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from .config import CodecConfig

MAGIC = b"HSCT"
VERSION = 2
INDEX_MAGIC = b"HSCI"
_INDEX_TAIL = 8
_HEAD = "<BIf"
_HEAD_BYTES = struct.calcsize(_HEAD)


@dataclasses.dataclass
class Stream:
    """One level's events of one block, in stream order."""

    level: int
    positions: np.ndarray  # int64 [n]
    atoms: np.ndarray  # int64 [n]
    codes: np.ndarray  # int64 [n]
    scale: np.float32


def _widths(cfg: CodecConfig, level: int) -> list[int]:
    return [cfg.pos_bits(level), cfg.atom_bits(level), cfg.amp_bits]


def _bits(values: np.ndarray, widths: list[int]) -> np.ndarray:
    """``[..., n, fields]`` unsigned values -> ``[..., n * sum(widths)]``
    bits, each field MSB-first."""
    cols = []
    for j, w in enumerate(widths):
        v = values[..., j].astype(np.uint64)
        shifts = np.arange(w - 1, -1, -1, dtype=np.uint64)
        cols.append(((v[..., None] >> shifts) & np.uint64(1)).astype(np.uint8))
    bits = np.concatenate(cols, axis=-1)
    return bits.reshape(*bits.shape[:-2], -1)


def records_same_count(
    cfg: CodecConfig, level: int, positions, atoms, codes, scales
) -> np.ndarray:
    """Block records of ``B`` one-stream blocks that all hold ``n`` events
    (arrays ``[B, n]``, scales ``[B]``), packed at once -> ``[B, bytes]``
    uint8, every record the same length."""
    b, n = positions.shape
    vals = np.stack([positions, atoms, codes + cfg.amp_maxcode], axis=-1)
    payload = np.packbits(_bits(vals, _widths(cfg, level)), axis=-1)
    head = np.empty((b, 1 + _HEAD_BYTES), np.uint8)
    for i in range(b):
        head[i] = np.frombuffer(
            struct.pack("<B", 1) + struct.pack(_HEAD, level, n, float(scales[i])), np.uint8
        )
    return np.concatenate([head, payload], axis=1)


def index_footer(offsets: np.ndarray) -> bytes:
    payload = struct.pack("<I", len(offsets) - 1) + offsets.astype("<u8").tobytes()
    footer = INDEX_MAGIC + payload + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
    return footer + struct.pack("<I", len(footer) + _INDEX_TAIL) + INDEX_MAGIC


def header(cfg: CodecConfig, n_blocks: int) -> bytes:
    cfg_json = cfg.to_json().encode()
    return MAGIC + struct.pack("<BI", VERSION, len(cfg_json)) + cfg_json + struct.pack("<I", n_blocks)


def write_container(cfg: CodecConfig, records: np.ndarray, f) -> int:
    """Write header, the ``[B, bytes]`` records and the seek index to the
    open binary file `f`; returns the bytes written."""
    head = header(cfg, records.shape[0])
    size = records.shape[1]
    offsets = len(head) + size * np.arange(records.shape[0] + 1, dtype=np.int64)
    foot = index_footer(offsets)
    f.write(head)
    f.write(records.tobytes())
    f.write(foot)
    return len(head) + records.size + len(foot)


def parse_header(data) -> tuple[CodecConfig, int, int]:
    """(config, n_blocks, offset of block 0)."""
    if bytes(data[:4]) != MAGIC:
        raise ValueError("bad magic")
    version, cfg_len = struct.unpack_from("<BI", data, 4)
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    off = 4 + struct.calcsize("<BI")
    cfg = CodecConfig.from_json(bytes(data[off : off + cfg_len]).decode())
    off += cfg_len
    (n_blocks,) = struct.unpack_from("<I", data, off)
    return cfg, n_blocks, off + 4


def read_index(data) -> np.ndarray | None:
    """Block offsets ``[n_blocks + 1]`` from an intact footer, else None."""
    if len(data) < _INDEX_TAIL or bytes(data[-4:]) != INDEX_MAGIC:
        return None
    (footer_len,) = struct.unpack_from("<I", data, len(data) - _INDEX_TAIL)
    start = len(data) - footer_len
    if footer_len < _INDEX_TAIL + 12 or start < 0 or bytes(data[start : start + 4]) != INDEX_MAGIC:
        return None
    payload = bytes(data[start + 4 : len(data) - _INDEX_TAIL - 4])
    (crc,) = struct.unpack_from("<I", data, len(data) - _INDEX_TAIL - 4)
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        return None
    (n_blocks,) = struct.unpack_from("<I", payload, 0)
    if len(payload) != 4 + 8 * (n_blocks + 1):
        return None
    return np.frombuffer(payload, dtype="<u8", offset=4).astype(np.int64)


def read_block(cfg: CodecConfig, data, off: int) -> tuple[list[Stream], int]:
    """The streams of the block record at `off`, and the offset after it."""
    (n_streams,) = struct.unpack_from("<B", data, off)
    off += 1
    streams = []
    for _ in range(n_streams):
        level, n, scale = struct.unpack_from(_HEAD, data, off)
        off += _HEAD_BYTES
        if level >= cfg.num_levels:
            raise ValueError(f"stream level {level} out of range")
        widths = _widths(cfg, level)
        nbytes = (n * sum(widths) + 7) // 8
        if off + nbytes > len(data):
            raise ValueError("stream overruns the container")
        bits = np.unpackbits(np.frombuffer(bytes(data[off : off + nbytes]), np.uint8), count=n * sum(widths))
        bits = bits.reshape(n, sum(widths)).astype(np.int64)
        fields, col = [], 0
        for w in widths:
            weights = (1 << np.arange(w - 1, -1, -1, dtype=np.int64))
            fields.append(bits[:, col : col + w] @ weights)
            col += w
        off += nbytes
        streams.append(
            Stream(level, fields[0], fields[1], fields[2] - cfg.amp_maxcode, np.float32(scale))
        )
    return streams, off


def block_offsets(data) -> tuple[CodecConfig, np.ndarray]:
    """(config, offsets) by walking the stream headers ('fixed' payload
    sizes follow from the event counts)."""
    cfg, n_blocks, off = parse_header(data)
    offsets = np.empty(n_blocks + 1, np.int64)
    for b in range(n_blocks):
        offsets[b] = off
        (n_streams,) = struct.unpack_from("<B", data, off)
        off += 1
        for _ in range(n_streams):
            level, n, _ = struct.unpack_from(_HEAD, data, off)
            if level >= cfg.num_levels:
                raise ValueError(f"stream level {level} out of range")
            off += _HEAD_BYTES + (n * cfg.event_bits(level) + 7) // 8
            if off > len(data):
                raise ValueError("stream overruns the container")
    offsets[n_blocks] = off
    return cfg, offsets
