"""Corpus encode/decode runtime — counterpart of `hsc_tpu.runtime`.

`CorpusEncoder` runs the codec's main path: batches of blocks through the
pipelined device encode (CUDA kernels on a card), host bit-packing into the
container format (`io.bitstream`, the port's copy), and the batched integer
decode.  The host code is copied from `hsc_tpu.runtime`, because the
container bytes depend on it: a container written here is byte-identical to
the JAX package's for the same streams.

It covers every hierarchy depth, both decode modes, and the top-only and
distributed (`oracle.mp.to_distributed`) container forms.  The journal,
constant-bitrate mode, meshes, the seek index and random-access decode
raise `NotImplementedError` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import struct
from collections import deque
from itertools import islice

import numpy as np

from .config import CodecConfig
from .dictionary import MultilevelDictionary
from .io.bitstream import MAGIC, VERSION, iter_blocks, pack_stream, peek_corpus_header
from .models.coder import HierarchicalConvolutionalSparseCoder, level_streams, to_host
from .ops.pipeline import encode_batches_pipelined, encode_hierarchical_batches_pipelined
from .oracle.mp import LevelStream, to_distributed


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, {item!r})")


def _join_container(cfg: CodecConfig, records, n_blocks: int) -> bytes:
    """Assemble header + block records (`hsc_tpu.runtime._join_container`
    without the seek-index footer)."""
    cfg_json = cfg.to_json().encode()
    parts = [
        MAGIC,
        struct.pack("<BI", VERSION, len(cfg_json)),
        cfg_json,
        struct.pack("<I", n_blocks),
    ]
    parts.extend(records)
    return b"".join(parts)


class CorpusEncoder:
    """End-to-end corpus codec around a HierarchicalConvolutionalSparseCoder."""

    def __init__(
        self,
        mld: MultilevelDictionary,
        *,
        device,
        backend: str = "auto",
        batch_size: int = 64,
        journal_dir: str | None = None,
        mesh=None,
        distributed: bool = False,
        target_bps: float | None = None,
    ):
        for value, what, item in (
            (journal_dir, "journal_dir (resumable encode)", "Runtime and CLI"),
            (target_bps, "target_bps (constant-bitrate mode)", "Runtime and CLI"),
            (mesh, "mesh (data-parallel encode/decode)", "Parallel"),
        ):
            if value is not None:
                raise _not_ported(what, item)
        self.mld = mld
        self.cfg: CodecConfig = mld.config
        self.coder = HierarchicalConvolutionalSparseCoder(mld, backend=backend, device=device)
        self.device = self.coder.device
        self.batch_size = int(batch_size)
        # emit the distributed representation (each event stored at the
        # level where its atom is raw) instead of the top-level-only stream
        self.distributed = bool(distributed)

    # -- encode -------------------------------------------------------------

    def _pack_block(self, top_stream) -> bytes:
        """Pack one block, no rate control
        (`hsc_tpu.runtime.CorpusEncoder._pack_block_raw`)."""
        top = self.cfg.num_levels - 1
        if self.distributed and self.cfg.num_levels > 1:
            parts = to_distributed(self.cfg, top_stream)
            return struct.pack("<B", len(parts)) + b"".join(
                pack_stream(self.cfg, level, s) for level, s in parts
            )
        return struct.pack("<B", 1) + pack_stream(self.cfg, top, top_stream)

    def _validate_blocks(self, blocks) -> np.ndarray:
        blocks = np.asarray(blocks, dtype=np.float32)
        if blocks.ndim != 2 or blocks.shape[1] != self.cfg.block_size:
            raise ValueError(
                f"blocks must be [B, {self.cfg.block_size}]; got {blocks.shape}"
            )
        return blocks

    def encode(self, blocks: np.ndarray, index: bool = False) -> bytes:
        """Encode ``[B, block_size]`` into the container format."""
        if index:
            raise _not_ported("index=True (the seek-index footer)", "Runtime and CLI")
        blocks = self._validate_blocks(blocks)
        nb = blocks.shape[0]
        payloads: dict[int, bytes] = {}
        self._compute_payloads(blocks, list(range(nb)), payloads)
        return _join_container(self.cfg, (payloads[b] for b in range(nb)), nb)

    def _compute_payloads(self, blocks, todo, payloads) -> None:
        """Encode `todo` (indexes into `blocks`) into `payloads`: one level
        through the pipelined three-stage path, several through the
        level-pipelined path; batches are uploaded per pipeline window."""
        batches = []
        id_groups = []
        for start in range(0, len(todo), self.batch_size):
            ids = todo[start : start + self.batch_size]
            batches.append(blocks[ids][:, :, None])
            id_groups.append(ids)
        if self.cfg.num_levels == 1:
            mp = self.coder.coders[0].mp
            encs = encode_batches_pipelined(
                batches, mp.params, device=self.device, backend=mp.backend, **mp.settings
            )
        else:
            encs = encode_hierarchical_batches_pipelined(batches, self.coder)[-1]
        for ids, enc in zip(id_groups, encs):
            for bid, stream in zip(ids, level_streams(to_host(enc))):
                payloads[bid] = self._pack_block(stream)

    # -- decode -------------------------------------------------------------

    def _check_geometry(self, cfg) -> None:
        # The stream header is the authoritative config (docs/FORMAT.md);
        # only the dictionary GEOMETRY must match this codec.
        for field in ("counts", "scales", "block_size"):
            if getattr(cfg, field) != getattr(self.cfg, field):
                raise ValueError(
                    f"stream {field}={getattr(cfg, field)} does not match "
                    f"this dictionary ({getattr(self.cfg, field)})"
                )

    def _decode_chunks(self, cfg, blocks, mode, rep_bits):
        """Yield decoded ``[chunk, block_size]`` arrays in container order,
        one chunk of `batch_size` blocks at a time, up to 4 device decodes
        in flight while the host unpacks the next chunk
        (`hsc_tpu.runtime.CorpusEncoder._decode_chunks`).  A chunk of
        top-only blocks is one batched decode; a distributed or mixed chunk
        (at most one stream per level per block, ascending) is one batched
        decode per level, summed on the host per block in level order; any
        other shape decodes block by block, streams in container order."""
        top = cfg.num_levels - 1
        it = iter(blocks)
        # pending: (chunk index, block ids or None for the whole chunk, rows)
        pending: deque = deque()
        outs: dict[int, np.ndarray] = {}
        units_left: dict[int, int] = {}
        next_yield = 0

        def decode(streams, level):
            return self.coder.reconstruct_batch_device(
                streams, level=level, mode=mode, rep_bits=rep_bits
            )

        def drain_one():
            ci, ids, dev = pending.popleft()
            rows = dev.cpu().numpy()[:, :, 0]
            if ids is None:
                outs[ci] = rows
            else:
                for j, b in enumerate(ids):
                    outs[ci][b] += rows[j]
            units_left[ci] -= 1

        def submit(ci, ids, dev):
            pending.append((ci, ids, dev))
            if len(pending) >= 4:
                drain_one()

        ci = 0
        while True:
            chunk = list(islice(it, max(self.batch_size, 1)))
            if not chunk:
                break
            if all(len(s) == 1 and s[0][0] == top for s in chunk):
                units_left[ci] = 1
                submit(ci, None, decode([s[0][1] for s in chunk], top))
            elif all(
                [lv for lv, _ in streams] == sorted({lv for lv, _ in streams})
                for streams in chunk
            ):
                by_level: dict[int, list[tuple[int, LevelStream]]] = {}
                for b, streams in enumerate(chunk):
                    for level, stream in streams:
                        by_level.setdefault(level, []).append((b, stream))
                outs[ci] = np.zeros((len(chunk), cfg.block_size), np.float32)
                units_left[ci] = len(by_level)
                for level in sorted(by_level):
                    ids = [b for b, _ in by_level[level]]
                    submit(ci, ids, decode([s for _, s in by_level[level]], level))
            else:
                out = np.zeros((len(chunk), cfg.block_size), np.float32)
                for b, streams in enumerate(chunk):
                    for level, stream in streams:
                        out[b] += decode([stream], level).cpu().numpy()[0, :, 0]
                outs[ci] = out
                units_left[ci] = 0
            ci += 1
            while next_yield < ci and units_left[next_yield] == 0:
                yield outs.pop(next_yield)
                next_yield += 1
        while pending:
            drain_one()
            while next_yield < ci and units_left[next_yield] == 0:
                yield outs.pop(next_yield)
                next_yield += 1

    def decode_stream(self, blob: bytes, indices=None):
        """Yield decoded blocks ``[block_size]`` in container order, bounded
        memory, rows byte-identical to `decode`'s."""
        if indices is not None:
            raise _not_ported("decode_stream(indices=...) (random access)", "Runtime and CLI")
        cfg, _n = peek_corpus_header(blob)
        self._check_geometry(cfg)
        for chunk in self._decode_chunks(cfg, iter_blocks(blob), cfg.decode_mode, cfg.rep_bits):
            yield from chunk

    def decode(self, blob: bytes) -> np.ndarray:
        """Decode a container -> ``[n_blocks, block_size]`` float32."""
        cfg, _n = peek_corpus_header(blob)
        self._check_geometry(cfg)
        # the stream header's decode arithmetic is authoritative
        parts = list(self._decode_chunks(cfg, iter_blocks(blob), cfg.decode_mode, cfg.rep_bits))
        if not parts:  # empty container (zero blocks)
            return np.zeros((0, cfg.block_size), dtype=np.float32)
        return np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
