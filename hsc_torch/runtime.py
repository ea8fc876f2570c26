"""Corpus encode/decode runtime — counterpart of `hsc_tpu.runtime`.

`CorpusEncoder` runs the codec's main path: batches of blocks through the
pipelined device encode (CUDA kernels on a card), host bit-packing into the
container format, and the batched integer decode.  The host code is copied
from `hsc_tpu.runtime` (its module imports JAX), because the container bytes
depend on it: a container written here is byte-identical to the JAX
package's for the same streams.

This slice covers single-level dictionaries, top-only payloads and
decode_mode='integer'.  The journal, constant-bitrate mode, the distributed
representation, meshes, the seek index and random-access decode raise
`NotImplementedError` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import struct
from collections import deque
from itertools import islice

import numpy as np

from hsc_tpu.config import CodecConfig
from hsc_tpu.dictionary import MultilevelDictionary
from hsc_tpu.io.bitstream import MAGIC, VERSION, iter_blocks, pack_stream, peek_corpus_header
from hsc_tpu.oracle.mp import LevelStream

from .models.coder import HierarchicalConvolutionalSparseCoder, to_host
from .ops.pipeline import encode_batches_pipelined


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
        if distributed:
            raise _not_ported("distributed=True", "Hierarchy")
        self.mld = mld
        self.cfg: CodecConfig = mld.config
        self.coder = HierarchicalConvolutionalSparseCoder(mld, backend=backend, device=device)
        self.device = self.coder.device
        self.batch_size = int(batch_size)

    # -- encode -------------------------------------------------------------

    def _pack_block(self, top_stream) -> bytes:
        """Pack one block: top form, no rate control
        (`hsc_tpu.runtime.CorpusEncoder._pack_block` with target_bps=None
        and distributed=False)."""
        top = self.cfg.num_levels - 1
        return struct.pack("<B", 1) + pack_stream(self.cfg, top, top_stream)

    def _validate_blocks(self, blocks) -> np.ndarray:
        blocks = np.asarray(blocks, dtype=np.float32)
        if blocks.ndim != 2 or blocks.shape[1] != self.cfg.block_size:
            raise ValueError(
                f"blocks must be [B, {self.cfg.block_size}]; got {blocks.shape}"
            )
        return blocks

    def _emit_batched(self, enc, ids: list[int], payloads: dict[int, bytes]) -> None:
        """Trim a host-side batched EncodedBlock to per-block streams and
        pack them into `payloads` under their block ids."""
        for j, bid in enumerate(ids):
            n = int(enc.count[j])
            stream = LevelStream(
                positions=np.asarray(enc.positions[j][:n], np.int32),
                atoms=np.asarray(enc.atoms[j][:n], np.int32),
                codes=np.asarray(enc.codes[j][:n], np.int32),
                scale=np.float32(enc.scale[j]),
                energy0=float(enc.energy0[j]),
                energy_res=float(enc.energy_res[j]),
            )
            payloads[bid] = self._pack_block(stream)

    def encode(self, blocks: np.ndarray, index: bool = False) -> bytes:
        """Encode ``[B, block_size]`` into the container format."""
        if index:
            raise _not_ported("index=True (the seek-index footer)", "Runtime and CLI")
        blocks = self._validate_blocks(blocks)
        nb = blocks.shape[0]
        payloads: dict[int, bytes] = {}
        self._encode_single_level_pipelined(blocks, list(range(nb)), payloads)
        return _join_container(self.cfg, (payloads[b] for b in range(nb)), nb)

    def _encode_single_level_pipelined(self, blocks, todo, payloads) -> None:
        mp = self.coder.coders[0].mp
        batches = []
        id_groups = []
        for start in range(0, len(todo), self.batch_size):
            ids = todo[start : start + self.batch_size]
            batches.append(blocks[ids][:, :, None])  # host; uploaded per window
            id_groups.append(ids)
        encs = encode_batches_pipelined(
            batches, mp.params, device=self.device, backend=mp.backend, **mp.settings
        )
        for ids, enc in zip(id_groups, encs):
            self._emit_batched(to_host(enc), ids, payloads)

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
        """Yield decoded ``[chunk, block_size]`` arrays in container order:
        one batched device decode per chunk of `batch_size` top-only blocks,
        up to 4 chunks in flight while the host unpacks the next."""
        top = cfg.num_levels - 1
        it = iter(blocks)
        pending: deque = deque()
        while True:
            chunk = list(islice(it, max(self.batch_size, 1)))
            if not chunk:
                break
            if not all(len(s) == 1 and s[0][0] == top for s in chunk):
                raise _not_ported("decoding distributed/mixed containers", "Runtime and CLI")
            pending.append(
                self.coder.reconstruct_batch_device(
                    [s[0][1] for s in chunk], level=top, mode=mode, rep_bits=rep_bits
                )
            )
            if len(pending) >= 4:
                yield pending.popleft().cpu().numpy()[:, :, 0]
        while pending:
            yield pending.popleft().cpu().numpy()[:, :, 0]

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
