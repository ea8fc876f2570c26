"""Corpus encode/decode runtime — counterpart of `hsc_tpu.runtime`.

`CorpusEncoder` runs the codec's main path: batches of blocks through the
pipelined device encode (CUDA kernels on a card), host bit-packing into the
container format (`io.bitstream`, the port's copy), and the batched decode.
Around it, as in the JAX package:

- serving: `encode(index=True)` appends the seek-index footer;
  `decode_stream(indices=...)` and `decode_blocks` decode only the blocks
  asked for, and `CorpusReader` serves rows of a memory-mapped container;
- rate control: `target_bps` keeps the longest greedy event prefixes that
  fit a byte budget, per block (`rate_mode='block'`) or across the corpus
  (`rate_mode='corpus'`, `allocate_corpus_prefixes`);
- the block journal (`io.journal`, the port's copy): a re-encode into the
  same `journal_dir` reuses the journaled payloads and runs no device work;
  per-process shards (`encode_shard`, `encode_multihost`) assemble into
  one container (`assemble_container`); `metrics_path` gets JSONL records.

The host code is copied from `hsc_tpu.runtime`, quirks included, because
the container bytes depend on it: a container written here is
byte-identical to the JAX package's for the same streams.  With a `mesh=`
(`parallel.mesh`), encode and decode shard their batches over the mesh's
'data' axis (`parallel.dp`), with byte-identical containers and rows.
"""

from __future__ import annotations

import mmap
import os
import re
import struct
import time
from collections import deque
from itertools import islice
from typing import NamedTuple

import numpy as np

from .config import CodecConfig
from .dictionary import MultilevelDictionary
from .io.bitstream import (
    MAGIC,
    VERSION,
    _index_footer,
    _parse_corpus_header,
    iter_blocks,
    pack_stream,
    peek_corpus_header,
    read_index,
    scan_block_offsets,
    unpack_block,
)
from . import record_pack
from .io.journal import EncodeJournal
from .device import copy_to_host_async
from .models.coder import HierarchicalConvolutionalSparseCoder, level_streams
from .ops.pipeline import encode_batches_pipelined, encode_hierarchical_batches_pipelined
from .oracle.mp import LevelStream, to_distributed
from .parallel.dp import multihost_split
from .utils import device_get_pipelined
from .utils.metrics import MetricsLogger
from .utils.profiling import scope

# blocks packed since import (or since a caller reset them to 0): by the
# batched native record packer, and one by one through `_pack_block`
BLOCKS_PACKED_BATCHED = 0
BLOCKS_PACKED_SINGLY = 0
# blocks a decode unpacked since import (or since a caller reset them to 0):
# by the batched native record unpacker, a top-only chunk a call; by the
# native per-level unpacker, a chunk of records of several levels a call;
# and one by one through `io.bitstream.unpack_block`
BLOCKS_UNPACKED_BATCHED = 0
BLOCKS_UNPACKED_BY_LEVEL = 0
BLOCKS_UNPACKED_SINGLY = 0
# rows a decode drained straight into a join's output (`_join_rows`) since
# import (or since a caller reset it to 0)
BLOCKS_JOINED_IN_PLACE = 0
# block rows a decode added on the host into a chunk summed per level (one
# a block a level unit of a distributed or mixed chunk) since import (or
# since a caller reset it to 0)
ROWS_SUMMED_BY_LEVEL = 0


class _Records(NamedTuple):
    """A decode's blocks as records: the container's bytes (an mmap or any
    buffer) and each block's record offset in them, in decode order."""

    data: object
    offsets: np.ndarray


class _ChunkRecords(NamedTuple):
    """One decode chunk's records for `CorpusEncoder._units`: the stream's
    config that reads them, the container's bytes and the chunk's record
    offsets in them."""

    cfg: CodecConfig
    data: object
    offsets: np.ndarray


def _journal_name(process_index: int) -> str:
    """Per-process journal file name: process 0 keeps the single-process
    name so existing journals resume unchanged."""
    return "corpus" if process_index == 0 else f"corpus.p{process_index}"


def parse_journal_name(base: str) -> int | None:
    """Inverse of `_journal_name`: 'corpus' -> 0, 'corpus.pN' -> N, anything
    else -> None."""
    if base == "corpus":
        return 0
    m = re.fullmatch(r"corpus\.p(\d+)", base)
    return int(m.group(1)) if m else None


def journal_fingerprint(
    cfg: CodecConfig, distributed: bool = False,
    target_bps: float | None = None, rate_mode: str = "block",
) -> str:
    """The journal's resume fingerprint: everything that changes journaled
    PAYLOAD bytes beyond the codec config — the distributed representation
    and the constant-bitrate budget.  One builder (and one parser below)
    for the writers (CorpusEncoder) and the readers (assemble_container).

    rate_mode='corpus' journals carry ':cbrc=' instead of ':cbr=' — their
    payload bytes are full-rate top-form block records (truncation and the
    distributed split happen at container assembly), so the suffix also
    tells assembly what emission work remains.  ':distributed' is still
    recorded (it names the emission form, not the journal bytes, in this
    mode)."""
    s = cfg.to_json()
    if distributed:
        s += ":distributed"
    if target_bps is not None:
        # an int-typed rate must fingerprint identically to its float form
        tag = "cbrc" if rate_mode == "corpus" else "cbr"
        s += f":{tag}={float(target_bps)!r}"
    return s


def parse_journal_fingerprint(stored: str):
    """Inverse of `journal_fingerprint`:
    (config_json, distributed, target_bps, rate_mode).  Anchored on the
    suffix: the config JSON always ends in '}', which the cbr value's
    charset excludes, so the match never eats into the JSON."""
    m = re.search(r"(:distributed)?(?::(cbr|cbrc)=([^:}]+))?$", stored)
    t = m.group(3)
    return (
        stored[: m.start()],
        m.group(1) is not None,
        float(t) if t is not None else None,
        "corpus" if m.group(2) == "cbrc" else "block",
    )


def _prefix_stream(stream, k: int):
    """The first-k-events greedy prefix of a stream (a valid stream itself:
    the first k events of a budget-N encode ARE the budget-k encode).
    Truncated prefixes carry unknown residual energy — zeroed, matching
    unpacked streams (energies are never serialized)."""
    if k >= int(stream.positions.shape[0]):
        return stream
    return LevelStream(
        positions=stream.positions[:k],
        atoms=stream.atoms[:k],
        codes=stream.codes[:k],
        scale=np.float32(stream.scale),
        energy0=0.0,
        energy_res=0.0,
    )


def allocate_corpus_prefixes(
    streams: list, budget: int, emit
) -> tuple[list[bytes], list[int]]:
    """Corpus-level constant-bitrate allocation (rate_mode='corpus'), a copy
    of `hsc_tpu.runtime.allocate_corpus_prefixes`.

    Chooses per-block greedy-prefix lengths ``k_b`` maximizing explained
    energy subject to ``sum(len(emit(prefix_b(k_b)))) <= budget``.  The
    per-event gain ``(code*scale)^2`` is not monotone along a stream, so the
    allocation runs on each block's upper concave envelope of cumulative
    gain against bytes: hull segments of every block merge in decreasing
    gain-per-byte order, charged at the block's mean packed bytes/event;
    then an exact repair pass enforces the budget on real packed sizes and
    a bounded growth pass spends what is left.  Deterministic from the
    streams and `emit` alone (float64 gains, ties broken by block index).
    Returns (payloads, prefix_lengths), block order preserved."""
    nb = len(streams)
    packs: list[dict[int, bytes]] = [{} for _ in range(nb)]

    def size(b: int, k: int) -> int:
        d = packs[b]
        if k not in d:
            d[k] = emit(_prefix_stream(streams[b], k))
        return len(d[k])

    ns = [int(s.positions.shape[0]) for s in streams]
    base = sum(size(b, 0) for b in range(nb))
    if base > budget:
        raise ValueError(
            f"corpus budget {budget} bytes is below the empty-stream "
            f"floor ({base} bytes for {nb} blocks)"
        )
    gains = [
        (s.codes.astype(np.float64) * np.float64(s.scale)) ** 2
        for s in streams
    ]
    # mean bytes/event from one full pack
    est = [
        max((size(b, ns[b]) - size(b, 0)) / ns[b], 1e-9) if ns[b] else 1.0
        for b in range(nb)
    ]
    # upper concave hull of each block's (k, cumulative gain) polyline;
    # segments carry their mean gain-per-byte as the merge key
    segments = []  # (-gain_per_byte, b, k_from, k_to)
    for b in range(nb):
        if not ns[b]:
            continue
        cum = np.concatenate([[0.0], np.cumsum(gains[b])])
        hull = [0]
        for j in range(1, len(cum)):
            while len(hull) >= 2:
                a, m = hull[-2], hull[-1]
                # pop m while it lies on/below chord a->j (keeps slopes
                # strictly decreasing along the hull)
                if (cum[m] - cum[a]) * (j - m) <= (cum[j] - cum[m]) * (m - a):
                    hull.pop()
                else:
                    break
            hull.append(j)
        for a, j in zip(hull, hull[1:]):
            slope = (cum[j] - cum[a]) / ((j - a) * est[b])
            segments.append((-slope, b, a, j))
    segments.sort()

    k = [0] * nb
    spend = float(base)
    for negs, b, a, j in segments:
        if k[b] != a:
            continue  # an earlier boundary cut this block mid-hull
        cost = (j - a) * est[b]
        if spend + cost <= budget:
            k[b] = j
            spend += cost
        else:
            take = int((budget - spend) // est[b])
            if take > 0:
                k[b] = a + take
                spend += take * est[b]

    # exact repair on real packed sizes
    total = sum(size(b, k[b]) for b in range(nb))
    while total > budget:
        # drop the lowest-ratio frontier event
        _, b = min(
            (gains[b][k[b] - 1] / max(est[b], 1e-9), b)
            for b in range(nb)
            if k[b] > 0
        )
        total -= size(b, k[b]) - size(b, k[b] - 1)
        k[b] -= 1
    closed: set[int] = set()
    while len(closed) < 8:  # bounded growth pass (rice wobble is small)
        cands = [
            (-gains[b][k[b]] / max(est[b], 1e-9), b)
            for b in range(nb)
            if k[b] < ns[b] and b not in closed
        ]
        if not cands:
            break
        _, b = min(cands)
        delta = size(b, k[b] + 1) - size(b, k[b])
        if total + delta <= budget:
            total += delta
            k[b] += 1
        else:
            closed.add(b)
    return [packs[b][k[b]] for b in range(nb)], k


def _emit_record(cfg: CodecConfig, stream, distributed: bool) -> bytes:
    """One block record of a top-level stream: top form, or the distributed
    representation (each event at the level where its atom is raw)."""
    top = cfg.num_levels - 1
    if distributed and cfg.num_levels > 1:
        parts = to_distributed(cfg, stream)
        return struct.pack("<B", len(parts)) + b"".join(
            pack_stream(cfg, level, s) for level, s in parts
        )
    return struct.pack("<B", 1) + pack_stream(cfg, top, stream)


def apply_corpus_cbr(
    cfg: CodecConfig,
    records: list[bytes],
    target_bps: float,
    distributed: bool = False,
) -> list[bytes]:
    """Re-emit full-rate top-form block records under a corpus-level
    constant-bitrate budget (``target_bps * block_size * n_blocks / 8``
    bytes across the whole block region): unpack each record's top stream,
    allocate prefixes corpus-wide (`allocate_corpus_prefixes`), and pack
    the chosen prefixes in the emission form (the distributed split is
    applied here: the greedy prefix order only exists on the top stream)."""
    top = cfg.num_levels - 1
    streams = []
    for rec in records:
        parts, _ = unpack_block(cfg, rec, 0)
        if len(parts) != 1 or parts[0][0] != top:
            raise ValueError(
                "corpus-rate allocation needs top-form records (one "
                f"level-{top} stream per block); got "
                f"{[lv for lv, _ in parts]}"
            )
        streams.append(parts[0][1])
    budget = int(target_bps * cfg.block_size * len(records) / 8)
    payloads, _ = allocate_corpus_prefixes(
        streams, budget, lambda s: _emit_record(cfg, s, distributed)
    )
    return payloads


def _join_container(cfg: CodecConfig, records, n_blocks: int, index: bool) -> bytes:
    """Assemble header + block records (+ the optional seek-index footer
    from the offsets the assembly already knows — no re-scan)."""
    cfg_json = cfg.to_json().encode()
    parts = [
        MAGIC,
        struct.pack("<BI", VERSION, len(cfg_json)),
        cfg_json,
        struct.pack("<I", n_blocks),
    ]
    off = sum(len(p) for p in parts)
    offsets = np.empty(n_blocks + 1, np.int64)
    for b, rec in enumerate(records):
        offsets[b] = off
        parts.append(rec)
        off += len(rec)
    offsets[n_blocks] = off
    if index:
        parts.append(_index_footer(offsets))
    return b"".join(parts)


def assemble_container(
    cfg: CodecConfig,
    journal_dir: str,
    n_blocks: int,
    n_processes: int,
    distributed: bool = False,
    index: bool = False,
    target_bps: float | None = None,
    fingerprint: str | None = None,
    rate_mode: str = "block",
) -> bytes:
    """Process-0 container assembly from per-process journals: each process
    journals its own shard under global block ids; the container comes out
    in original block order whatever the completion order.  Absent journal
    files (a process that never wrote a block) are skipped; their blocks
    surface in the missing-ids error.  `fingerprint`, when given, is
    enforced verbatim (pass through what a journal's .config holds rather
    than rebuilding it).  rate_mode='corpus' journals hold full-rate
    top-form records; the corpus budget is applied here, across every
    process's shard."""
    if fingerprint is None:
        fingerprint = journal_fingerprint(cfg, distributed, target_bps, rate_mode)
    journals = [
        EncodeJournal(journal_dir, name=_journal_name(p), config_json=fingerprint)
        for p in range(n_processes)
        if os.path.exists(os.path.join(journal_dir, f"{_journal_name(p)}.journal"))
    ]
    try:
        owner: dict[int, EncodeJournal] = {}
        for j in journals:
            for bid in j.done_blocks:
                owner.setdefault(bid, j)
        missing = [b for b in range(n_blocks) if b not in owner]
        if missing:
            raise ValueError(
                f"blocks not yet encoded in any journal: {missing[:8]}..."
            )
        records = (owner[b].read(b) for b in range(n_blocks))
        if rate_mode == "corpus" and target_bps is not None:
            records = apply_corpus_cbr(cfg, list(records), target_bps, distributed)
        return _join_container(cfg, records, n_blocks, index)
    finally:
        for j in journals:
            j.close()


class CorpusEncoder:
    """End-to-end corpus codec around a HierarchicalConvolutionalSparseCoder.

    `distributed`: emit the distributed representation instead of the
    top-level-only stream.  `target_bps`: constant-bitrate mode — keep the
    largest greedy event prefixes whose packed payloads fit the byte budget
    (num_coefs stays the quality ceiling), allocated per block
    (`rate_mode='block'`, a hard per-block cap) or across the corpus
    (`'corpus'`: blocks journal full top-form payloads, and truncation and
    the distributed split happen at container assembly).  `journal_dir`
    makes the encode resumable; `metrics_path` appends JSONL records
    (process 0 only).  `mesh` (a `parallel.Mesh` of the `device` type):
    encode and decode shard over `mesh_axis`, every level of the hierarchy
    on every shard (`parallel.dp`), in super-batches of ``batch_size`` x
    shards blocks."""

    def __init__(
        self,
        mld: MultilevelDictionary,
        *,
        device,
        backend: str = "auto",
        batch_size: int = 64,
        journal_dir: str | None = None,
        metrics_path: str | None = None,
        process_index: int = 0,
        mesh=None,
        mesh_axis: str = "data",
        distributed: bool = False,
        target_bps: float | None = None,
        rate_mode: str = "block",
    ):
        self.mld = mld
        self.cfg: CodecConfig = mld.config
        self.coder = HierarchicalConvolutionalSparseCoder(mld, backend=backend, device=device)
        self.device = self.coder.device
        self.batch_size = int(batch_size)
        self.distributed = bool(distributed)
        if target_bps is not None and not target_bps > 0:
            raise ValueError("target_bps must be positive")
        self.target_bps = float(target_bps) if target_bps is not None else None
        if rate_mode not in ("block", "corpus"):
            raise ValueError("rate_mode must be 'block' or 'corpus'")
        self.rate_mode = rate_mode
        self.process_index = int(process_index)
        self.journal = (
            EncodeJournal(
                journal_dir,
                name=_journal_name(self.process_index),
                # a journal written at another rate or form must not be
                # silently extended at this one
                config_json=journal_fingerprint(
                    self.cfg, self.distributed, self.target_bps, self.rate_mode
                ),
            )
            if journal_dir is not None
            else None
        )
        self.metrics = MetricsLogger(metrics_path, process_index)
        self.dp = None
        self.dp_dec = None
        # the device decode of a unit's padded host arrays, sharded over the
        # mesh when the codec has one: the same rows
        self._decode_padded = self.coder._decode_device_call
        if mesh is not None:
            from .parallel.dp import DataParallelDecoder, HierarchicalDataParallelEncoder

            self.dp = HierarchicalDataParallelEncoder(mesh, self.coder, axis=mesh_axis)
            self.dp_dec = DataParallelDecoder(mesh, self.coder, axis=mesh_axis)
            self._decode_padded = self.dp_dec.decode_padded_device

    # -- encode -------------------------------------------------------------

    def _pack_block(self, top_stream) -> tuple[bytes, int]:
        """Pack one block -> (payload, stored event count).  Under
        `target_bps` with rate_mode='block', bisect the event-prefix length
        on the full per-block payload size (distributed per-level headers
        and rice coding charged exactly), probed blobs memoized per k, then
        scan upward while the budget still holds (rice sizes wobble).
        rate_mode='corpus' packs the full stream in top form here."""
        n = int(top_stream.positions.shape[0])
        if self.target_bps is not None and self.rate_mode == "corpus":
            return _emit_record(self.cfg, top_stream, False), n
        if self.target_bps is None:
            return _emit_record(self.cfg, top_stream, self.distributed), n

        budget = int(self.target_bps * self.cfg.block_size / 8)
        blobs: dict[int, bytes] = {}

        def size(k: int) -> int:
            if k not in blobs:
                blobs[k] = _emit_record(self.cfg, _prefix_stream(top_stream, k), self.distributed)
            return len(blobs[k])

        if size(0) > budget:
            raise ValueError(
                f"target_bps={self.target_bps} is below the empty-stream "
                f"floor ({size(0)} bytes/block > {budget})"
            )
        if size(n) <= budget:
            return blobs[n], n
        lo, hi = 0, n  # invariant: size(lo) <= budget < size(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if size(mid) <= budget:
                lo = mid
            else:
                hi = mid
        while lo + 1 < n and size(lo + 1) <= budget:
            lo += 1
        return blobs[lo], lo

    def _validate_blocks(self, blocks) -> np.ndarray:
        blocks = np.asarray(blocks, dtype=np.float32)
        if blocks.ndim != 2 or blocks.shape[1] != self.cfg.block_size:
            raise ValueError(
                f"blocks must be [B, {self.cfg.block_size}]; got {blocks.shape}"
            )
        return blocks

    def _packs_batched(self) -> bool:
        """Whether a batch's records come from one native call
        (`record_pack`): only where every block would get `_emit_record`'s
        plain top form (fixed entropy, no rate target, not split across
        levels) and the packer is built and takes the event width."""
        return (
            self.cfg.entropy == "fixed"
            and self.target_bps is None
            and not (self.distributed and self.cfg.num_levels > 1)
            and record_pack.event_bits_ok(self.cfg, self.cfg.num_levels - 1)
            and record_pack.available()
        )

    def _emit_batched(self, enc, ids: list[int], payloads: dict[int, bytes], offset: int):
        """Trim a host batched `EncodedBlock` to per-block streams, pack, and
        journal under global ids ``id + offset``, in one `hsc:encode.pack`
        span.  The records come from one native call where `_packs_batched`,
        else block by block.  Returns (events, payload_bytes, per-block SNRs
        dB)."""
        global BLOCKS_PACKED_BATCHED, BLOCKS_PACKED_SINGLY
        events = 0
        total_bytes = 0
        snrs: list[float] = []
        with scope("hsc:encode.pack"):
            streams = level_streams(enc)
            if self._packs_batched():
                records = record_pack.pack_records(self.cfg, self.cfg.num_levels - 1, streams)
                packed = ((r, len(s.positions)) for r, s in zip(records, streams))
                BLOCKS_PACKED_BATCHED += len(records)
            else:
                packed = map(self._pack_block, streams)
                BLOCKS_PACKED_SINGLY += len(streams)
            for bid, stream, (payload, kept) in zip(ids, streams, packed):
                n = int(stream.positions.shape[0])
                payloads[bid] = payload
                total_bytes += len(payload)
                # metrics count stored events; a CBR-truncated block's quality
                # is unknown here (NaN, filtered from the mean)
                events += kept
                snrs.append(stream.snr_db() if kept == n else float("nan"))
                if self.journal:
                    self.journal.record(bid + offset, payload)
        return events, total_bytes, snrs

    def _log_encode_metrics(
        self, nblk: int, dt: float, events: int, total_bytes: int,
        snrs: list[float], **extra,
    ) -> None:
        self.metrics.log(
            {
                "kind": "encode_batch",
                "blocks": nblk,
                "seconds": dt,
                "mb_per_s": nblk * self.cfg.block_size * 4 / 1e6 / max(dt, 1e-9),
                "events": events,
                "coefs_per_sample": events / max(nblk * self.cfg.block_size, 1),
                # null (not a fabricated 0 dB) when no block has a known SNR
                "mean_snr_db": (
                    float(np.mean(finite))
                    if (finite := [v for v in snrs if np.isfinite(v)])
                    else None
                ),
                "bits_per_sample": 8.0 * total_bytes
                / max(nblk * self.cfg.block_size, 1),
                **extra,
            }
        )

    def _compute_payloads(self, blocks, todo, payloads, offset: int = 0) -> None:
        """Encode `todo` (local indexes into `blocks`) into `payloads`,
        journaled under global ids ``local + offset``: one level through the
        pipelined three-stage path, several through the level-pipelined
        path; batches are uploaded per pipeline window.  With a mesh, the
        data-parallel path (`_encode_dp`).  Spans: `hsc:encode.gather` (the
        host batches), `hsc:encode.pipeline` (first upload to events on the
        host, the interval the `encode_batch` record's `seconds` times),
        `hsc:encode.pack` a batch."""
        if self.dp is not None:
            self._encode_dp(blocks, todo, payloads, offset)
            return
        batches = []
        id_groups = []
        with scope("hsc:encode.gather"):
            for start in range(0, len(todo), self.batch_size):
                ids = todo[start : start + self.batch_size]
                batches.append(blocks[ids][:, :, None])
                id_groups.append(ids)
        if not batches:
            return
        with scope("hsc:encode.pipeline"):
            t0 = time.perf_counter()
            if self.cfg.num_levels == 1:
                mp = self.coder.coders[0].mp
                encs = encode_batches_pipelined(
                    batches, mp.params, device=self.device, backend=mp.backend, **mp.settings
                )
            else:
                encs = encode_hierarchical_batches_pipelined(batches, self.coder)[-1]
            encs = device_get_pipelined(encs)
            dt = time.perf_counter() - t0
        events = 0
        total_bytes = 0
        snrs: list[float] = []
        for ids, enc in zip(id_groups, encs):
            e, b, sn = self._emit_batched(enc, ids, payloads, offset)
            events += e
            total_bytes += b
            snrs += sn
        self._log_encode_metrics(len(todo), dt, events, total_bytes, snrs)

    def _encode_dp(self, blocks, todo, payloads, offset: int = 0) -> None:
        """Mesh-sharded encode: super-batches of ``batch_size`` x shards
        blocks through the `HierarchicalDataParallelEncoder` (each shard gets
        `batch_size` blocks; the last super-batch pads), one metrics record
        per super-batch; the spans of `_compute_payloads`, each once a
        super-batch, with `parallel.dp`'s ``hsc:mesh.*`` inside the
        pipeline's."""
        top = self.cfg.num_levels - 1
        super_batch = self.batch_size * self.dp.num_shards
        for start in range(0, len(todo), super_batch):
            ids = todo[start : start + super_batch]
            with scope("hsc:encode.gather"):
                batch = blocks[ids]
            with scope("hsc:encode.pipeline"):
                t0 = time.perf_counter()
                enc = self.dp.encode(batch)[top]
                dt = time.perf_counter() - t0
            events, total_bytes, snrs = self._emit_batched(enc, ids, payloads, offset)
            self._log_encode_metrics(
                len(ids), dt, events, total_bytes, snrs, shards=self.dp.num_shards
            )

    def encode(self, blocks: np.ndarray, index: bool = False) -> bytes:
        """Encode ``[B, block_size]`` into the container format; resumable —
        journaled blocks are skipped.  `index=True` appends the seek-index
        footer from the offsets the assembly already knows.  The container's
        assembly is one `hsc:encode.assemble` span."""
        blocks = self._validate_blocks(blocks)
        nb = blocks.shape[0]
        done = self.journal.done_blocks if self.journal else set()
        todo = [b for b in range(nb) if b not in done]
        payloads: dict[int, bytes] = {}
        self._compute_payloads(blocks, todo, payloads)
        with scope("hsc:encode.assemble"):
            records = (
                payloads[b] if b in payloads else self.journal.read(b)
                for b in range(nb)
            )
            if self.target_bps is not None and self.rate_mode == "corpus":
                full = list(records)
                records = apply_corpus_cbr(self.cfg, full, self.target_bps, self.distributed)
                self.metrics.log(
                    {
                        "kind": "corpus_cbr",
                        "blocks": nb,
                        "budget_bytes": int(self.target_bps * self.cfg.block_size * nb / 8),
                        "emitted_bytes": sum(len(r) for r in records),
                        "full_bytes": sum(len(r) for r in full),
                    }
                )
            return _join_container(self.cfg, records, nb, index)

    # -- multi-process orchestration ----------------------------------------

    def encode_shard(self, local_blocks: np.ndarray, global_start: int = 0) -> None:
        """Encode a process-local corpus shard, journaling payloads under
        global block ids ``global_start + i`` (process 0 assembles with
        `assemble_container`).  Requires a journal."""
        if self.journal is None:
            raise ValueError("encode_shard requires a journal_dir")
        blocks = self._validate_blocks(local_blocks)
        done = self.journal.done_blocks
        todo = [b for b in range(blocks.shape[0]) if b + global_start not in done]
        self._compute_payloads(blocks, todo, {}, offset=global_start)

    def encode_multihost(
        self,
        local_blocks: np.ndarray,
        n_global: int,
        n_processes: int | None = None,
    ) -> bytes | None:
        """Multi-process corpus encode: every process encodes and journals
        its shard of `multihost_split` (ragged tails allowed), then process
        0 assembles the container from all journals in a shared directory.
        Returns the container on process 0, None elsewhere.

        `n_processes` defaults to `torch.distributed`'s world size when a
        process group is initialized, else 1; then each process waits at
        `torch.distributed.barrier()` before assembly.  Passing it
        explicitly (with per-encoder `process_index`) runs the shard and
        assembly protocol in one process.  With one process and
        process_index 0 this equals `encode`."""
        import torch.distributed as dist

        grouped = dist.is_available() and dist.is_initialized()
        if n_processes is None:
            n_proc = dist.get_world_size() if grouped else 1
        else:
            n_proc = int(n_processes)
        if n_proc == 1 and self.process_index == 0:
            return self.encode(local_blocks)
        lo, hi = multihost_split(n_global, n_proc)[self.process_index]
        blocks = self._validate_blocks(local_blocks)
        if blocks.shape[0] != hi - lo:
            raise ValueError(
                f"process {self.process_index} must pass blocks [{lo}, {hi}); "
                f"got {blocks.shape[0]}"
            )
        self.encode_shard(blocks, global_start=lo)
        if grouped:
            dist.barrier()
        if self.process_index == 0:
            with scope("hsc:encode.assemble"):
                return assemble_container(
                    self.cfg,
                    os.path.dirname(self.journal._jpath),
                    n_global,
                    n_proc,
                    distributed=self.distributed,
                    target_bps=self.target_bps,
                    rate_mode=self.rate_mode,
                )
        return None

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

    def _chunks(self, cfg, blocks, mode):
        """Yield `_decode_chunks`' `blocks` in chunks of `batch_size` as
        ``(blocks in the chunk, per-block [(level, stream)] lists,
        `_units`)``.  From `_Records`
        a top-only chunk unpacks in one `record_pack.unpack_records` call
        straight into its one unit's arrays (no lists); where that call
        gives up, `_units` takes the chunk's records (one native call a
        chunk of records of several levels); where it gives up too, block
        by block through `unpack_block` (which raises on a faulty record).
        Counts the blocks in `BLOCKS_UNPACKED_*`."""
        global BLOCKS_UNPACKED_BATCHED, BLOCKS_UNPACKED_BY_LEVEL, BLOCKS_UNPACKED_SINGLY
        size = max(self.batch_size, 1)
        top = cfg.num_levels - 1
        if not isinstance(blocks, _Records):
            it = iter(blocks)
            while chunk := list(islice(it, size)):
                BLOCKS_UNPACKED_SINGLY += len(chunk)
                yield len(chunk), chunk, self._units(chunk, top, mode)
            return
        data, offsets = blocks
        # `_decode_arrays`'s capacity: a longer stream sends its chunk to
        # the per-block path, which buckets it
        cap = max(self.cfg.num_coefs[top], 1)
        for k in range(0, len(offsets), size):
            offs = offsets[k : k + size]
            padded = record_pack.unpack_records(cfg, top, data, offs, cap)
            if padded is not None:
                BLOCKS_UNPACKED_BATCHED += len(offs)
                yield len(offs), None, [(None, top, padded)]
            elif (units := self._units(_ChunkRecords(cfg, data, offs), top, mode)) is not None:
                BLOCKS_UNPACKED_BY_LEVEL += len(offs)
                yield len(offs), None, units
            else:
                BLOCKS_UNPACKED_SINGLY += len(offs)
                chunk = [unpack_block(cfg, data, int(o))[0] for o in offs]
                yield len(chunk), chunk, self._units(chunk, top, mode)

    def _units(self, chunk, top: int, mode):
        """A chunk's decode units ``(ids, level, arrays)``: the padded host
        arrays ``(pos, atm, cds, cnt, scl)`` of one decode (the coder's
        `_decode_arrays`) and the chunk rows they add to (None: all).  One
        unit a top-only chunk, one a level a distributed or mixed one (at
        most one stream per level per block, ascending); else None.  A
        chunk of per-block ``[(level, stream)]`` lists, or `_ChunkRecords`
        read in one `record_pack.unpack_level_records` call straight into
        the same units (None where that call gives up: the caller unpacks
        the chunk block by block)."""
        if isinstance(chunk, _ChunkRecords):
            # `_decode_arrays`'s capacity a level: a longer stream sends its
            # chunk to the per-block path, which buckets it
            caps = [max(c, 1) for c in self.cfg.num_coefs]
            return record_pack.unpack_level_records(chunk.cfg, chunk.data, chunk.offsets, caps)

        def unit(ids, level, streams):
            return ids, level, self.coder._decode_arrays(streams, level, mode)[:5]

        if all(len(s) == 1 and s[0][0] == top for s in chunk):
            return [unit(None, top, [s[0][1] for s in chunk])]
        if not all([lv for lv, _ in s] == sorted({lv for lv, _ in s}) for s in chunk):
            return None
        by_level: dict[int, list[tuple[int, LevelStream]]] = {}
        for b, streams in enumerate(chunk):
            for level, stream in streams:
                by_level.setdefault(level, []).append((b, stream))
        return [
            unit([b for b, _ in by_level[level]], level, [s for _, s in by_level[level]])
            for level in sorted(by_level)
        ]

    def _decode_chunks(self, cfg, blocks, mode, rep_bits, out=None):
        """Yield decoded ``[chunk, block_size]`` arrays in container order,
        one chunk of `batch_size` blocks at a time, up to 4 device decodes
        in flight while the host unpacks the next chunk
        (`hsc_tpu.runtime.CorpusEncoder._decode_chunks`): each decode's
        uploads are queued without a host wait, its rows' copy-back is
        started when it is dispatched, and the host waits on that copy's
        event when it drains the decode.  `blocks` may be a lazy iterator
        of per-block ``[(level, stream)]`` lists, or `_Records`.  Each unit
        of `_chunks` is one decode of `_decode_padded`, a distributed
        chunk's summed on the host per block in level order; an exotic
        chunk decodes block by block (`reconstruct`), streams in order.
        With `out` (`_join_rows`' ``[len(blocks), block_size]`` float32
        array) a chunk's rows are made in their rows of `out` and the chunk
        yielded is that view; without, each chunk is a fresh array.

        Spans, disjoint and none across a `yield`: `hsc:decode.unpack` a
        chunk pulled from `_chunks`, `hsc:decode.dispatch` a decode unit
        (an exotic chunk's per-block loop is one), `hsc:decode.drain` a
        unit's wait and copy out of pinned memory, `hsc:decode.levelsum`
        the host sum of a chunk summed per level: once for the zeroing of
        its rows, once a unit for the unit's adds (counted in
        `ROWS_SUMMED_BY_LEVEL`)."""
        chunks = self._chunks(cfg, blocks, mode)
        # pending: (chunk index, block ids or None for the whole chunk, the
        # rows' HostCopy)
        pending: deque = deque()
        outs: dict[int, np.ndarray] = {}
        units_left: dict[int, int] = {}
        next_yield = 0

        def drain_one():
            global ROWS_SUMMED_BY_LEVEL
            with scope("hsc:decode.drain"):
                ci, ids, copy = pending.popleft()
                if ids is None and out is not None:
                    copy.numpy_into(outs[ci][:, :, None])
                elif ids is None:
                    outs[ci] = copy.numpy()[:, :, 0]
                else:
                    rows = copy.numpy()[:, :, 0]
            if ids is not None:
                with scope("hsc:decode.levelsum"):
                    for j, b in enumerate(ids):
                        outs[ci][b] += rows[j]
                ROWS_SUMMED_BY_LEVEL += len(ids)
            units_left[ci] -= 1

        def zeroed(ci, n):
            # a chunk's rows that are summed into: zero, then += as the
            # sum's first term (not an assignment, which keeps a -0.0)
            if out is None:
                outs[ci] = np.zeros((n, cfg.block_size), np.float32)
            else:
                outs[ci].fill(0)
            return outs[ci]

        def submit(ci, ids, level, arrays):
            # the copy-back starts now, behind this decode on the stream;
            # drain_one waits for it alone, after the dispatch's span
            with scope("hsc:decode.dispatch"):
                rows = self._decode_padded(*arrays, level, mode, rep_bits)
                pending.append((ci, ids, copy_to_host_async(rows)))
            if len(pending) >= 4:
                drain_one()

        def finished():
            nonlocal next_yield
            while next_yield < ci and units_left[next_yield] == 0:
                yield outs.pop(next_yield)
                next_yield += 1

        ci = row = 0
        while True:
            with scope("hsc:decode.unpack"):
                chunk = next(chunks, None)
            if chunk is None:
                break
            n, per_block, units = chunk
            if out is not None:
                outs[ci] = out[row : row + n]
            row += n
            if units is None:
                # exotic (several streams of one level in one block): the
                # per-block host loop in stream order, not pipelined
                with scope("hsc:decode.dispatch"):
                    rows = zeroed(ci, n)
                    for b, streams in enumerate(per_block):
                        for level, stream in streams:
                            rows[b] += self.coder.reconstruct(
                                stream, level=level, mode=mode, rep_bits=rep_bits
                            )
                units_left[ci] = 0
            else:
                if not (units and units[0][0] is None):  # summed per level
                    with scope("hsc:decode.levelsum"):
                        zeroed(ci, n)
                units_left[ci] = len(units)
                for ids, level, arrays in units:
                    submit(ci, ids, level, arrays)
            ci += 1
            yield from finished()
        while pending:
            drain_one()
            yield from finished()

    def _join_rows(self, cfg, blocks, n: int) -> np.ndarray:
        """`_decode_chunks` of `blocks` (`n` of them) as one ``[n,
        block_size]`` float32 array, allocated once in the one
        `hsc:decode.stack` span; a top-only decode unit's rows are drained
        straight into their place in it (`hsc:decode.drain`), so a row is
        copied on the host once, and a chunk summed per level is zeroed
        and summed in its place (`hsc:decode.levelsum`).  Counts the rows
        made in place in `BLOCKS_JOINED_IN_PLACE`.  The output holds what
        `_decode_chunks` yields: a chunk yielded from elsewhere (a wrapper
        that alters the rows, as the benchmark's fault tests do) is copied
        into place."""
        global BLOCKS_JOINED_IN_PLACE
        with scope("hsc:decode.stack"):
            out = np.empty((n, cfg.block_size), np.float32)
        row = 0
        for chunk in self._decode_chunks(cfg, blocks, cfg.decode_mode, cfg.rep_bits, out):
            dst = out[row : row + len(chunk)]
            if chunk.ctypes.data == dst.ctypes.data:
                BLOCKS_JOINED_IN_PLACE += len(chunk)
            else:
                np.copyto(dst, chunk)
            row += len(chunk)
        return out

    def _container_selection(self, blob: bytes, indices=None):
        """``(cfg, blocks, n)`` for `_decode_chunks`: the stream header's
        config and all of `blob`'s `n` blocks (`_container_blocks`), or
        those of `indices` in the order given, at `_block_offsets`, so that
        only their records are unpacked."""
        cfg, n_blocks = peek_corpus_header(blob)
        self._check_geometry(cfg)
        if indices is None:
            return cfg, _container_blocks(blob, n_blocks), n_blocks
        indices = [int(i) for i in indices]
        for i in indices:
            if not 0 <= i < n_blocks:
                raise IndexError(f"block {i} out of range [0, {n_blocks})")
        offsets = _block_offsets(blob, n_blocks)[np.asarray(indices, np.int64)]
        return cfg, _Records(blob, offsets), len(indices)

    def decode_stream(self, blob: bytes, indices=None):
        """Yield decoded blocks ``[block_size]`` in container order, bounded
        memory, rows byte-identical to `decode`'s.  `indices` (optional)
        streams only those blocks, in the order given: offsets from the
        seek-index footer when the container carries a current one, else
        one header scan; only the selected payloads are unpacked."""
        cfg, blocks, _ = self._container_selection(blob, indices)
        # the stream header's decode arithmetic is authoritative
        for chunk in self._decode_chunks(cfg, blocks, cfg.decode_mode, cfg.rep_bits):
            yield from chunk

    def decode_blocks(self, blob: bytes, indices) -> np.ndarray:
        """Random-access decode: only the requested blocks, as
        ``[len(indices), block_size]`` in the order given, each row
        byte-identical to the matching row of `decode`."""
        return self._join_rows(*self._container_selection(blob, list(indices)))

    def decode(self, blob: bytes) -> np.ndarray:
        """Decode a container -> ``[n_blocks, block_size]`` float32."""
        t0 = time.perf_counter()
        out = self._join_rows(*self._container_selection(blob))
        dt = time.perf_counter() - t0
        self.metrics.log(
            {
                "kind": "decode",
                "blocks": out.shape[0],
                "seconds": dt,
                "mb_per_s": out.nbytes / 1e6 / dt,
            }
        )
        return out


def _current_index(data, n_blocks: int) -> np.ndarray | None:
    """The seek-index footer's block offsets when the container carries one
    for its `n_blocks` blocks, else None."""
    offsets = read_index(data)
    if offsets is None or offsets.shape[0] != n_blocks + 1:
        return None
    return offsets


def _block_offsets(data, n_blocks: int) -> np.ndarray:
    """The blocks' record offsets: the seek-index footer's when it is
    current, else (missing, or stale after an append) one header scan's,
    never a wrong seek."""
    offsets = _current_index(data, n_blocks)
    if offsets is None:
        _, offsets = scan_block_offsets(data)
    return offsets


def _container_blocks(blob, n_blocks: int):
    """A whole container's blocks for `_decode_chunks`: `_Records` at the
    footer's offsets when it is current, else the lazy header walk
    `iter_blocks` (no scan first: a truncated container raises where its
    rows stop)."""
    offsets = _current_index(blob, n_blocks)
    if offsets is None:
        return iter_blocks(blob)
    return _Records(blob, offsets[:-1])


class CorpusReader:
    """Random-access serving handle over a container file.

    Opens the container once (memory-mapped), resolves block offsets once
    (the seek-index footer when present and current, one header scan
    otherwise), and serves decoded rows on demand:

        with CorpusReader("corpus.hsct", mld, device="cuda") as reader:
            row = reader[17]                  # one block, [block_size] float32
            for row in reader.rows(100, 164): # a range, chunked + pipelined
                ...

    Rows are byte-identical to `CorpusEncoder.decode`'s.
    """

    def __init__(
        self,
        path: str,
        mld: MultilevelDictionary,
        *,
        device,
        backend: str = "auto",
        batch_size: int = 64,
        mesh=None,
    ):
        self.codec = CorpusEncoder(mld, device=device, backend=backend, batch_size=batch_size, mesh=mesh)
        self._file = open(path, "rb")
        try:
            self._data = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            self.cfg, self.n_blocks, _ = _parse_corpus_header(self._data)
            self.codec._check_geometry(self.cfg)
            self._offsets = _block_offsets(self._data, self.n_blocks)
        except BaseException:
            self.close()
            raise

    def __len__(self) -> int:
        return self.n_blocks

    def __getitem__(self, i) -> np.ndarray:
        if isinstance(i, slice):
            blocks = self._records(*i.indices(self.n_blocks)[:2])
            return self.codec._join_rows(self.cfg, blocks, len(blocks.offsets))
        i = int(i)
        if i < 0:
            i += self.n_blocks
        return next(iter(self.rows(i, i + 1)))

    def rows(self, start: int = 0, stop: int | None = None):
        """Yield decoded rows [start, stop), chunked by the codec's
        batch_size, device chunks pipelined, bounded memory."""
        blocks = self._records(start, stop)
        for chunk in self.codec._decode_chunks(self.cfg, blocks, self.cfg.decode_mode, self.cfg.rep_bits):
            yield from chunk

    def _records(self, start: int, stop: int | None) -> _Records:
        start, stop, _ = slice(start, stop).indices(self.n_blocks)
        return _Records(self._data, self._offsets[start:stop])

    def close(self) -> None:
        if getattr(self, "_data", None) is not None:
            self._data.close()
            self._data = None
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
