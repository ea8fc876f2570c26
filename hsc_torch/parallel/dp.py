"""Data-parallel block encoding and decoding — counterpart of
`hsc_tpu.parallel.dp`: blocks sharded over the mesh's 'data' axis,
dictionaries replicated, the greedy MP of each block independent, streams
gathered in original block order.

Each batch runs the single-device path's three stages on every shard:

  1. the init of the shard's input on its device (`ConvolutionalMatchingPursuit
     .init_stage`: the f32 init of its blocks or of the level below's map,
     or at an int8 level the int8 init from the level below's events);
  2. every shard's peak copy started on its device, then one wait on each
     copy's event (`utils.device_get_pipelined`) and the spec's host
     quantizer steps (`ops.encode.quantizer_steps`);
  3. the greedy loop of each shard (`ConvolutionalMatchingPursuit
     .loop_stage`: `ops.mp_kernels.mp_loop`, the CUDA kernel, on a card).

Every shard's inits are enqueued before the host reads a peak, and every
shard's loop before the host reads a stream, so shards on different cards
overlap.  The JAX package falls back to an XLA loop where its Pallas kernel
cannot host a `num_select`; the port's kernel takes every ``num_select >=
1``, so there is no such branch.  Per block the arithmetic is the local
path's, so the streams are byte-identical to it.

Spans (`utils.profiling.scope`, a no-op unless a profiler runs), each
entered once a batch (the init, peaks and loop spans once a level), none
inside another: ``hsc:mesh.upload`` (the pad and every shard's upload),
``hsc:mesh.init`` (every shard's init enqueued), ``hsc:mesh.peaks`` (the
waits on the peaks and the host quantizer steps), ``hsc:mesh.loop`` (every
shard's loop enqueued), ``hsc:mesh.handoff`` (a hierarchy's hand-off to
the next level), ``hsc:mesh.collect`` (`gather_blocks`: the waits on the
streams and their concatenation in block order).  `SHARD_BATCHES[i]`
counts the batches uploaded to shard i, as each shard's upload is queued,
one a batch whatever the levels.
"""

from __future__ import annotations

import collections
import copy
import weakref

import numpy as np
import torch

from ..device import canonical_device, to_device
from ..models.coder import ConvolutionalMatchingPursuit, HierarchicalConvolutionalSparseCoder
from ..ops.encode import EncodedBlock, quantizer_steps
from ..utils import device_get_pipelined
from ..utils.profiling import scope
from .mesh import Mesh, check_mesh_device

SHARD_BATCHES: collections.Counter = collections.Counter()

_REPLICAS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def replica(coder, dev: torch.device):
    """`coder` (a `ConvolutionalMatchingPursuit` or a
    `HierarchicalConvolutionalSparseCoder`) on device `dev`: the coder
    itself on its own device, else a deep copy with its tensors moved to
    `dev` and its `device` attributes pointing there, made once per (coder,
    device) and shared by every encoder and decoder built on the coder."""
    dev = canonical_device(dev)
    if coder.device == dev:
        return coder
    per = _REPLICAS.setdefault(coder, {})
    if dev not in per:
        rep = copy.deepcopy(coder).to(dev)
        for m in rep.modules():
            if "device" in vars(m):
                m.device = dev
        if isinstance(rep, HierarchicalConvolutionalSparseCoder):
            # the decode tables are not buffers: move them, and let the
            # integer tables be rebuilt on `dev`
            rep._rep_banks = {k: v.to(dev) for k, v in rep._rep_banks.items()}
            rep._rep_q_banks = {}
        per[dev] = rep
    return per[dev]


def pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """`a` zero-padded along axis 0 to `rows` rows."""
    pad = rows - a.shape[0]
    if pad <= 0:
        return a
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def upload_shard(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """One shard's host blocks on `dev`, queued without a host wait.  On a
    card NumPy copies them into a pinned block of PyTorch's caching host
    allocator on the calling thread, and the block is uploaded with
    ``non_blocking=True``; the allocator reuses it only once the copy has
    run.  `device.to_device` stages through ``pin_memory()``, whose copy
    runs over torch's intra-op threads: on a host whose cores are shared,
    a parallel region waits for its slowest thread, and a 4-MiB staging
    copy took from 0.03 ms to 1.8 s on a 32-core host of 4 H100s, against
    at most 0.5 ms for NumPy's copy (PERF.md §6).  Elsewhere it is
    `device.to_device`."""
    if dev.type != "cuda":
        return to_device(np.ascontiguousarray(a), dev)
    host = torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype, pin_memory=True)
    np.copyto(host.numpy(), a)
    return host.to(dev, non_blocking=True)


def multihost_split(n_global: int, n_processes: int) -> list[tuple[int, int]]:
    """Canonical block -> process assignment (`hsc_tpu`'s
    `DataParallelEncoder.multihost_split`): with ``nl = ceil(n_global /
    P)``, process p owns global blocks [p*nl, min((p+1)*nl, n_global)).
    Both endpoints clamp to n_global, so trailing processes of a short
    corpus own valid empty ranges (never inverted ones)."""
    nl = -(-n_global // max(n_processes, 1))
    return [
        (min(p * nl, n_global), min((p + 1) * nl, n_global))
        for p in range(n_processes)
    ]


def gather_blocks(encs: list[EncodedBlock], b: int) -> EncodedBlock:
    """Per-shard device `EncodedBlock`s -> one host `EncodedBlock` in shard
    (= original block) order, trimmed to `b` blocks; every shard's copies
    are started before the first wait."""
    return EncodedBlock(*(
        np.concatenate(fields)[:b] for fields in zip(*device_get_pipelined(encs))
    ))


class DataParallelEncoder:
    """Shards a batch of blocks across `mesh` axis `axis` and runs the
    batched greedy MP of `mp` on every shard; results come back in original
    block order."""

    def __init__(self, mesh: Mesh, mp: ConvolutionalMatchingPursuit, axis: str = "data"):
        check_mesh_device(mesh, mp.device, "DataParallelEncoder")
        self.mesh = mesh
        self.mp = mp
        self.axis = axis
        self.devices = mesh.axis_devices(axis)

    @property
    def num_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    def pad_batch(self, xs: np.ndarray) -> tuple[np.ndarray, int]:
        """Pad block count to a multiple of the shard count (zero blocks
        encode to empty streams and are dropped after the gather)."""
        b = xs.shape[0]
        return pad_rows(xs, b + (-b) % self.num_shards), b

    def upload(self, padded: np.ndarray) -> list[torch.Tensor]:
        """Host ``[B, ...]`` (B a multiple of the shard count) -> one
        contiguous slice of B / S blocks per shard, on its device (uploads
        queued without a host wait, `upload_shard`)."""
        per = padded.shape[0] // self.num_shards
        shards = []
        for i, dev in enumerate(self.devices):
            shards.append(upload_shard(padded[i * per : (i + 1) * per], dev))
            SHARD_BATCHES[i] += 1
        return shards

    def pad_upload(self, xs: np.ndarray) -> tuple[list[torch.Tensor], int]:
        """Host ``[B, N]`` (or ``[B, N, C]``) blocks -> (the padded shards
        on their devices, B), in one `hsc:mesh.upload` span."""
        with scope("hsc:mesh.upload"):
            xs = np.asarray(xs, dtype=np.float32)
            if xs.ndim == 2:
                xs = xs[:, :, None]
            padded, b = self.pad_batch(xs)
            return self.upload(padded), b

    def _finish(self, inits) -> list[EncodedBlock]:
        """Stages 2 and 3 on every shard's ``(scores0, e0, peak)``."""
        with scope("hsc:mesh.peaks"):
            peaks = np.concatenate(device_get_pipelined([p for _, _, p in inits]))
            scale, inv = quantizer_steps(peaks, self.mp.settings["amp_bits"])
        out, lo = [], 0
        with scope("hsc:mesh.loop"):
            for dev, (s0, e0, _) in zip(self.devices, inits):
                hi = lo + s0.shape[0]
                out.append(replica(self.mp, dev).loop_stage(s0, e0, scale[lo:hi], inv[lo:hi]))
                lo = hi
        return out

    def encode(self, xs: np.ndarray) -> EncodedBlock:
        """Encode ``[B, N]`` (or ``[B, N, C]``) blocks; B padded to shards.
        Returns one host `EncodedBlock` of B blocks."""
        shards, b = self.pad_upload(xs)
        encs = self.encode_device(shards)
        with scope("hsc:mesh.collect"):
            return gather_blocks(encs, b)

    def encode_device(self, seqs: list) -> list[EncodedBlock]:
        """Sharded-in, sharded-out encode of already-placed inputs, one a
        shard on its device, each what `ConvolutionalMatchingPursuit
        .init_stage` takes -> one device `EncodedBlock` per shard."""
        with scope("hsc:mesh.init"):
            inits = [replica(self.mp, dev).init_stage(seq) for dev, seq in zip(self.devices, seqs)]
        return self._finish(inits)

    @staticmethod
    def multihost_split(n_global: int, n_processes: int) -> list[tuple[int, int]]:
        """`multihost_split`, as the JAX package's encoder has it."""
        return multihost_split(n_global, n_processes)

    def encode_multihost(self, local_blocks: np.ndarray, n_global: int) -> EncodedBlock:
        """Multi-process encode over `torch.distributed`: every process
        passes its slice of the corpus per `multihost_split` (ragged tails
        allowed), pads it to the uniform per-process count ``nl``, encodes
        it on its local mesh, and an `all_gather` of the padded event arrays
        gives every process the whole corpus in original block order,
        trimmed to `n_global`.  The quantizer steps are per block, so each
        process computes its own from its own peaks.

        The gather makes this the small-corpus path: at scale use
        `runtime.CorpusEncoder.encode_multihost`, whose processes journal
        their shards and process 0 assembles.  With no process group, or a
        world of one, this is `encode`."""
        import torch.distributed as dist

        local_blocks = np.asarray(local_blocks, dtype=np.float32)
        if local_blocks.ndim == 2:
            local_blocks = local_blocks[:, :, None]
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return self.encode(local_blocks[:n_global])
        p, nproc = dist.get_rank(), dist.get_world_size()
        lo, hi = self.multihost_split(n_global, nproc)[p]
        if local_blocks.shape[0] != hi - lo:
            raise ValueError(
                f"process {p} must pass blocks [{lo}, {hi}) "
                f"({hi - lo} blocks); got {local_blocks.shape[0]}"
            )
        nl = -(-n_global // nproc)
        enc = self.encode(pad_rows(local_blocks, nl))
        # gloo gathers host tensors, NCCL this rank's card's
        gdev = (
            torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu")
        )
        gathered = []
        for v in enc:
            t = to_device(np.ascontiguousarray(v), gdev)
            parts = [torch.empty_like(t) for _ in range(nproc)]
            dist.all_gather(parts, t)
            gathered.append(torch.cat(parts))
        return EncodedBlock(*(f[:n_global] for f in device_get_pipelined(gathered)))


class HierarchicalDataParallelEncoder:
    """Data-parallel hierarchical corpus encode: every level's three stages
    run on every shard, and the hand-off between levels stays on the
    shard's device (an int8 level's events go straight to the next level's
    int8 init; an f32 level hands on its `feature_map`).  Nothing is
    gathered until all levels finish.  Per block the math is the local
    `HierarchicalConvolutionalSparseCoder.encode_batch_device`'s, so the
    streams are byte-identical to it."""

    def __init__(self, mesh: Mesh, coder: HierarchicalConvolutionalSparseCoder, axis: str = "data"):
        self.mesh = mesh
        self.coder = coder
        self.cfg = coder.cfg
        self.axis = axis
        self.levels = [DataParallelEncoder(mesh, c.mp, axis=axis) for c in coder.coders]

    @property
    def num_shards(self) -> int:
        return self.levels[0].num_shards

    def encode_device(self, shards: list[torch.Tensor]) -> list[list[EncodedBlock]]:
        """Per-shard ``[B_i, N, C]`` device blocks -> ``out[level][shard]``
        device `EncodedBlock`s."""
        out = []
        seq = shards
        for level, dp in enumerate(self.levels):
            out.append(dp.encode_device(seq))
            if level + 1 < self.cfg.num_levels:
                with scope("hsc:mesh.handoff"):
                    seq = [self.coder.handoff(level, e) for e in out[-1]]
        return out

    def encode(self, xs: np.ndarray) -> list[EncodedBlock]:
        """Encode ``[B, block_size]`` blocks; returns one batched host
        `EncodedBlock` per level, trimmed to the original block count."""
        shards, b = self.levels[0].pad_upload(xs)
        levels = self.encode_device(shards)
        with scope("hsc:mesh.collect"):
            return [gather_blocks(encs, b) for encs in levels]


class DataParallelDecoder:
    """Mesh-sharded batch reconstruction, the decode mirror of
    `DataParallelEncoder`: the padded stream arrays are split over the
    mesh axis and every shard runs the local decode
    (`HierarchicalConvolutionalSparseCoder._decode_device_call`: the
    integer- or ordered-decode kernel on a card) on its blocks.  Per-block
    reconstruction is independent of the batch grouping, so the rows are
    byte-identical to `reconstruct_batch_device`'s.

    The batch is padded to a multiple of the shard count with empty streams
    (count 0 decodes to zeros) and trimmed after the gather."""

    def __init__(self, mesh: Mesh, coder: HierarchicalConvolutionalSparseCoder, axis: str = "data"):
        check_mesh_device(mesh, coder.device, "DataParallelDecoder")
        self.mesh = mesh
        self.coder = coder
        self.axis = axis
        self.devices = mesh.axis_devices(axis)

    @property
    def num_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    def decode_batch_device(self, streams, level=None, mode=None, rep_bits=None) -> torch.Tensor:
        """Sharded `reconstruct_batch_device`: the rows ``[B, block_size,
        1]`` on the first shard's device, byte-identical to the local
        path's."""
        return self.decode_padded_device(*self.coder._decode_arrays(streams, level, mode), rep_bits)

    def decode_padded_device(self, pos, atm, cds, cnt, scl, level, mode, rep_bits) -> torch.Tensor:
        """`decode_batch_device` of the padded host arrays (`pad_streams`,
        `record_pack.unpack_records`): the sharded
        `HierarchicalConvolutionalSparseCoder._decode_device_call`."""
        arrays = (pos, atm, cds, cnt, scl)
        b = pos.shape[0]
        rows = b + (-b) % self.num_shards
        per = rows // self.num_shards
        arrays = [pad_rows(a, rows) for a in arrays]
        outs = [
            replica(self.coder, dev)._decode_device_call(
                *(a[i * per : (i + 1) * per] for a in arrays), level, mode, rep_bits
            )
            for i, dev in enumerate(self.devices)
        ]
        return torch.cat([o.to(self.devices[0]) for o in outs])[:b]
