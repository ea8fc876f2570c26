"""The distributed representation: a frozen writer and the per-level decode.

In a hierarchy, a top-level event whose atom is a singleton (at level k,
atom index ``counts[k] + s``: a unit delta at offset 0 on channel s of
level k - 1) decodes to exactly the level-(k-1) atom s at the same position
and code, so it can be stored one level down; repeated until the atom is
raw at its level (every level-0 atom is raw).  A block record of the
distributed form holds one stream a non-empty level, ascending, each with
the top stream's quantizer scale; within a level the events keep their
relative order (docs/FORMAT.md: "Distributed representations may carry
several levels; the decoder sums level reconstructions in block order").

The writer makes the restore-levels cell's container from top-level events
the benchmark draws itself; `decode_levels` is the reference's row of one
block: every stream's integer decode through its own level's quantized
representations, summed into a zero row in container order.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import container, spec
from .config import CodecConfig
from .dictionary import MultilevelDictionary

_STREAM_HEAD = np.dtype([("level", "u1"), ("n", "<u4"), ("scale", "<f4")])


def native_levels(cfg: CodecConfig, atoms: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(levels, atoms)`` of top-level atoms ``[...]``: each event's level
    once demoted through its singleton chain, and its atom there."""
    atoms = np.asarray(atoms, np.int64).copy()
    levels = np.full(atoms.shape, cfg.num_levels - 1, np.int64)
    for k in range(cfg.num_levels - 1, 0, -1):
        down = (levels == k) & (atoms >= cfg.counts[k])
        atoms[down] -= cfg.counts[k]
        levels[down] = k - 1
    return levels, atoms


def records_distributed(cfg: CodecConfig, positions, atoms, codes, scales) -> list[bytes]:
    """One block record a block, in the distributed form, from top-level
    events ``[B, n]`` (positions, atoms, codes) and scales ``[B]``.  Blocks
    with the same event count at every level are packed together."""
    positions = np.asarray(positions, np.int64)
    codes = np.asarray(codes, np.int64)
    scales = np.asarray(scales, np.float32)
    b, n = positions.shape
    levels, atoms = native_levels(cfg, atoms)
    # stable: each level's events in their order in the top stream
    order = np.argsort(levels, axis=1, kind="stable")
    levels, positions, atoms, codes = (np.take_along_axis(a, order, 1) for a in (levels, positions, atoms, codes))
    per_level = np.stack([(levels == k).sum(1) for k in range(cfg.num_levels)], 1)  # [B, L]
    out: list[bytes] = [b""] * b
    groups, inverse = np.unique(per_level, axis=0, return_inverse=True)
    for g, counts in enumerate(groups):
        ids = np.nonzero(inverse.reshape(-1) == g)[0]
        present = [k for k in range(cfg.num_levels) if counts[k]]
        parts = [np.full((len(ids), 1), len(present), np.uint8)]
        col = 0
        for k in range(cfg.num_levels):
            m = int(counts[k])
            if not m:
                continue
            head = np.empty(len(ids), _STREAM_HEAD)
            head["level"], head["n"], head["scale"] = k, m, scales[ids]
            parts.append(head.view(np.uint8).reshape(len(ids), _STREAM_HEAD.itemsize))
            sl = (ids, slice(col, col + m))
            vals = np.stack([positions[sl], atoms[sl], codes[sl] + cfg.amp_maxcode], axis=-1)
            widths = [cfg.pos_bits(k), cfg.atom_bits(k), cfg.amp_bits]
            parts.append(np.packbits(container._bits(vals, widths), axis=-1))
            col += m
        for i, rec in zip(ids, np.concatenate(parts, axis=1)):
            out[i] = rec.tobytes()
    return out


def write_records(cfg: CodecConfig, records: list[bytes], f) -> int:
    """Write header, `records` (of any lengths) and the seek index to the
    open binary file `f`; returns the bytes written."""
    head = container.header(cfg, len(records))
    sizes = np.array([len(r) for r in records], np.int64)
    offsets = len(head) + np.concatenate([[0], np.cumsum(sizes)])
    foot = container.index_footer(offsets)
    f.write(head)
    f.write(b"".join(records))
    f.write(foot)
    return int(offsets[-1]) + len(foot)


def _tables(mld: MultilevelDictionary, levels) -> dict[int, tuple[np.ndarray, np.float32]]:
    return {k: spec.rep_quantize(mld.representations(k)[:, :, None], mld.config.rep_bits) for k in set(levels)}


def decode_levels(cfg: CodecConfig, mld: MultilevelDictionary, data, block: int, *, bfloat16: bool = False,
                  top_reps: bool = False) -> np.ndarray:
    """The reference's row of `block`: a zero row plus each stream's
    integer decode, in container order, each through its own level's
    representations quantized at ``rep_bits``.

    The two controls: `bfloat16` takes each stream's epilogue (its exact
    integer sums times ``scale * step``) in bfloat16, the next precision
    below the float32 the codec states; `top_reps` decodes every stream
    through the top level's representations, as a one-level judge would."""
    offsets = container.read_index(data)
    streams, _ = container.read_block(cfg, data, int(offsets[block]))
    top = cfg.num_levels - 1
    tables = _tables(mld, [top if top_reps else s.level for s in streams])
    row = np.zeros(cfg.block_size, np.float32)
    for s in streams:
        rep_q, step = tables[top if top_reps else s.level]
        if bfloat16:
            exact = spec.int_decode(s.positions, s.atoms, s.codes, np.float32(1), rep_q, np.float32(1),
                                    cfg.block_size)
            amp = torch.tensor(float(np.float32(np.float32(s.scale) * np.float32(step))), dtype=torch.bfloat16)
            row += (torch.as_tensor(exact).to(torch.bfloat16) * amp).float().numpy()
        else:
            row += spec.int_decode(s.positions, s.atoms, s.codes, s.scale, rep_q, step, cfg.block_size)
    return row


def stream_faults(cfg: CodecConfig, data, block: int) -> int:
    """1 where `block`'s record is not one stream a level, ascending, each
    with one scale, else 0."""
    try:
        offsets = container.read_index(data)
        streams, _ = container.read_block(cfg, data, int(offsets[block]))
    except (ValueError, struct.error, TypeError):
        return 1
    levels = [s.level for s in streams]
    ok = bool(streams) and levels == sorted(set(levels)) and len({float(s.scale) for s in streams}) == 1
    return int(not ok)
