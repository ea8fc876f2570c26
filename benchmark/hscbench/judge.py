"""The comparison that decides `correct`: what the timed path produced,
judged by the plain reference (`benchmark/reference`).

Encodes (the ingest cells): every container of the window is parsed by the
reference's frozen reader (header, block count, seek index, every record's
stream headers); in a sample of blocks drawn from the seed, the port's
events are replayed on the reference's float64 scores (`spec.replay`).
In a hierarchy the container holds the top level only; its level-0 events
come from the port's own single-level encode of the same 64-block batch
(`level0_follow` in the ingest client), whose events are judged the same
way before the reference builds level 1's exact init from them.

Restores: the rows of a sample of blocks, drawn from the seed, are compared
bit for bit with the reference's integer decode of the same container
bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import container, spec
from reference.config import CodecConfig
from reference.dictionary import MultilevelDictionary

# The sample judged: a share STORE_SHARE of the window's calls, drawn from
# the seed, copy what they produced into a store of STORE_MB allocated at
# set-up.  An ingest call stores its container, which is parsed, and CALLS
# of the stored containers have the configuration's `judge.blocks_per_call`
# blocks replayed; a restore call stores the rows of that many blocks.
STORE_MB = 512
STORE_SHARE = 0.2
CALLS = 2


def container_faults(cfg: CodecConfig, blob: bytes, n_blocks: int) -> list[str]:
    """What is wrong with one container's structure (empty when nothing)."""
    try:
        got, n, _ = container.parse_header(blob)
        if got.to_json() != cfg.to_json():
            return ["header config differs from the cell's"]
        if n != n_blocks:
            return [f"{n} blocks, not {n_blocks}"]
        _, walked = container.block_offsets(blob)
        index = container.read_index(blob)
        if index is None or not np.array_equal(index, walked):
            return ["seek index missing or not the records' offsets"]
        end = len(blob) - (len(container.index_footer(walked)))
        if walked[-1] != end:
            return ["bytes between the last record and the index"]
    except (ValueError, UnicodeDecodeError) as e:
        return [f"unparseable: {e}"]
    return []


def top_streams(cfg: CodecConfig, blob: bytes, blocks: list[int]) -> list[container.Stream]:
    offsets = container.read_index(blob)
    out = []
    for b in blocks:
        streams, _ = container.read_block(cfg, blob, int(offsets[b]))
        if len(streams) != 1 or streams[0].level != cfg.num_levels - 1:
            raise ValueError(f"block {b}: not one top-level stream")
        out.append(streams[0])
    return out


class EncodeJudge:
    """The reference's tables for one dictionary, in float64 on `device`."""

    def __init__(self, mld: MultilevelDictionary, device):
        self.cfg = mld.config
        self.mld = mld
        self.device = torch.device(device)
        cfg = self.cfg
        self.bank0 = torch.as_tensor(mld.augmented(0), dtype=torch.float64, device=self.device)
        self.gram0 = spec.gram(self.bank0)
        self.w0 = torch.ones(cfg.counts[0], dtype=torch.float64, device=self.device)
        if cfg.num_levels > 1:
            if cfg.num_levels > 2 or cfg.hier_init != "int8":
                raise ValueError("the reference judges one level, or two with the int8 init")
            aug1 = mld.augmented(1)
            self.bank1_raw = aug1[: cfg.counts[1]]
            self.gram1 = spec.gram(torch.as_tensor(aug1, dtype=torch.float64, device=self.device))
            self.w1 = torch.as_tensor(
                np.where(np.arange(aug1.shape[0]) < cfg.counts[1], 1.0, cfg.singleton_weight),
                dtype=torch.float64, device=self.device,
            )
        if cfg.tolerance_snr is not None:
            raise ValueError("the reference replays no SNR stop")

    def scores0(self, x: np.ndarray) -> torch.Tensor:
        return spec.correlate(torch.as_tensor(x, dtype=torch.float64, device=self.device), self.bank0)

    def judge(self, signals, tops, level0=None) -> dict:
        """Readings over the blocks `signals` (``[N]`` each) with the port's
        top streams `tops` and, in a hierarchy, its level-0 streams."""
        out = {"gap_steps_l0": 0.0, "scale_gap_rel": 0.0, "unplaced_events": 0}
        if self.cfg.num_levels > 1:
            out["gap_steps_l1"] = 0.0
        for i, x in enumerate(signals):
            l0 = tops[i] if self.cfg.num_levels == 1 else level0[i]
            r0 = spec.replay(self.scores0(x), self.gram0, self.w0, l0, self.cfg, 0)
            runs = [(0, r0)]
            if self.cfg.num_levels > 1:
                s1 = spec.level1_scores(l0.positions, l0.atoms, l0.codes, l0.scale, self.cfg, self.bank1_raw,
                                        self.device)
                runs.append((1, spec.replay(s1, self.gram1, self.w1, tops[i], self.cfg, 1)))
            for level, r in runs:
                key = f"gap_steps_l{level}"
                out[key] = max(out[key], r["sel"], r["code"], r["skip"])
                gap = abs(r["scale"] / r["ref_scale"] - 1.0) if r["ref_scale"] > 0 else float("inf")
                out["scale_gap_rel"] = max(out["scale_gap_rel"], gap)
                out["unplaced_events"] += r["unplaced"]
        return out

    def control(self, x: np.ndarray) -> tuple[container.Stream, container.Stream]:
        """The reference put in the program's place at the next precision
        below the configuration's: the level-0 correlation of TF32-rounded
        inputs (float32 stated), then the spec's float32 loop; at level 1
        the init from a bank of int8 codes, one digit plane, where the spec
        takes int16 codes in two int8 planes.  Returns (level-0 stream, top
        stream)."""
        cfg = self.cfg
        dev = self.device
        xt = spec.tf32(torch.as_tensor(x, dtype=torch.float32, device=dev))
        bt = spec.tf32(torch.as_tensor(self.mld.augmented(0), dtype=torch.float32, device=dev))
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            s0 = spec.correlate(xt, bt).cpu().numpy()
        g0 = self.gram0.float().cpu().numpy()
        p, a, c, scale = spec.spec_loop_f32(s0, g0, np.ones(cfg.counts[0], np.float32), cfg, 0)
        l0 = container.Stream(0, p, a, c, scale)
        if cfg.num_levels == 1:
            return l0, l0
        s1 = spec.level1_scores(p, a, c, scale, cfg, self.bank1_raw, dev, bank_maxcode=127).float().cpu().numpy()
        p1, a1, c1, scale1 = spec.spec_loop_f32(s1, self.gram1.float().cpu().numpy(),
                                                self.w1.float().cpu().numpy(), cfg, 1)
        return l0, container.Stream(1, p1, a1, c1, scale1)


def judge_rows(cfg: CodecConfig, mld: MultilevelDictionary, data, kept) -> dict:
    """Bit-for-bit comparison of the kept rows, ``(block, row)`` pairs, with
    the reference's integer decode of the same container bytes: the number
    of float32 values that differ."""
    reps = mld.representations(cfg.num_levels - 1)[:, :, None]
    rep_q, step = spec.rep_quantize(reps, cfg.rep_bits)
    offsets = container.read_index(data)
    mismatch = 0
    for block, row in kept:
        streams, _ = container.read_block(cfg, data, int(offsets[block]))
        ref = np.zeros(cfg.block_size, np.float32)
        for s in streams:
            ref += spec.int_decode(s.positions, s.atoms, s.codes, s.scale, rep_q, step, cfg.block_size)
        mismatch += int(np.count_nonzero(ref.view(np.uint32) != row.view(np.uint32)))
    return {"rows_mismatch": mismatch}


def bf16_row(cfg: CodecConfig, mld: MultilevelDictionary, data, block: int) -> np.ndarray:
    """The control of the restore cell: the reference's integer decode of
    one block with its float32 epilogue (integer sum times the step) in
    bfloat16."""
    reps = mld.representations(cfg.num_levels - 1)[:, :, None]
    rep_q, step = spec.rep_quantize(reps, cfg.rep_bits)
    offsets = container.read_index(data)
    row = np.zeros(cfg.block_size, np.float32)
    streams, _ = container.read_block(cfg, data, int(offsets[block]))
    for s in streams:
        exact = spec.int_decode(s.positions, s.atoms, s.codes, np.float32(1), rep_q, np.float32(1), cfg.block_size)
        amp = torch.tensor(float(np.float32(np.float32(s.scale) * np.float32(step))), dtype=torch.bfloat16)
        row += (torch.as_tensor(exact).to(torch.bfloat16) * amp).float().numpy()
    return row
