"""Per-level diagnostic views of encoded corpora.

Reference parity (SURVEY.md §2 C9 `hsc/analysis.py :: visualize*`, §5
"metrics/logging": the reference plots per-level energies and coefficient
statistics alongside its rate curves).  These run on unpacked containers
(lists of per-block ``[(level, stream)]``), so they work on any corpus the
codec produced — top-level-only or distributed — with no re-encode.

The port's own copy of `hsc_tpu/analysis/diagnostics.py` (NumPy and the
port's `oracle`), verbatim; tests/test_torch_copies.py holds it equal to the
original statement for statement.
"""

from __future__ import annotations

import numpy as np

from ..config import CodecConfig
from ..dictionary import MultilevelDictionary
from ..oracle import mp_decode
from ..oracle.mp import to_distributed


def _expand_distributed(cfg: CodecConfig, blocks):
    """Demote each block's events to their native level (`to_distributed`)
    so top-level-only containers — the codec's storage default — still get
    per-level views.  Idempotent on already-distributed pairs (a distributed
    stream's atoms are raw at its level, so nothing demotes again)."""
    for block in blocks:
        out = []
        for level, stream in block:
            if level > 0:
                out.extend(to_distributed(cfg, stream, level))
            else:
                out.append((level, stream))
        yield out


def level_energies(
    mld: MultilevelDictionary, blocks, distributed: bool = False
) -> dict[int, dict[str, float]]:
    """Per-level signal-space reconstruction energy over a corpus.

    `blocks`: iterable of per-block ``[(level, stream)]`` lists
    (`io.unpack_corpus` output).  Each level's streams are reconstructed
    through that level's signal-space representations and the energy
    (sum of squares) accumulated; `fraction` is each level's share of the
    summed per-level energies (cross-level interference terms excluded by
    construction).  Returns {level: {energy, events, fraction}}.

    `distributed=True` first demotes singleton-chain events to their native
    level, so a top-level-only container reports where the events actually
    live in the hierarchy rather than one top-level row.
    """
    cfg = mld.config
    if distributed:
        blocks = _expand_distributed(cfg, blocks)
    acc: dict[int, dict[str, float]] = {}
    for block in blocks:
        for level, stream in block:
            reps = mld.representations(level)[:, :, None]
            x = mp_decode(stream, reps, cfg.block_size)
            d = acc.setdefault(level, {"energy": 0.0, "events": 0})
            d["energy"] += float(np.sum(np.square(x, dtype=np.float64)))
            d["events"] += int(stream.positions.shape[0])
    total = sum(d["energy"] for d in acc.values()) or 1.0
    for d in acc.values():
        d["fraction"] = d["energy"] / total
    return acc


def coefficient_distribution(
    cfg: CodecConfig, blocks, distributed: bool = False
) -> dict[int, dict[str, object]]:
    """Per-level coefficient statistics over a corpus: quantized |code|
    histogram summary, atom-usage counts, and position-delta summary —
    the inputs the reference eyeballs when tuning sparsity targets.

    Returns {level: {events, codes_abs_mean, codes_abs_p50, codes_abs_p95,
    atom_usage [K], delta_mean}}.  `distributed=True` demotes events to
    their native level first (see `level_energies`).
    """
    if distributed:
        blocks = _expand_distributed(cfg, blocks)
    per: dict[int, dict[str, list]] = {}
    for block in blocks:
        for level, stream in block:
            d = per.setdefault(level, {"codes": [], "atoms": [], "deltas": []})
            codes = np.asarray(stream.codes, dtype=np.int64)
            pos = np.sort(np.asarray(stream.positions, dtype=np.int64))
            d["codes"].append(np.abs(codes))
            d["atoms"].append(np.asarray(stream.atoms, dtype=np.int64))
            if pos.shape[0] > 1:
                d["deltas"].append(np.diff(pos))
    out: dict[int, dict[str, object]] = {}
    for level, d in per.items():
        codes = (
            np.concatenate(d["codes"]) if d["codes"] else np.zeros(0, np.int64)
        )
        atoms = (
            np.concatenate(d["atoms"]) if d["atoms"] else np.zeros(0, np.int64)
        )
        deltas = (
            np.concatenate(d["deltas"]) if d["deltas"] else np.zeros(0, np.int64)
        )
        k = cfg.counts_with_singletons[level]
        out[level] = {
            "events": int(codes.shape[0]),
            "codes_abs_mean": float(codes.mean()) if codes.size else 0.0,
            "codes_abs_p50": float(np.percentile(codes, 50)) if codes.size else 0.0,
            "codes_abs_p95": float(np.percentile(codes, 95)) if codes.size else 0.0,
            "atom_usage": np.bincount(atoms, minlength=k).tolist(),
            "delta_mean": float(deltas.mean()) if deltas.size else 0.0,
        }
    return out


def visualize_level_diagnostics(
    mld: MultilevelDictionary, blocks, path: str | None = None,
    distributed: bool = False,
):
    """One figure: per-level energy shares, atom-usage profiles, and |code|
    distributions (reference `hsc/analysis.py :: visualize*` breadth)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if distributed:
        blocks = _expand_distributed(mld.config, blocks)
    blocks = list(blocks)
    energies = level_energies(mld, blocks)
    dist = coefficient_distribution(mld.config, blocks)
    levels = sorted(set(energies) | set(dist))
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))

    ax = axes[0]
    fracs = [energies.get(l, {}).get("fraction", 0.0) for l in levels]
    ax.bar([str(l) for l in levels], fracs)
    ax.set_xlabel("level")
    ax.set_ylabel("reconstruction energy share")
    ax.set_title("per-level energy")

    ax = axes[1]
    for l in levels:
        usage = np.asarray(dist[l]["atom_usage"], dtype=np.float64)
        if usage.sum():
            usage = usage / usage.sum()
        ax.plot(np.sort(usage)[::-1], label=f"level {l}")
    ax.set_xlabel("atom rank")
    ax.set_ylabel("usage share")
    ax.set_title("atom usage (sorted)")
    ax.legend()

    ax = axes[2]
    for l in levels:
        codes = []
        for block in blocks:
            for level, stream in block:
                if level == l:
                    codes.append(np.abs(np.asarray(stream.codes)))
        if codes:
            allc = np.concatenate(codes)
            if allc.size:
                ax.hist(
                    allc, bins=40, histtype="step", density=True,
                    label=f"level {l}",
                )
    ax.set_xlabel("|quantized code|")
    ax.set_ylabel("density")
    ax.set_title("coefficient distribution")
    ax.legend()

    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
    return fig
