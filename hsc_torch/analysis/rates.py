"""Information-rate / distortion-rate accounting.

Reference parity (SURVEY.md §2 C9): `hsc/analysis.py ::
calculateBitForDatatype, calculateInformationRate(s),
calculateMultilevelInformationRates, visualize*` — bits per retained
coefficient (amplitude + atom-index + position bits), per-level and total
rates, SNR-vs-rate curves comparing flat vs hierarchical coding.

Difference from the reference: the reference *estimates* bits (it never
serializes); here the accounting is exact by construction — the event widths
are the genuine bitstream field widths (`CodecConfig.event_bits`), and
`stream_rate` agrees with `io.bitstream.stream_num_bytes` to the byte.

The port's own copy of `hsc_tpu/analysis/rates.py`, verbatim but for the
`use_device` branch of `rate_distortion_curve`, which encodes with the
port's coder and decodes with `ops.decode_kernel.mp_decode_batch` on
``device`` (the ordered-decode kernel on a card, its plain version on the
CPU); tests/test_torch_copies.py holds the rest equal to the original
statement for statement.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..config import CodecConfig
from ..io.bitstream import stream_num_bytes
from ..oracle.mp import LevelStream


def bits_for_dtype(dtype) -> int:
    """Bits to store one amplitude of `dtype` raw (reference:
    `hsc/analysis.py :: calculateBitForDatatype`)."""
    return int(np.dtype(dtype).itemsize * 8)


@dataclasses.dataclass(frozen=True)
class RateReport:
    level: int
    n_events: int
    payload_bits: int
    total_bytes: int  # includes stream header (level, count, scale)
    bits_per_event: float
    bits_per_sample: float
    snr_db: float


def stream_rate(cfg: CodecConfig, level: int, stream: LevelStream) -> RateReport:
    """Exact rate accounting for one level stream of one block (for 'rice'
    entropy the stream is serialized to measure its true variable length)."""
    n = int(stream.positions.shape[0])
    eb = cfg.event_bits(level)
    if cfg.entropy == "rice":
        from ..io.bitstream import RICE_HEADER_BYTES, pack_stream

        total = len(pack_stream(cfg, level, stream))
        payload_bits = (total - RICE_HEADER_BYTES) * 8
        eb = payload_bits / max(n, 1)
    else:
        payload_bits = n * eb
        total = stream_num_bytes(cfg, level, n)
    if stream.energy0 > 0 and stream.energy_res > 0:
        snr = 10.0 * math.log10(stream.energy0 / stream.energy_res)
    elif stream.energy0 > 0:
        snr = float("inf")
    else:
        snr = float("nan")
    return RateReport(
        level=level,
        n_events=n,
        payload_bits=payload_bits,
        total_bytes=total,
        bits_per_event=float(eb),
        bits_per_sample=payload_bits / cfg.block_size,
        snr_db=snr,
    )


def corpus_rates(cfg: CodecConfig, blocks) -> dict:
    """Aggregate rates over a packed corpus (reference:
    `hsc/analysis.py :: calculateInformationRates` aggregate form).
    `blocks` may be a list or a lazy iterator of per-block
    ``[(level, stream)]`` lists (`io.iter_blocks`) — one block's events in
    memory at a time, so `info` scales to mmap'd containers."""
    total_bytes = 0
    total_events = 0
    n_blocks = 0
    per_level: dict[int, int] = {}
    for streams in blocks:
        n_blocks += 1
        for level, stream in streams:
            r = stream_rate(cfg, level, stream)
            total_bytes += r.total_bytes
            total_events += r.n_events
            per_level[level] = per_level.get(level, 0) + r.payload_bits
    total_samples = cfg.block_size * n_blocks
    return {
        "total_bytes": total_bytes,
        "total_events": total_events,
        "bits_per_sample": 8.0 * total_bytes / max(total_samples, 1),
        "per_level_payload_bits": per_level,
        "compression_ratio": (4.0 * total_samples) / max(total_bytes, 1),
    }


def multilevel_information_rates(
    cfg: CodecConfig, streams: list[LevelStream]
) -> list[RateReport]:
    """Per-level reports for one block's distributed representation
    (reference: `hsc/analysis.py :: calculateMultilevelInformationRates`)."""
    return [stream_rate(cfg, k, s) for k, s in enumerate(streams)]


def rate_distortion_curve(
    mld,
    xs: np.ndarray,
    budgets: list[int],
    *,
    use_device: bool = False,
    device="cuda",
) -> list[tuple[float, float]]:
    """(bits/sample, SNR dB) at a sweep of coefficient budgets — the
    SNR-vs-rate research curve of the reference paper (flat, level-0 form).

    Distortion definition differs by mode (compare curves within one mode):
    `use_device=False` reports the encoder-TRACKED residual energy ratio
    (`energy0 / energy_res`, the float32 update recursion — the reference's
    metric); `use_device=True` reports the TRUE reconstruction SNR
    (``|x|^2 / |x - decode(prefix)|^2`` from an actual batched decode).  The
    two agree to ~0.1 dB (closed-loop quantization keeps the tracked
    residual honest; `tests/test_analysis.py` pins the tolerance) but are
    not bit-comparable.

    `use_device=False` runs the NumPy oracle per (budget, block).
    `use_device=True` exploits the greedy prefix property (the first k
    events of a budget-N encode ARE the budget-k encode — selection never
    looks ahead): the whole corpus is encoded ONCE at max(budgets) on
    `device` (the greedy-loop kernel on a card), every smaller budget is a
    truncation of that event list, and distortion comes from one batched
    ordered decode per budget (`ops.decode_kernel.mp_decode_batch`).
    """
    from ..oracle.mp import mp_encode

    cfg = mld.config
    bank = mld.augmented(0)
    gram = mld.gram(0)
    out = []
    if use_device:
        import torch

        from ..models.coder import ConvolutionalMatchingPursuit
        from ..ops.decode_kernel import mp_decode_batch

        mp = ConvolutionalMatchingPursuit(
            bank, gram, num_coefs=max(budgets), amp_bits=cfg.amp_bits,
            device=device,
        )
        enc = mp.compute_coefficients_batch(xs[:, :, None])
        count = enc.count.cpu().numpy()
        e0 = np.sum(np.square(xs.astype(np.float32)), axis=1, dtype=np.float64)
        for budget in budgets:
            counts = np.minimum(count, budget).astype(np.int32)
            recon = mp_decode_batch(
                enc.positions, enc.atoms, enc.codes,
                torch.from_numpy(counts).to(mp.device), enc.scale, mp.bank,
                n=cfg.block_size,
            ).cpu().numpy()[:, :, 0]
            err = xs.astype(np.float32) - recon
            den = float(np.sum(np.square(err, dtype=np.float64))) or 1e-20
            bits = int(np.sum(counts)) * cfg.event_bits(0)
            out.append(
                (
                    bits / (xs.shape[0] * cfg.block_size),
                    10.0 * math.log10(float(np.sum(e0)) / den),
                )
            )
        return out
    for budget in budgets:
        bits = 0
        num = 0.0
        den = 0.0
        for b in range(xs.shape[0]):
            stream = mp_encode(
                xs[b][:, None], bank, gram, num_coefs=budget,
                amp_bits=cfg.amp_bits,
            )
            bits += stream.positions.shape[0] * cfg.event_bits(0)
            num += stream.energy0
            den += max(stream.energy_res, 1e-20)
        out.append((bits / (xs.shape[0] * cfg.block_size), 10.0 * math.log10(num / den)))
    return out


def hierarchical_rate_distortion_curve(
    mld, xs: np.ndarray, top_budgets: list[int]
) -> list[tuple[float, float]]:
    """(bits/sample, signal SNR dB) of the hierarchical codec at a sweep of
    top-level coefficient budgets — the hierarchical side of the reference's
    flat-vs-hierarchical comparison (`hsc/analysis.py ::
    calculateMultilevelInformationRates`).  Bits counted for the top stream
    only (the compressed representation); runs the NumPy oracle.
    """
    import dataclasses

    from ..oracle.mp import mp_encode
    from ..oracle import hierarchical_encode, hierarchical_decode
    from ..io.bitstream import pack_stream

    cfg0 = mld.config
    top = cfg0.num_levels - 1
    out = []
    for budget in top_budgets:
        nc = tuple(
            list(cfg0.num_coefs[:top]) + [int(budget)]
        )
        cfg = dataclasses.replace(cfg0, num_coefs=nc)
        mld_b = type(mld)(cfg, [d.copy() for d in mld.dicts])
        bits = 0
        num = 0.0
        den = 0.0
        for b in range(xs.shape[0]):
            streams = hierarchical_encode(xs[b], mld_b)
            bits += 8 * len(pack_stream(cfg, top, streams[top]))
            recon = hierarchical_decode(streams[top], mld_b)
            ref = xs[b].astype(np.float64)
            err = ref - recon
            num += float(np.sum(ref * ref))
            den += float(np.sum(err * err)) or 1e-20
        out.append(
            (bits / (xs.shape[0] * cfg.block_size), 10.0 * math.log10(num / den))
        )
    return out


def decode_mode_fidelity(
    mld,
    xs: np.ndarray,
    rep_bits_list: tuple[int, ...] = (6, 8, 10, 12),
) -> list[dict]:
    """SNR cost of decode_mode='integer' vs 'ordered' at a sweep of
    `rep_bits` — the decode-mode decision table.

    The two modes read the SAME stream bytes (decode_mode is a header field;
    the payload is identical), so the rate axis is unchanged and the entire
    cost of the 20-28x-faster integer decoder is reconstruction SNR: integer
    mode quantizes the atom representations to rep_bits
    (`oracle.mp.rep_quantize`) before the order-free exact-integer
    overlap-add.  Rows:

      {"mode": "ordered", "snr_db": s}                       — the v1 surface
      {"mode": "integer", "rep_bits": r, "snr_db": s,
       "delta_db": s - ordered_snr,                          — cost vs ordered
       "vs_ordered_db": SNR of integer recon vs ordered recon}

    Runs the NumPy oracle (the spec); device decoders are byte-identical to
    it, so the table transfers.  Encodes each block once at the top level and
    reuses the stream across every row (the modes differ only in decode).
    """
    from ..oracle import hierarchical_encode
    from ..oracle.mp import hierarchical_decode, mp_decode_integer, rep_quantize

    cfg = mld.config
    top = cfg.num_levels - 1
    xs = np.asarray(xs, dtype=np.float32)
    streams = [hierarchical_encode(x, mld)[top] for x in xs]
    ref = xs.astype(np.float64)
    e_sig = float(np.sum(ref * ref)) or 1e-20

    def snr(num: float, den: float) -> float:
        return 10.0 * math.log10(max(num, 1e-20) / max(den, 1e-20))

    ordered = np.stack(
        [hierarchical_decode(s, mld) for s in streams]
    ).astype(np.float64)
    e_ord = float(np.sum(np.square(ref - ordered)))
    out = [{"mode": "ordered", "snr_db": round(snr(e_sig, e_ord), 3)}]
    reps = mld.representations(top)[:, :, None]
    for rb in rep_bits_list:
        rep_q, step = rep_quantize(reps, int(rb))
        rec = np.stack(
            [
                mp_decode_integer(s, rep_q, step, cfg.block_size)[:, 0]
                for s in streams
            ]
        ).astype(np.float64)
        e_int = float(np.sum(np.square(ref - rec)))
        e_ord_sum = float(np.sum(ordered * ordered)) or 1e-20
        e_vs = float(np.sum(np.square(ordered - rec)))
        row = {
            "mode": "integer",
            "rep_bits": int(rb),
            "snr_db": round(snr(e_sig, e_int), 3),
            "delta_db": round(snr(e_sig, e_int) - snr(e_sig, e_ord), 3),
            "vs_ordered_db": round(snr(e_ord_sum, e_vs), 2),
        }
        out.append(row)
    return out


def visualize_rate_distortion(curves: dict[str, list[tuple[float, float]]], path=None):
    """Plot SNR-vs-rate curves (reference: `hsc/analysis.py :: visualize*`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    for name, pts in curves.items():
        pts = sorted(pts)
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=name)
    ax.set_xlabel("bits / sample")
    ax.set_ylabel("SNR (dB)")
    ax.grid(True, alpha=0.3)
    ax.legend()
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
    return fig
