"""The plain reference: the codec's arithmetic in float64 and NumPy, and the
forced replay that judges the port's events.

Nothing here imports the program.  Every table is worked out again from the
dictionaries and signals the benchmark made (the spec's quantizers are
copied verbatim from the port's NumPy oracle, `hsc_torch/oracle/mp.py`).

How an encode is judged.  The greedy loop is a sequence of argmax
decisions, so two correct encoders that round differently (cuDNN's float32
conv against an exact correlation) may part at a near tie and then follow
different, equally valid paths.  The reference therefore does not compare
event lists.  It replays the port's own events, sweep by sweep, on exact
(float64) scores of its own, and at every decision reads how far the
port's choice lies from the reference's best, in quantizer steps:

- an accepted event: the reference's best weighted score in the event's
  segment minus the weighted score of the event (``sel``), and how far the
  event's code lies outside the rounding of the reference's score
  (``code``: ``|code - s / scale| - 0.5``);
- a segment the port skipped: how far the reference's best in it lies from
  the nearest candidate that a correct loop would skip (one inside the
  interference guard, or one whose code rounds to 0) (``skip``).

A correct float32 port reads a few hundredths of a step; an encoder whose
scores carry a relative error e reads about ``e * 32767`` steps near the
peak (TF32's 2^-11 gives several steps).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import CodecConfig

BANK_MAXCODE_INT16 = 32639


def _quantize(bank: np.ndarray, maxcode) -> tuple[np.ndarray, np.float32]:
    bank = np.asarray(bank, dtype=np.float32)
    maxcode = np.float32(maxcode)
    peak = np.float32(np.max(np.abs(bank))) if bank.size else np.float32(0)
    if not peak > 0:
        return np.zeros(bank.shape, np.int32), np.float32(0)
    step = np.float32(peak / maxcode)
    inv = np.float32(maxcode / peak)
    y = (bank * inv).astype(np.float32)
    r = np.floor(np.abs(y) + np.float32(0.5)).astype(np.float32) * np.sign(y)
    return np.clip(r, -maxcode, maxcode).astype(np.int32), step


def rep_quantize(bank: np.ndarray, rep_bits: int) -> tuple[np.ndarray, np.float32]:
    """The integer-decode table of a representation bank (the spec's
    `oracle.mp.rep_quantize`)."""
    return _quantize(bank, (1 << rep_bits) - 1)


def bank_quantize_int16(bank: np.ndarray) -> tuple[np.ndarray, np.float32]:
    """The int16 codes of a level's raw bank for the int8 init (the spec's
    `oracle.mp.bank_quantize_int16`)."""
    return _quantize(bank, BANK_MAXCODE_INT16)


def int_decode(positions, atoms, codes, scale, rep_q: np.ndarray, step, n: int) -> np.ndarray:
    """Integer decode of one single-channel stream: exact integer sums of
    ``code * rep_q[atom]`` reduced mod 2^32, times ``f32(scale * step)``."""
    k, w = rep_q.shape[:2]
    rq = rep_q.reshape(k, w).astype(np.int64)
    acc = np.zeros(n, np.int64)
    if len(positions):
        idx = np.asarray(positions, np.int64)[:, None] + np.arange(w)
        np.add.at(acc, idx, np.asarray(codes, np.int64)[:, None] * rq[np.asarray(atoms, np.int64)])
    wrapped = ((acc + (1 << 31)) % (1 << 32)) - (1 << 31)
    amp_step = np.float32(np.float32(scale) * np.float32(step))
    return (wrapped.astype(np.float32) * amp_step).astype(np.float32)


def correlate(x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Valid-mode correlation scores ``[K, npos]`` of a one-channel block
    ``x [N]`` against ``bank [K, W, 1]``, in the dtype of the inputs."""
    return F.conv1d(x[None, None, :], bank[:, :, 0][:, None, :])[0]


def gram(bank: torch.Tensor) -> torch.Tensor:
    """``G[f, g, d] = sum_{u,c} A[f,u,c] A[g, u + d - (W-1), c]`` of a
    ``[K, W, C]`` bank, d in [0, 2W-2], in the bank's dtype."""
    k, w, c = bank.shape
    a = bank.permute(0, 2, 1)  # [K, C, W]
    padded = F.pad(a, (w - 1, w - 1))
    return F.conv1d(padded, a).permute(1, 0, 2).contiguous()


def level1_scores(positions, atoms, codes, scale0, cfg: CodecConfig, bank1_raw, device,
                  bank_maxcode: int = BANK_MAXCODE_INT16) -> torch.Tensor:
    """Exact float64 init scores ``[Ka1, npos1]`` of level 1 from the
    level-0 events: the raw rows are ``sum m_int * bank_q`` (exact
    integers) times ``f32(scale0 * step)``, the singleton rows the map
    cells times ``scale0`` (the spec's `int8_init_scores`, without its
    float32 roundings).  `bank_maxcode` below the spec's int16 codes gives
    the control's coarser bank."""
    n_raw, w1, c = bank1_raw.shape
    npos1 = cfg.num_positions(1)
    bank_q, step = _quantize(bank1_raw, bank_maxcode)
    # the level-0 map's cells: exact code sums per (position, atom)
    key = np.asarray(positions, np.int64) * c + np.asarray(atoms, np.int64)
    cells, inv = np.unique(key, return_inverse=True)
    vals = np.zeros(cells.shape[0], np.int64)
    np.add.at(vals, inv, np.asarray(codes, np.int64))
    p, a = cells // c, cells % c
    g = float(np.float32(np.float32(scale0) * np.float32(step)))
    # each cell (p, a, v) adds v * bank_q[:, u, a] at t = p - u
    uu = np.tile(np.arange(w1), p.shape[0])
    pp, aa, vv = np.repeat(p, w1), np.repeat(a, w1), np.repeat(vals, w1)
    tt = pp - uu
    ok = (tt >= 0) & (tt < npos1)
    bq = torch.as_tensor(bank_q, dtype=torch.float64, device=device)
    contrib = bq[:, torch.as_tensor(uu[ok], device=device), torch.as_tensor(aa[ok], device=device)]
    contrib = contrib * torch.as_tensor(vv[ok], dtype=torch.float64, device=device)
    raw = torch.zeros((n_raw, npos1), dtype=torch.float64, device=device)
    raw.index_add_(1, torch.as_tensor(tt[ok], device=device), contrib)  # exact: integer sums below 2^53
    sing = torch.zeros((c, npos1), dtype=torch.float64, device=device)
    inside = p < npos1
    sing[torch.as_tensor(a[inside], device=device), torch.as_tensor(p[inside], device=device)] = torch.as_tensor(
        vals[inside].astype(np.float64) * float(np.float32(scale0)), dtype=torch.float64, device=device
    )
    return torch.cat([raw * g, sing], 0)


def replay(scores: torch.Tensor, gram_: torch.Tensor, weights: torch.Tensor, stream, cfg: CodecConfig,
           level: int) -> dict:
    """Replay the port's events of one block and level on the reference's
    float64 init `scores` ``[K, npos]`` (updated in place) and read the
    gaps of the module docstring.  Returns the largest ``sel``, ``code``
    and ``skip`` gaps in quantizer steps of the port's scale, the
    reference's scale, and how many of the port's events the replay could
    not place (more than the budget, or never a valid choice)."""
    k, npos = scores.shape
    w = cfg.window_sizes[level]
    lag = 2 * w - 1
    num_coefs = cfg.num_coefs[level]
    n_sel = max(int(cfg.num_select), 1)
    maxcode = cfg.amp_maxcode
    seg_len = 128 * (-(-npos // (128 * n_sel)))
    pos = np.asarray(stream.positions, np.int64)
    atm = np.asarray(stream.atoms, np.int64)
    cod = np.asarray(stream.codes, np.int64)
    n = pos.shape[0]
    peak = float(scores.abs().max()) if scores.numel() else 0.0
    ref_scale = peak / maxcode
    scale = float(stream.scale)
    out = {"sel": 0.0, "code": 0.0, "skip": 0.0, "scale": float(np.float32(scale)), "ref_scale": ref_scale,
           "unplaced": 0}
    if not scale > 0:
        out["unplaced"] = n
        return out
    if n > num_coefs:
        out["unplaced"] = n - num_coefs
        n = num_coefs
    wcol = weights.to(scores.dtype)[:, None]
    padded_len = n_sel * seg_len
    i = 0
    while i < num_coefs:
        weighted = scores.abs() * wcol
        colmax = weighted.max(0).values
        cm = F.pad(colmax, (0, padded_len - npos), value=-1.0).view(n_sel, seg_len)
        seg_best, seg_arg = cm.max(1)
        best_t = seg_arg + torch.arange(n_sel, device=scores.device) * seg_len
        best_t = best_t.clamp(max=npos - 1)
        best_f = weighted[:, best_t].argmax(0)
        best_s = scores[best_f, best_t]
        # the port's events of this sweep, by the spec's segment walk
        accepted, skipped = [], []
        last = None
        for j in range(n_sel):
            if i + len(accepted) >= num_coefs:
                break
            lo, hi = j * seg_len, min((j + 1) * seg_len, npos)
            if lo >= hi:
                continue
            e = i + len(accepted)
            if e < n and lo <= pos[e] < hi and (last is None or pos[e] - last >= lag):
                accepted.append((j, e))
                last = int(pos[e])
            else:
                skipped.append((j, last))
        # gather what the decisions need, in one transfer
        ev = np.array([e for _, e in accepted], np.int64)
        chosen_w = weighted[torch.as_tensor(atm[ev], device=scores.device),
                            torch.as_tensor(pos[ev], device=scores.device)] if len(ev) else None
        chosen_s = scores[torch.as_tensor(atm[ev], device=scores.device),
                          torch.as_tensor(pos[ev], device=scores.device)] if len(ev) else None
        guard_best = []
        for j, last_j in skipped:
            lo = j * seg_len
            hi = min((j + 1) * seg_len, npos)
            if last_j is not None and last_j + lag > lo:
                guard_best.append(colmax[lo:min(hi, last_j + lag)].max())
            else:
                guard_best.append(torch.tensor(-np.inf, dtype=scores.dtype, device=scores.device))
        host = torch.cat([
            seg_best, best_s,
            chosen_w if chosen_w is not None else seg_best[:0],
            chosen_s if chosen_s is not None else seg_best[:0],
            torch.stack(guard_best) if guard_best else seg_best[:0],
        ]).cpu().numpy()
        sb, bs = host[:n_sel], host[n_sel:2 * n_sel]
        na = len(ev)
        cw, cs = host[2 * n_sel:2 * n_sel + na], host[2 * n_sel + na:2 * n_sel + 2 * na]
        gb = host[2 * n_sel + 2 * na:]
        for (j, e), vw, vs in zip(accepted, cw, cs):
            out["sel"] = max(out["sel"], (sb[j] - vw) / scale)
            out["code"] = max(out["code"], abs(cod[e] - vs / scale) - 0.5)
        for (j, _), g in zip(skipped, gb):
            zero = max(0.0, abs(bs[j]) / scale - 0.5)
            guard = (sb[j] - g) / scale if np.isfinite(g) else np.inf
            out["skip"] = max(out["skip"], min(zero, guard))
        # the port's state: subtract its own quantized amplitudes
        for _, e in accepted:
            t, f = int(pos[e]), int(atm[e])
            lo_u, hi_u = max(0, t - w + 1), min(npos, t + w)
            dlo = lo_u - (t - w + 1)
            c_hat = float(np.float32(np.float32(cod[e]) * np.float32(scale)))
            scores[:, lo_u:hi_u] -= c_hat * gram_[:, f, dlo:dlo + (hi_u - lo_u)]
        i += len(accepted)
        if not accepted:
            break
    out["unplaced"] += n - i
    return out


# ---- the control: the reference at the next precision below float32 -------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits, to nearest, ties away
    from zero), as a tensor core rounds its inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def spec_loop_f32(scores0: np.ndarray, gram_f32: np.ndarray, weights: np.ndarray, cfg: CodecConfig,
                  level: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.float32]:
    """The spec's float32 greedy loop (the port's `oracle.mp.mp_encode`,
    multi-select, no SNR stop) given init scores: (positions, atoms, codes,
    scale)."""
    scores = np.array(scores0, dtype=np.float32, copy=True)
    k, npos = scores.shape
    w = cfg.window_sizes[level]
    num_coefs = cfg.num_coefs[level]
    s_count = max(int(cfg.num_select), 1)
    maxcode = cfg.amp_maxcode
    peak = np.float32(np.max(np.abs(scores)))
    scale = np.float32(peak / np.float32(maxcode)) if peak > 0 else np.float32(0)
    inv = np.float32(np.float32(maxcode) / peak) if peak > 0 else np.float32(0)
    wts = np.asarray(weights, np.float32)
    positions, atoms, codes = [], [], []
    seg_len = 128 * (-(-npos // (128 * s_count)))
    done = not scale > 0
    while not done and len(positions) < num_coefs:
        weighted = np.abs(scores) * wts[:, None]
        colmax = weighted.max(axis=0)
        last = None
        any_ = False
        for j in range(s_count):
            if len(positions) >= num_coefs:
                break
            lo, hi = j * seg_len, min((j + 1) * seg_len, npos)
            if lo >= hi:
                continue
            t = lo + int(np.argmax(colmax[lo:hi]))
            f = int(np.argmax(weighted[:, t]))
            s = np.float32(scores[f, t])
            y = np.float32(s * inv)
            r = np.float32(np.floor(np.abs(y) + np.float32(0.5))) * np.sign(y)
            code = int(np.clip(r, -maxcode, maxcode))
            if code == 0:
                continue
            if last is not None and t - last < 2 * w - 1:
                continue
            c_hat = np.float32(np.float32(code) * scale)
            positions.append(t)
            atoms.append(f)
            codes.append(code)
            last = t
            any_ = True
            lo_u, hi_u = max(0, t - w + 1), min(npos, t + w)
            dlo = lo_u - (t - w + 1)
            scores[:, lo_u:hi_u] -= c_hat * gram_f32[:, f, dlo:dlo + (hi_u - lo_u)]
        if not any_:
            done = True
    return (np.asarray(positions, np.int64), np.asarray(atoms, np.int64), np.asarray(codes, np.int64), scale)
