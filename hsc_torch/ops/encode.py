"""Greedy convolutional matching pursuit — the plain PyTorch path.

Counterpart of `hsc_tpu.ops.encode`: the init (correlation, energy, peak),
the level hand-off maps, the int8 level >= 1 init (from a dense map, and
from events: the plain version of the int8-init kernels,
`ops.init_kernels`), the host quantizer steps, and the greedy loop given
its init.  The loop here
is the PLAIN version of the hand-written CUDA kernel
(`ops.mp_kernels.mp_loop`): CPU tensors run it, the CUDA kernel is held
bitwise to it on the card, and ``backend='torch'`` selects it explicitly.

The loop is the spec of `hsc_tpu.oracle.mp.mp_encode` batched over blocks,
in the same float32 op order as the JAX path (`mp_encode_from_init`): every
product and sum is its own eager op, so nothing contracts into an FMA, and
the loop never divides (the steps come from `quantizer_steps` on the host).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .correlate import correlate_bank_torch


class EncodedBlock(NamedTuple):
    """Fixed-shape batched encode result (valid prefix = first `count`
    events; event slots past `count` hold 0)."""

    positions: torch.Tensor  # int32 [B, num_coefs]
    atoms: torch.Tensor  # int32 [B, num_coefs]
    codes: torch.Tensor  # int32 [B, num_coefs]
    count: torch.Tensor  # int32 [B]
    scale: torch.Tensor  # float32 [B]
    energy0: torch.Tensor  # float32 [B]
    energy_res: torch.Tensor  # float32 [B]


def block_energy(xs: torch.Tensor) -> torch.Tensor:
    """float32 energy ``[B]`` of blocks ``xs [B, N, C]``: the squares summed
    in a fixed pairwise tree (halves added elementwise; at an odd width the
    last column is added onto column 0 after the halving), so a block's e0
    is the same bits at every batch size and on every device, with no
    padded copy.  A reduction kernel's order is not: on the card it depends
    on the batch (a block's e0 at batch 17 differed from batch 64 in the
    last bits), and e0 decides the SNR stop."""
    sq = xs.reshape(xs.shape[0], -1).square()
    while sq.shape[1] > 1:
        m = sq.shape[1]
        h = m // 2
        half = sq[:, :h] + sq[:, h : 2 * h]
        if m % 2:
            half[:, 0] += sq[:, m - 1]
        sq = half
    return sq[:, 0]


def quantize(s: torch.Tensor, inv_scale: torch.Tensor, maxcode: float) -> torch.Tensor:
    """The spec's quantizer: round half away from zero,
    ``clip(sign(y) * floor(|y| + 0.5))`` of ``y = s * inv_scale``, as int32."""
    y = s * inv_scale
    r = torch.floor(y.abs() + 0.5) * torch.sign(y)
    return r.clamp(-maxcode, maxcode).to(torch.int32)


def energy_step(e_res: torch.Tensor, c_hat: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The residual energy after emitting ``c_hat`` at score `s`:
    ``e - (2 c_hat) s + c_hat^2``, each op rounded (oracle op order), so
    nothing contracts into a fused multiply-add."""
    return (e_res - (2.0 * c_hat) * s) + c_hat * c_hat


def encode_init_batched(xs: torch.Tensor, bank: torch.Tensor):
    """``xs [B, N, C]`` -> (scores0 [B, K, npos], e0 [B], peak [B]) — the
    counterpart of `hsc_tpu.ops.encode.encode_init_batched` (e0 through
    `block_energy`)."""
    scores0 = correlate_bank_torch(xs, bank)
    return scores0, block_energy(xs), scores0.abs().amax(dim=(1, 2))


def _wrap_int32(acc: torch.Tensor) -> torch.Tensor:
    """Exact int64 sums -> int32 mod 2^32 (`oracle.mp._wrap_int32`)."""
    return ((acc + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def feature_map_int(
    positions: torch.Tensor,  # [B, M] i32
    atoms: torch.Tensor,  # [B, M] i32
    codes: torch.Tensor,  # [B, M] i32
    count: torch.Tensor,  # [B] i32
    *,
    npos: int,
    k: int,
) -> torch.Tensor:
    """The level -> level+1 hand-off: int32 ``[B, npos, k]`` code sums per
    (position, atom) cell, mod 2^32 — the counterpart of
    `hsc_tpu.ops.encode.feature_map_int_jax` (batched) and bitwise
    `oracle.mp.feature_map_int_from_events`.  A scatter-add in int64 (exact
    in any order), wrapped to int32 at the touched cells only; the JAX form's
    one-hot matmuls existed because XLA's scatter is slow on a TPU.  Events
    past `count` or off the map contribute nothing."""
    b, m = positions.shape
    dev = positions.device
    pos, atm = positions.long(), atoms.long()
    live = (
        (torch.arange(m, device=dev)[None, :] < count[:, None].long())
        & (pos >= 0) & (pos < npos) & (atm >= 0) & (atm < k)
    )
    size = b * npos * k
    cell = torch.where(
        live, (torch.arange(b, device=dev)[:, None] * npos + pos) * k + atm, size
    ).reshape(-1)  # dead events go to one spare cell past the map
    acc = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    acc.index_add_(0, cell, codes.long().reshape(-1))
    out = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    # duplicate cells write the same wrapped sum, so the result is defined
    out[cell] = _wrap_int32(acc[cell])
    return out[:size].reshape(b, npos, k)


def feature_map(enc: EncodedBlock, *, npos: int, k: int) -> torch.Tensor:
    """The f32 hand-off (hier_init='f32'): ``f32(cell sum) * scale`` per
    block, bitwise `hsc_tpu.ops.encode.feature_map_jax` /
    `oracle.mp.feature_map_from_events`."""
    m_int = feature_map_int(enc.positions, enc.atoms, enc.codes, enc.count, npos=npos, k=k)
    return m_int.to(torch.float32) * enc.scale[:, None, None]


def _map_digits(m_int: torch.Tensor) -> list[torch.Tensor]:
    """Four balanced base-256 digits of an int32 map, held in int64: the
    integer formula of `hsc_tpu.ops.encode.encode_init_int_raw`, with its
    int32 wraparound and the int8 cast of the last digit spelled out, so any
    int32 cell digitizes as the JAX package and the kernel digitize it (the
    config bounds cells to `oracle.mp.FMAP4_DIGIT_BOUND`, where nothing
    wraps)."""
    r = m_int.long()
    digs = []
    for _ in range(4):
        d = ((r + 128) & 255) - 128
        digs.append(d)
        r = _wrap_int32(r - d).long() >> 8
    return digs


def encode_init_int_raw_torch(
    m_int: torch.Tensor,
    prev_scale: torch.Tensor,
    bank_planes: torch.Tensor,
    step,
    *,
    out: torch.Tensor | None = None,
):
    """Raw (learned-atom) rows of the int8 init, bitwise
    `hsc_tpu.ops.encode.encode_init_int_raw` and the raw rows of
    `oracle.mp.int8_init_scores`.

    ``m_int [B, N, C]`` int32 maps, ``prev_scale [B]`` f32, ``bank_planes
    [n_raw, W, C, 2]`` int8, ``step`` the f32 bank step.  The four map digits
    d_j against the two bank planes b_p give five anti-diagonal taps
    ``T_s = sum_{j+p=s} d_j (*) b_p`` as ONE float64 conv over the digit
    planes with a zero-stuffed ``[(s, k), (c, j), W]`` weight table.  It is
    exact: each T_s is a sum of at most 2*W*C <= 131070 integer products of
    size <= 2^14, below 2^53 in any order (the round only guards a backend
    that would use an inexact algorithm).  The taps recombine in the spec's
    fixed f32 grouping ``((T0 + 256 T1) + (65536 T2 + 2^24 T3)) + 2^32 T4``
    times ``g = f32(prev_scale * step)``.  Blocks run in chunks so the
    float64 buffers stay near 1 GB.  Returns ``(raw [B, n_raw, npos] f32,
    peak_raw [B])``; `raw` is written into `out` when given."""
    b, n, c = m_int.shape
    n_raw, w = int(bank_planes.shape[0]), int(bank_planes.shape[1])
    npos = n - w + 1
    dev = m_int.device
    f64 = torch.float64
    planes = bank_planes.to(f64).permute(0, 2, 1, 3)  # [n_raw, C, W, 2]
    weight = torch.zeros((5, n_raw, c, 4, w), dtype=f64, device=dev)
    for s in range(5):
        for j in range(4):
            if 0 <= s - j <= 1:
                weight[s, :, :, j, :] = planes[..., s - j]
    weight = weight.reshape(5 * n_raw, c * 4, w)
    if out is None:
        out = torch.empty((b, n_raw, npos), dtype=torch.float32, device=dev)
    g = prev_scale * torch.tensor(np.float32(step), device=dev)  # f32(prev_scale*step)
    chunk = max(1, (1 << 27) // (4 * c * n + 5 * n_raw * npos))
    for lo in range(0, b, chunk):
        digs = torch.stack(_map_digits(m_int[lo : lo + chunk]), dim=-1)  # [b', N, C, 4]
        lhs = digs.to(f64).reshape(-1, n, c * 4).transpose(1, 2)
        taps = torch.round(F.conv1d(lhs, weight)).reshape(-1, 5, n_raw, npos)
        t = [taps[:, s].to(torch.float32) for s in range(5)]  # RN, like int32 -> f32
        lo_ = t[0] + 256.0 * t[1]
        hi_ = 65536.0 * t[2] + 16777216.0 * t[3]
        rr = (lo_ + hi_) + 4294967296.0 * t[4]
        out[lo : lo + chunk] = rr * g[lo : lo + chunk, None, None]
    return out, out.abs().amax(dim=(1, 2))


def int8_assemble_batched(scores0, peak_raw, m_int, prev_scale):
    """Epilogue of the int8 init (`hsc_tpu.ops.encode.int8_assemble_batched`),
    in place: fills the singleton rows ``scores0[:, n_raw:]`` with the exact
    scaled-map passthrough (the raw rows are already there) and returns
    ``(e0 [B], peak [B])``.  Max is exact, so the combined peak equals one
    max over all rows; e0 is an f32 reduction in the backend's order."""
    x = m_int.to(torch.float32) * prev_scale[:, None, None]
    e0 = x.square().sum(dim=(1, 2))
    c = m_int.shape[2]
    sing = scores0[:, scores0.shape[1] - c :]
    sing.copy_(x[:, : scores0.shape[2], :].transpose(1, 2))
    return e0, torch.maximum(peak_raw, sing.abs().amax(dim=(1, 2)))


def encode_init_int_batched(
    m_int: torch.Tensor,
    prev_scale: torch.Tensor,
    bank_planes: torch.Tensor,
    step,
):
    """The int8 init for levels >= 1 (hier_init='int8') of a dense map:
    ``m_int [B, N, C]`` int32, ``prev_scale [B]`` f32 -> ``(scores0 [B,
    n_raw + C, npos], e0, peak)``, bitwise `oracle.mp.int8_init_scores` per
    block (e0 aside).  The raw rows go straight into ``scores0[:, :n_raw]``,
    so no concat copy of the score buffer is made."""
    b, n, c = m_int.shape
    n_raw, w = int(bank_planes.shape[0]), int(bank_planes.shape[1])
    scores0 = torch.empty((b, n_raw + c, n - w + 1), dtype=torch.float32, device=m_int.device)
    _, peak_raw = encode_init_int_raw_torch(
        m_int, prev_scale, bank_planes, step, out=scores0[:, :n_raw]
    )
    e0, peak = int8_assemble_batched(scores0, peak_raw, m_int, prev_scale)
    return scores0, e0, peak


def int8_init_from_events_torch(
    positions: torch.Tensor,
    atoms: torch.Tensor,
    codes: torch.Tensor,
    count: torch.Tensor,
    prev_scale: torch.Tensor,
    bank_planes: torch.Tensor,
    step,
    *,
    n_map: int,
):
    """The int8 init of a level >= 1 from the emitting level's events — the
    PLAIN version of the int8-init kernels (`ops.init_kernels.int8_init`)
    and what the CPU runs: the hand-off map `feature_map_int` (``[B, n_map,
    C]``, C from `bank_planes`), then `encode_init_int_batched`.  Events are
    ``[B, M]`` int32 padded buffers with ``count [B]``; returns ``(scores0
    [B, n_raw + C, npos], e0, peak)``."""
    m_int = feature_map_int(
        positions, atoms, codes, count, npos=n_map, k=int(bank_planes.shape[2])
    )
    return encode_init_int_batched(m_int, prev_scale, bank_planes, step)


def quantizer_steps(peak, amp_bits: int):
    """Spec quantizer steps from the init peak, computed on the HOST — a
    verbatim copy of `hsc_tpu.ops.encode.quantizer_steps` (which lives in a
    JAX-importing module).  The two divisions are spec-visible and defined as
    IEEE float32 divisions in NumPy.  Returns float32 arrays shaped like
    `peak`."""
    peak = np.asarray(peak, dtype=np.float32)
    maxcode = np.float32((1 << (amp_bits - 1)) - 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(peak > 0, (peak / maxcode).astype(np.float32), np.float32(0))
        inv = np.where(peak > 0, (maxcode / peak).astype(np.float32), np.float32(0))
    return scale.astype(np.float32), inv.astype(np.float32)


def mp_encode_from_init_torch(
    scores0: torch.Tensor,
    e0: torch.Tensor,
    scale: torch.Tensor,
    inv_scale: torch.Tensor,
    params,
    *,
    num_coefs: int,
    amp_bits: int = 16,
    tolerance_snr: float | None = None,
    num_select: int = 1,
) -> EncodedBlock:
    """The greedy loop for a batch: ``scores0 [B, K, npos]``, ``e0``,
    ``scale``, ``inv_scale`` ``[B]`` float32, and a `params.LevelParams`
    (its `gram_t` and selection `weights`).

    Every `num_select` runs as sweeps: one candidate per spec segment from
    the sweep-start selection cache, accepted left to right when its code is
    nonzero, the 2W-1 interference guard holds and the budget has room; a
    sweep that accepts nothing ends the block.  With ``num_select=1`` that is
    exactly the plain greedy loop (its one candidate is the global argmax,
    and a zero code ends the block), so one code path serves both, like the
    CUDA kernel.  The caller's `scores0` is not modified.
    """
    b, k, npos = scores0.shape
    lag = int(params.gram_t.shape[2])
    w = (lag + 1) // 2
    dev = scores0.device
    f32, i32 = torch.float32, torch.int32
    weights = params.weights
    gram_t = params.gram_t
    maxcode = float((1 << (amp_bits - 1)) - 1)
    s_count = int(num_select)
    seg_len = 128 * (-(-npos // (128 * s_count)))  # spec (oracle.mp.mp_encode)

    if tolerance_snr is not None:
        factor = torch.tensor(
            np.float32(10.0 ** (-tolerance_snr / 10.0)), dtype=f32, device=dev
        )
        snr_thr = e0 * factor
    else:
        snr_thr = torch.full((b,), -1.0, dtype=f32, device=dev)  # e_res >= 0

    # Lag-padded score buffer (real position p at column p + W-1), so every
    # update window is the fixed-width slice [t, t + 2W-1); pad columns
    # absorb out-of-range lags and are never selected.  The selection cache
    # gets an extra tail so the last segment's slice never runs short.
    scores = torch.zeros((b, k, npos + lag - 1), dtype=f32, device=dev)
    scores[:, :, w - 1 : w - 1 + npos] = scores0
    colmax = torch.zeros(
        (b, npos + lag - 1 + seg_len * s_count - npos), dtype=f32, device=dev
    )
    colmax[:, w - 1 : w - 1 + npos] = (scores0.abs() * weights[:, None]).amax(dim=1)

    positions = torch.zeros((b, num_coefs), dtype=i32, device=dev)
    atoms = torch.zeros_like(positions)
    codes = torch.zeros_like(positions)
    count = torch.zeros((b,), dtype=i32, device=dev)
    e_res = e0.clone()
    done = ~(scale > 0)
    zero = torch.zeros((), dtype=f32, device=dev)
    rows = torch.arange(b, device=dev)
    lags = torch.arange(lag, device=dev)
    seg_lo = torch.arange(s_count, device=dev)[:, None] * seg_len
    seg_valid = (seg_lo + torch.arange(seg_len, device=dev)) < npos  # [S, L]

    while bool((~done & (count < num_coefs)).any()):
        # candidates from the SWEEP-START cache: intra-sweep updates only
        # affect the next sweep (oracle semantics)
        snap = colmax[:, w - 1 : w - 1 + seg_len * s_count].reshape(b, s_count, seg_len)
        snap = torch.where(seg_valid, snap, torch.tensor(-1.0, dtype=f32, device=dev))
        seg_best = snap.amax(dim=2)  # [B, S]
        # argmax takes the first maximum: ties go to the lowest position
        cand = (seg_lo[:, 0] + snap.argmax(dim=2)).clamp(max=npos - 1)  # [B, S]
        last_t = torch.full((b,), -1, dtype=torch.int64, device=dev)
        any_acc = torch.zeros((b,), dtype=torch.bool, device=dev)
        for j in range(s_count):
            t = cand[:, j]
            col = scores[rows, :, t + (w - 1)]  # [B, K]
            f = (col.abs() * weights).argmax(dim=1)  # ties: lowest atom
            s = col[rows, f]
            code = quantize(s, inv_scale, maxcode)
            guard_ok = (last_t < 0) | (t - last_t >= lag)
            emit = (
                ~done
                & (seg_best[:, j] >= 0)
                & (code != 0)
                & guard_ok
                & (count < num_coefs)
            )
            c_hat = torch.where(emit, code.to(f32) * scale, zero)

            slot = count.clamp(max=max(num_coefs - 1, 0)).long()[:, None]
            for buf, val in ((positions, t.to(i32)), (atoms, f.to(i32)), (codes, code)):
                old = buf.gather(1, slot)[:, 0]
                buf.scatter_(1, slot, torch.where(emit, val, old)[:, None])
            count = count + emit.to(i32)

            e_res = torch.where(emit, energy_step(e_res, c_hat, s), e_res)
            idx = (t[:, None] + lags)[:, None, :].expand(b, k, lag)
            window = scores.gather(2, idx) - c_hat[:, None, None] * gram_t[f]
            scores.scatter_(2, idx, window)
            colmax.scatter_(
                1, idx[:, 0, :], (window.abs() * weights[None, :, None]).amax(dim=1)
            )
            last_t = torch.where(emit, t, last_t)
            any_acc = any_acc | emit
            done = done | (emit & (e_res <= snr_thr))
        done = done | ~any_acc

    return EncodedBlock(
        positions=positions,
        atoms=atoms,
        codes=codes,
        count=count,
        scale=scale,
        energy0=e0,
        energy_res=e_res.clamp_min(0.0),
    )
