"""Greedy convolutional matching pursuit — the plain PyTorch path.

Counterpart of `hsc_tpu.ops.encode`: the init (correlation, energy, peak),
the host quantizer steps, and the greedy loop given its init.  The loop here
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


def encode_init_batched(xs: torch.Tensor, bank: torch.Tensor):
    """``xs [B, N, C]`` -> (scores0 [B, K, npos], e0 [B], peak [B]) — the
    counterpart of `hsc_tpu.ops.encode.encode_init_batched`."""
    scores0 = correlate_bank_torch(xs, bank)
    e0 = xs.square().sum(dim=(1, 2))
    return scores0, e0, scores0.abs().amax(dim=(1, 2))


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
            # quantizer spec: round half away from zero, sign*floor(|y|+0.5)
            y = s * inv_scale
            r = torch.floor(y.abs() + 0.5) * torch.sign(y)
            code = r.clamp(-maxcode, maxcode).to(i32)
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

            # e - (2 c_hat) s + c_hat^2, each op rounded (oracle op order)
            e_res = torch.where(emit, (e_res - (2.0 * c_hat) * s) + c_hat * c_hat, e_res)
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
