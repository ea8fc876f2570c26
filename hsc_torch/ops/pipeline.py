"""Batch pipelining for the three-stage encode (init -> host steps -> loop).

Counterpart of `hsc_tpu.ops.pipeline.encode_batches_pipelined`.  The host
quantizer steps (`ops.encode.quantizer_steps`) need each batch's peak vector
on the host: one ``.cpu()`` of a ``[B]`` vector per batch.  Inits are
dispatched up to `window` batches ahead, so a batch's peak is usually ready
when its loop is due; per-batch arithmetic is unchanged, so streams are
bitwise the unpipelined ones.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .encode import encode_init_batched, mp_encode_from_init_torch, quantizer_steps
from .mp_kernels import mp_loop


def encode_batches_pipelined(
    batches: list,
    params,
    *,
    device,
    backend: str = "cuda",
    window: int | None = 8,
    **settings,
):
    """Encode a list of ``[B, N, C]`` host batches against a
    `params.LevelParams`; returns a list of (device) `EncodedBlock`.

    `backend`: 'cuda' runs the loop through `ops.mp_kernels.mp_loop` (the
    CUDA kernel for CUDA tensors), 'torch' the plain loop.  `settings` are
    the loop settings (num_coefs, amp_bits, tolerance_snr, num_select).
    `window` bounds how many batches' init scores are live at once (None =
    all)."""
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}")
    loop = mp_loop if backend == "cuda" else mp_encode_from_init_torch
    amp_bits = settings.get("amp_bits", 16)
    n = len(batches)
    step = n if window is None else max(window, 1)
    outs = []
    inits: deque = deque()
    bi = 0

    def _dispatch_init():
        nonlocal bi
        xb = torch.from_numpy(np.ascontiguousarray(batches[bi], dtype=np.float32))
        inits.append(encode_init_batched(xb.to(device), params.bank))
        bi += 1

    while bi < n and len(inits) < step:
        _dispatch_init()
    while inits:
        s0, e0, peak = inits.popleft()
        scale, inv = quantizer_steps(peak.cpu().numpy(), amp_bits)
        outs.append(
            loop(
                s0, e0, torch.from_numpy(scale).to(device),
                torch.from_numpy(inv).to(device), params, **settings,
            )
        )
        if bi < n:
            _dispatch_init()
    return outs
