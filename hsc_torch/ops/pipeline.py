"""Batch pipelining for the three-stage encode (init -> host steps -> loop).

Counterparts of `hsc_tpu.ops.pipeline.encode_batches_pipelined` (one level)
and `encode_hierarchical_batches_pipelined` (every level).  The host
quantizer steps (`ops.encode.quantizer_steps`) need each batch's peak vector
on the host.  As in the JAX package, every transfer is asynchronous: a
batch is uploaded through pinned memory without a host wait
(`device.to_device`), the copy of its ``[B]`` peak is started right after
its init is dispatched (`device.copy_to_host_async`), and the host waits on
that copy's event alone when the batch's loop is due, so the inits
dispatched up to `window` batches ahead and the loops queue on the card
while the host works.  Per-batch arithmetic and the order of launches are
unchanged, so streams are bitwise the unpipelined ones.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..device import copy_to_host_async, to_device
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
        xb = to_device(np.ascontiguousarray(batches[bi], dtype=np.float32), device)
        s0, e0, peak = encode_init_batched(xb, params.bank)
        inits.append((s0, e0, copy_to_host_async(peak)))
        bi += 1

    while bi < n and len(inits) < step:
        _dispatch_init()
    while inits:
        s0, e0, peak = inits.popleft()
        scale, inv = quantizer_steps(peak.numpy(), amp_bits)
        outs.append(
            loop(s0, e0, to_device(scale, device), to_device(inv, device), params, **settings)
        )
        if bi < n:
            _dispatch_init()
    return outs


def encode_hierarchical_batches_pipelined(batches: list, coder, window: int = 4):
    """Level-pipelined hierarchical encode: every level runs as its own batch
    pipeline, and each batch's hand-off map to the next level is dispatched
    as soon as its loop is.  `coder` is a
    `models.coder.HierarchicalConvolutionalSparseCoder`; `batches` are
    ``[B, N, C]`` host arrays.  Returns ``outs[level][batch]`` (device)
    `EncodedBlock`s, per block bitwise the serial `coder.encode_batch`
    (same stages, same order within each level).  A level's init is its
    coder's `init_stage`: of the uploaded batch at level 0, and at level
    k >= 1 of level k-1's hand-off (`coder.handoff`: the events under the
    int8 init, the f32 map otherwise).

    The dataflow and drain policy are the JAX package's: each level keeps a
    FIFO of pending inits (at most `window`); level 0 is fed while it has
    room; a level's oldest peak (its copy started when its init was
    dispatched) is waited for only once that level holds a full window —
    deepest such level first — and otherwise the shallowest non-empty level
    drains."""
    n_levels = coder.cfg.num_levels
    outs = [[] for _ in range(n_levels)]
    pend = [deque() for _ in range(n_levels)]
    device = coder.device

    def _push(level, xb):
        s0, e0, peak = coder.coders[level].mp.init_stage(xb)
        pend[level].append((s0, e0, copy_to_host_async(peak)))

    def _pop(level):
        mp = coder.coders[level].mp
        s0, e0, peak = pend[level].popleft()
        scale, inv = quantizer_steps(peak.numpy(), mp.settings["amp_bits"])
        enc = mp.loop_stage(s0, e0, scale, inv)
        outs[level].append(enc)
        if level + 1 < n_levels:
            _push(level + 1, coder.handoff(level, enc))

    w = max(window, 1)
    bi = 0
    while bi < len(batches) or any(pend):
        if bi < len(batches) and len(pend[0]) < w:
            _push(0, to_device(np.ascontiguousarray(batches[bi], dtype=np.float32), device))
            bi += 1
            continue
        lvl = next((k for k in reversed(range(n_levels)) if len(pend[k]) >= w), None)
        if lvl is None:
            lvl = next(k for k in range(n_levels) if pend[k])
        _pop(lvl)
    return outs
