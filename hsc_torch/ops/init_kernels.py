"""The int8 level >= 1 init on the card: wrapper of the hand-written CUDA
kernel `hsc_torch/csrc/sparse_init.cu` (the port of the Pallas kernel
`hsc_tpu/ops/init_kernels.py :: _sparse_init_kernel`).

`sparse_init_raw` takes the same inputs as the plain version
(`ops.encode.encode_init_int_raw_torch`) and returns the same raw score rows
and peak, bitwise.  A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises — there is no fallback.  The kernel reads the
exact int32 feature map (`ops.encode.feature_map_int`), whose cells are
already the spec's cell sums, so the Pallas path's event aggregation
(`aggregate_codes`, an O(M^2) equality matrix per block) has no counterpart.
It takes every geometry `CodecConfig` admits for hier_init='int8'
(``W * C <= 65535``); the TPU gate `sparse_init_supported` has none either.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .encode import encode_init_int_raw_torch
from .mp_kernels import check_tensor

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def sparse_init_raw(
    m_int: torch.Tensor,
    prev_scale: torch.Tensor,
    bank_planes: torch.Tensor,
    step,
    *,
    out: torch.Tensor | None = None,
):
    """Raw rows of the int8 init: ``m_int [B, N, C]`` int32, ``prev_scale
    [B]`` f32, ``bank_planes [n_raw, W, C, 2]`` int8, ``step`` the f32 bank
    step -> ``(raw [B, n_raw, npos] f32, peak_raw [B] f32)``.  `raw` is
    written into `out` when given (a ``[B, n_raw, npos]`` view whose rows are
    contiguous, such as the raw rows of a preallocated score buffer)."""
    if m_int.device.type == "cpu":
        return encode_init_int_raw_torch(m_int, prev_scale, bank_planes, step, out=out)
    if m_int.device.type != "cuda":
        raise ValueError(f"sparse_init_raw: unsupported device {m_int.device}")
    global LAUNCHES
    dev = m_int.device
    if m_int.dim() != 3 or bank_planes.dim() != 4:
        raise ValueError("m_int must be [B, N, C] and bank_planes [n_raw, W, C, 2]")
    b, n, c = m_int.shape
    n_raw, w = int(bank_planes.shape[0]), int(bank_planes.shape[1])
    npos = n - w + 1
    if npos < 1:
        raise ValueError(f"atom width {w} does not fit a map of {n} positions")
    check_tensor(m_int, "m_int", torch.int32, (b, n, c), dev)
    check_tensor(prev_scale, "prev_scale", torch.float32, (b,), dev)
    check_tensor(bank_planes, "bank_planes", torch.int8, (n_raw, w, c, 2), dev, contiguous=False)
    if out is None:
        out = torch.empty((b, n_raw, npos), dtype=torch.float32, device=dev)
    check_tensor(out, "out", torch.float32, (b, n_raw, npos), dev, contiguous=False)
    if out.stride(2) != 1 or out.stride(1) != npos:
        raise ValueError("out must have contiguous [n_raw, npos] rows")
    # the kernel reads the planes as [C, n_raw, W] (b0, b1) pairs, so that
    # neighbouring positions read neighbouring offsets
    planes = bank_planes.permute(2, 0, 1, 3).contiguous()
    g = prev_scale * torch.tensor(np.float32(step), device=dev)  # f32(prev_scale * step)
    peak_bits = torch.zeros((b,), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hsc_sparse_init(
            m_int.data_ptr(), g.data_ptr(), planes.data_ptr(), out.data_ptr(),
            peak_bits.data_ptr(), b, n, c, n_raw, w, out.stride(0), stream,
        )
    _build.check(lib, err, "hsc_sparse_init launch")
    LAUNCHES += 1
    # non-negative floats order like their bits: the kernel's integer max of
    # the bits of |raw| is the float max
    return out, peak_bits.view(torch.float32)
