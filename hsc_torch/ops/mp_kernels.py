"""The greedy loop on the card: wrapper of the hand-written CUDA kernel
`hsc_torch/csrc/mp_encode.cu` (the port of the Pallas kernel
`hsc_tpu/ops/mp_kernels.py :: _mp_kernel`).

`mp_loop` takes the same inputs as the plain loop
(`ops.encode.mp_encode_from_init_torch`).  A CPU tensor runs the plain loop;
a CUDA tensor launches the kernel or raises — there is no fallback.  Unlike
the Pallas kernel (`pallas_num_select_options`), the kernel takes every
``num_select >= 1`` the spec allows.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .encode import EncodedBlock, mp_encode_from_init_torch

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device, contiguous=True) -> None:
    """Raise unless `t` has the device, dtype and shape a kernel takes (and
    is contiguous, where the kernel reads it in place)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mp_loop(
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
    """Greedy loop of a batch -> `EncodedBlock`, bitwise the plain loop.
    The caller's `scores0` is not modified (the kernel works on a copy)."""
    if scores0.device.type == "cpu":
        return mp_encode_from_init_torch(
            scores0, e0, scale, inv_scale, params, num_coefs=num_coefs,
            amp_bits=amp_bits, tolerance_snr=tolerance_snr, num_select=num_select,
        )
    if scores0.device.type != "cuda":
        raise ValueError(f"mp_loop: unsupported device {scores0.device}")
    global LAUNCHES
    dev = scores0.device
    if scores0.dim() != 3:
        raise ValueError(f"scores0 must be [B, K, npos], got {tuple(scores0.shape)}")
    b, k, npos = scores0.shape
    lag = int(params.gram_t.shape[2])
    if lag % 2 != 1:
        raise ValueError(f"gram_t lag axis must be 2W-1, got {lag}")
    w = (lag + 1) // 2
    if int(num_select) < 1 or int(num_coefs) < 0:
        raise ValueError("num_select must be >= 1 and num_coefs >= 0")
    # any layout: the kernel works on a contiguous copy (cuDNN may hand the
    # init back in another memory format)
    check_tensor(scores0, "scores0", torch.float32, (b, k, npos), dev, contiguous=False)
    for name, t in (("e0", e0), ("scale", scale), ("inv_scale", inv_scale)):
        check_tensor(t, name, torch.float32, (b,), dev)
    check_tensor(params.gram_t, "gram_t", torch.float32, (k, k, lag), dev)
    check_tensor(params.weights, "weights", torch.float32, (k,), dev)

    scores = torch.empty((b, k, npos), dtype=torch.float32, device=dev)
    scores.copy_(scores0)  # loop state, updated in place by the kernel
    positions = torch.empty((b, num_coefs), dtype=torch.int32, device=dev)
    atoms = torch.empty_like(positions)
    codes = torch.empty_like(positions)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    e_res = torch.empty((b,), dtype=torch.float32, device=dev)
    snr_factor = (
        np.float32(10.0 ** (-tolerance_snr / 10.0))
        if tolerance_snr is not None
        else np.float32(0)
    )
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hsc_mp_encode(
            scores.data_ptr(), e0.data_ptr(), scale.data_ptr(),
            inv_scale.data_ptr(), params.gram_t.data_ptr(),
            params.weights.data_ptr(), positions.data_ptr(), atoms.data_ptr(),
            codes.data_ptr(), count.data_ptr(), e_res.data_ptr(),
            b, k, w, npos, int(num_coefs), int(num_select),
            float((1 << (amp_bits - 1)) - 1),
            int(tolerance_snr is not None), float(snr_factor), stream,
        )
    _build.check(lib, err, "hsc_mp_encode launch")
    LAUNCHES += 1
    return EncodedBlock(
        positions=positions,
        atoms=atoms,
        codes=codes,
        count=count,
        scale=scale,
        energy0=e0,
        energy_res=e_res,
    )
