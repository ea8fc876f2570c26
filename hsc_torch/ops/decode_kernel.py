"""Ordered decode on the card: wrapper of the hand-written CUDA kernel
`hsc_torch/csrc/ordered_decode.cu` (the port of the Pallas kernel
`hsc_tpu/ops/decode_kernel.py :: _decode_kernel`).

`mp_decode_batch` is the dispatcher: a CPU tensor runs the plain version
(`ops.decode.mp_decode_batch_torch`); a CUDA tensor launches the kernel or
raises — there is no fallback.  Like the Pallas wrapper, the kernel takes
single-channel banks only (C == 1, which is every signal-space
representation bank); it takes any atom width and any block length (a
CTA owns a tile of `TILE` samples, and no shared-memory size depends on
either).
"""

from __future__ import annotations

import torch

from .. import _build
from .decode import mp_decode_batch_torch
from .mp_kernels import check_tensor

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
# samples one CTA of either decode kernel owns (kTile in
# csrc/decode_tiles.cuh): a 64-block flagship batch is 1024 CTAs
TILE = 1024


def mp_decode_batch(
    positions: torch.Tensor,
    atoms: torch.Tensor,
    codes: torch.Tensor,
    count: torch.Tensor,
    scale: torch.Tensor,
    bank: torch.Tensor,
    *,
    n: int,
) -> torch.Tensor:
    """Batched ordered decode -> ``[B, n, 1]`` float32, bitwise the plain
    version and `oracle.mp.mp_decode`."""
    if positions.device.type == "cpu":
        return mp_decode_batch_torch(positions, atoms, codes, count, scale, bank, n=n)
    if positions.device.type != "cuda":
        raise ValueError(f"ordered decode: unsupported device {positions.device}")
    global LAUNCHES
    dev = positions.device
    if positions.dim() != 2 or bank.dim() != 3:
        raise ValueError("positions must be [B, M] and bank [K, W, C]")
    b, m = positions.shape
    k, w, c = bank.shape
    if c != 1:
        raise ValueError("the ordered-decode kernel supports single-channel banks")
    if not 0 < w <= n:
        raise ValueError(f"atom width {w} does not fit a block of {n}")
    for name, t in (("positions", positions), ("atoms", atoms), ("codes", codes)):
        check_tensor(t, name, torch.int32, (b, m), dev)
    check_tensor(count, "count", torch.int32, (b,), dev)
    check_tensor(scale, "scale", torch.float32, (b,), dev)
    check_tensor(bank, "bank", torch.float32, (k, w, 1), dev)

    out = torch.empty((b, n, 1), dtype=torch.float32, device=dev)
    _build.launch(
        "hsc_ordered_decode", dev, positions.data_ptr(), atoms.data_ptr(), codes.data_ptr(),
        count.data_ptr(), scale.data_ptr(), bank.data_ptr(), out.data_ptr(), b, m, k, w, int(n),
    )
    LAUNCHES += 1
    return out
