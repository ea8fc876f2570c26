"""Ordered decode on the card: wrapper of the hand-written CUDA kernel
`hsc_torch/csrc/ordered_decode.cu` (the port of the Pallas kernel
`hsc_tpu/ops/decode_kernel.py :: _decode_kernel`).

`mp_decode_batch` is the dispatcher: a CPU tensor runs the plain version
(`ops.decode.mp_decode_batch_torch`); a CUDA tensor launches the kernel or
raises — there is no fallback.  The kernel takes a bank of any number of
channels C: C == 1 for every signal-space representation bank, C > 1 for
the level-space decode of a level >= 1 against its augmented bank
(`models.coder.ConvolutionalSparseCoder.reconstruct`), where the Pallas
wrapper takes C == 1 only and the JAX package falls back to XLA.  It runs
on each block's row of ``n * C`` floats flattened, where an event adds its
atom's ``W * C`` taps at offset ``pos * C``, so it takes any atom width,
block length and channel count (a CTA owns a tile of `TILE` elements, and
no shared-memory size depends on them).
"""

from __future__ import annotations

import torch

from .. import _build
from .decode import mp_decode_batch_torch
from .mp_kernels import check_tensor

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0
# elements of a flattened row one CTA of either decode kernel owns (kTile
# in csrc/decode_tiles.cuh): a 64-block flagship batch is 1024 CTAs
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
    """Batched ordered decode against ``bank [K, W, C]`` -> ``[B, n, C]``
    float32, bitwise the plain version and `oracle.mp.mp_decode`."""
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
    if not 0 < w <= n:
        raise ValueError(f"atom width {w} does not fit a block of {n}")
    if c < 1 or n * c > 2**31 - 1 - TILE:
        raise ValueError(f"a block of {n} x {c} channels does not fit the kernel's int32 offsets")
    for name, t in (("positions", positions), ("atoms", atoms), ("codes", codes)):
        check_tensor(t, name, torch.int32, (b, m), dev)
    check_tensor(count, "count", torch.int32, (b,), dev)
    check_tensor(scale, "scale", torch.float32, (b,), dev)
    check_tensor(bank, "bank", torch.float32, (k, w, c), dev)

    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    _build.launch(
        "hsc_ordered_decode", dev, positions.data_ptr(), atoms.data_ptr(), codes.data_ptr(),
        count.data_ptr(), scale.data_ptr(), bank.data_ptr(), out.data_ptr(), b, m, k, w, int(n), c,
    )
    LAUNCHES += 1
    return out
