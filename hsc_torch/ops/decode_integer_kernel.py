"""Integer decode on the card: wrapper of the hand-written CUDA kernel
`hsc_torch/csrc/int_decode.cu` (the port of the Pallas kernel
`hsc_tpu/ops/decode_integer_kernel.py :: _int_decode_kernel`).

`mp_decode_integer_batch` is the dispatcher: a CPU tensor runs the plain
version (`ops.decode.mp_decode_integer_batch_torch`); a CUDA tensor launches
the kernel or raises — there is no fallback.  Like the Pallas wrapper, the
kernel takes single-channel representation tables only (C == 1, which is
every signal-space representation bank).  It takes any atom width and any
block length: it tiles the block as the ordered decode does
(`csrc/decode_tiles.cuh`), and no shared-memory size depends on either.
"""

from __future__ import annotations

import torch

from .. import _build
from .decode import mp_decode_integer_batch_torch
from .mp_kernels import check_tensor

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0


def mp_decode_integer_batch(
    positions: torch.Tensor,
    atoms: torch.Tensor,
    codes: torch.Tensor,
    count: torch.Tensor,
    amp_step: torch.Tensor,
    rep_q: torch.Tensor,
    *,
    n: int,
) -> torch.Tensor:
    """Batched integer decode -> ``[B, n, 1]`` float32, bitwise the plain
    version and `oracle.mp.mp_decode_integer`."""
    if positions.device.type == "cpu":
        return mp_decode_integer_batch_torch(
            positions, atoms, codes, count, amp_step, rep_q, n=n
        )
    if positions.device.type != "cuda":
        raise ValueError(f"integer decode: unsupported device {positions.device}")
    global LAUNCHES
    dev = positions.device
    if positions.dim() != 2 or rep_q.dim() != 3:
        raise ValueError("positions must be [B, M] and rep_q [K, W, C]")
    b, m = positions.shape
    k, w, c = rep_q.shape
    if c != 1:
        raise ValueError("the integer-decode kernel supports single-channel reps")
    if not 0 < w <= n:
        raise ValueError(f"atom width {w} does not fit a block of {n}")
    for name, t in (("positions", positions), ("atoms", atoms), ("codes", codes)):
        check_tensor(t, name, torch.int32, (b, m), dev)
    check_tensor(count, "count", torch.int32, (b,), dev)
    check_tensor(amp_step, "amp_step", torch.float32, (b,), dev)
    check_tensor(rep_q, "rep_q", torch.int32, (k, w, 1), dev)

    out = torch.empty((b, n, 1), dtype=torch.float32, device=dev)
    _build.launch(
        "hsc_int_decode", dev, positions.data_ptr(), atoms.data_ptr(), codes.data_ptr(),
        count.data_ptr(), amp_step.data_ptr(), rep_q.data_ptr(), out.data_ptr(), b, m, k, w, int(n),
    )
    LAUNCHES += 1
    return out
