"""The int8 level >= 1 init on the card: wrapper of the hand-written CUDA
kernels `hsc_torch/csrc/sparse_init.cu` (the port of the Pallas kernel
`hsc_tpu/ops/init_kernels.py :: _sparse_init_kernel` and of the singleton,
e0 and peak part of `hsc_tpu/ops/encode.py :: int8_assemble_batched`).

`int8_init` takes the emitting level's events, as the plain version
(`ops.encode.int8_init_from_events_torch`) does, and returns the whole score
buffer, e0 and the peak.  A CPU tensor runs the plain version; a CUDA tensor
launches the kernels or raises — there is no fallback.  On the card no dense
``[B, N, C]`` map is built: one kernel merges each block's events into
sorted cell sums (the counterpart of the Pallas path's `aggregate_codes`),
a second writes every score row from them.  The scores and the peak are
bitwise the plain version's; e0 is an f32 sum in another order (within
1e-6 of it, relative).  It takes every geometry and every event count
`CodecConfig` admits for hier_init='int8' (``W * C <= 65535``; up to 65281
events per block at amp_bits=16): the cell kernel sorts a block's events in
shared memory where they fit the card (16384 on an H100) and past that in a
global workspace that `int8_init` allocates (`hsc_int8_init_workspace` says
how much).
"""

from __future__ import annotations

import torch

from .. import _build
from .encode import int8_init_from_events_torch
from .mp_kernels import check_tensor

# kernel launches since import (or since a caller reset it to 0); one launch
# is one call's pair of kernels
LAUNCHES = 0
# the .cu's kIndexStride (positions per entry of the cell kernel's index)
INDEX_STRIDE = 32


def kernel_planes(bank_planes: torch.Tensor) -> torch.Tensor:
    """The bank planes ``[n_raw, W, C, 2]`` in the kernel's layout ``[C,
    n_raw, Wp, 2]``: each (channel, raw atom) row of offsets contiguous and
    zero-padded to ``Wp``, a multiple of 8, so the kernel stages rows with
    16-byte loads.  A coder makes it once
    (`models.coder.ConvolutionalMatchingPursuit`)."""
    n_raw, w, c, _ = bank_planes.shape
    out = bank_planes.new_zeros((c, n_raw, -(-w // 8) * 8, 2))
    out[:, :, :w] = bank_planes.permute(2, 0, 1, 3)
    return out


def int8_init(
    positions: torch.Tensor,
    atoms: torch.Tensor,
    codes: torch.Tensor,
    count: torch.Tensor,
    prev_scale: torch.Tensor,
    bank_planes: torch.Tensor,
    step,
    *,
    n_map: int,
    planes_cnw: torch.Tensor | None = None,
):
    """The int8 init of a level >= 1 from the emitting level's events:
    ``positions``, ``atoms``, ``codes`` ``[B, M]`` int32 padded buffers with
    ``count [B]`` int32 and the scales ``prev_scale [B]`` f32, against
    ``bank_planes [n_raw, W, C, 2]`` int8 with the f32 bank step `step`, on
    a map of `n_map` positions -> ``(scores0 [B, n_raw + C, npos], e0 [B],
    peak [B])``.  `planes_cnw` is `kernel_planes(bank_planes)`, made once by
    the caller; without it each call makes it."""
    if positions.device.type == "cpu":
        return int8_init_from_events_torch(
            positions, atoms, codes, count, prev_scale, bank_planes, step, n_map=n_map
        )
    if positions.device.type != "cuda":
        raise ValueError(f"int8_init: unsupported device {positions.device}")
    global LAUNCHES
    dev = positions.device
    if positions.dim() != 2 or bank_planes.dim() != 4:
        raise ValueError("events must be [B, M] and bank_planes [n_raw, W, C, 2]")
    b, m = positions.shape
    n_raw, w, c = (int(s) for s in bank_planes.shape[:3])
    npos = n_map - w + 1
    if npos < 1:
        raise ValueError(f"atom width {w} does not fit a map of {n_map} positions")
    if n_map * c >= 2**31 - 1:
        raise ValueError(f"a map of {n_map} x {c} cells does not fit the kernel's int32 keys")
    for t, name in ((positions, "positions"), (atoms, "atoms"), (codes, "codes")):
        check_tensor(t, name, torch.int32, (b, m), dev)
    check_tensor(count, "count", torch.int32, (b,), dev)
    check_tensor(prev_scale, "prev_scale", torch.float32, (b,), dev)
    check_tensor(bank_planes, "bank_planes", torch.int8, (n_raw, w, c, 2), dev, contiguous=False)
    if planes_cnw is None:
        planes_cnw = kernel_planes(bank_planes)
    check_tensor(planes_cnw, "planes_cnw", torch.int8, (c, n_raw, -(-w // 8) * 8, 2), dev)
    scores0 = torch.empty((b, n_raw + c, npos), dtype=torch.float32, device=dev)
    e0 = torch.empty((b,), dtype=torch.float32, device=dev)
    peak_bits = torch.empty((b,), dtype=torch.int32, device=dev)
    n_index = -(-n_map // INDEX_STRIDE) + 1
    work = torch.empty((2 * b * m + b * n_index,), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        ws_ints = lib.hsc_int8_init_workspace(m)
    if ws_ints < 0:
        _build.check(lib, -ws_ints, f"hsc_int8_init_workspace({m})")
    # B slices of the cell kernel's sort, where it does not fit in shared memory
    sort_ws = torch.empty((b * ws_ints,), dtype=torch.int32, device=dev) if ws_ints else None
    _build.launch(
        "hsc_int8_init", dev, positions.data_ptr(), atoms.data_ptr(), codes.data_ptr(),
        count.data_ptr(), prev_scale.data_ptr(), planes_cnw.data_ptr(), work.data_ptr(),
        None if sort_ws is None else sort_ws.data_ptr(), scores0.data_ptr(), e0.data_ptr(),
        peak_bits.data_ptr(), float(step), b, m, n_map, c, n_raw, w, n_index,
    )
    LAUNCHES += 1
    # non-negative floats order like their bits: the kernels' integer max of
    # the bits of |score| is the float max
    return scores0, e0, peak_bits.view(torch.float32)
