"""Order-free integer reconstruction (decode_mode='integer', format v2) —
the plain PyTorch path.

Counterpart of `hsc_tpu.ops.decode.mp_decode_integer_jax` and its batch
form.  Spec (`oracle.mp.mp_decode_integer`): ``out[t] = f32(sum_i code_i *
rep_q[atom_i][t - pos_i] mod 2^32) * amp_step`` over the events ``i <
count``.  Integer addition is order-free, so a scatter-add gives the spec's
integers in any order; the sums are taken in int64 and reduced mod 2^32
explicitly rather than relying on int32 overflow in a torch kernel.  The
hand-written CUDA kernel (`ops.decode_integer_kernel`) is held bitwise to
this function.
"""

from __future__ import annotations

import torch


def mp_decode_integer_batch_torch(
    positions: torch.Tensor,  # [B, M] i32
    atoms: torch.Tensor,  # [B, M] i32
    codes: torch.Tensor,  # [B, M] i32
    count: torch.Tensor,  # [B] i32
    amp_step: torch.Tensor,  # [B] f32, f32(f32(scale) * rep_step) per block
    rep_q: torch.Tensor,  # [K, W, C] i32
    *,
    n: int,
) -> torch.Tensor:
    """Batched decode -> ``[B, n, C]`` float32.  Events past `count`, and
    events that do not fit the block (never present in a valid stream),
    contribute nothing."""
    b, m = positions.shape
    k, w, c = rep_q.shape
    pos = positions.long()
    atm = atoms.long()
    live = (
        (torch.arange(m, device=positions.device)[None, :] < count[:, None].long())
        & (pos >= 0) & (pos <= n - w) & (atm >= 0) & (atm < k)
    )
    cz = torch.where(live, codes.long(), 0)
    pos = torch.where(live, pos, 0)
    atm = torch.where(live, atm, 0)
    contrib = cz[:, :, None, None] * rep_q.long()[atm]  # [B, M, W, C] exact
    idx = (pos[:, :, None] + torch.arange(w, device=positions.device))  # [B, M, W]
    acc = torch.zeros((b, n, c), dtype=torch.int64, device=positions.device)
    acc.scatter_add_(
        1, idx.reshape(b, m * w, 1).expand(b, m * w, c), contrib.reshape(b, m * w, c)
    )
    wrapped = ((acc + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)
    return wrapped.to(torch.float32) * amp_step[:, None, None]


def mp_decode_integer_torch(
    positions, atoms, codes, count, amp_step, rep_q, *, n: int
) -> torch.Tensor:
    """One block: ``[M]`` events, scalar `count`/`amp_step` -> ``[n, C]``."""
    return mp_decode_integer_batch_torch(
        positions[None], atoms[None], codes[None],
        torch.as_tensor(count, device=positions.device).reshape(1),
        torch.as_tensor(amp_step, dtype=torch.float32, device=positions.device).reshape(1),
        rep_q, n=n,
    )[0]
