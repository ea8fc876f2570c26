"""Reconstruction, both decode modes — the plain PyTorch path.

Counterpart of `hsc_tpu.ops.decode`: the stream-order ordered decode
(`mp_decode_jax` / `mp_decode_batch_jax`, decode_mode='ordered', format v1)
and the order-free integer decode (`mp_decode_integer_jax` and its batch
form, decode_mode='integer', format v2).

Ordered spec (`oracle.mp.mp_decode`): for each event in stream order,
``out[pos + u] = rn(out[pos + u] + rn(rn(code * scale) * bank[atom, u]))``.
Float addition does not reassociate, so the events are added one after
another; only the batch and the W samples of one event run in parallel.
The hand-written CUDA kernel (`ops.decode_kernel`) is held bitwise to
`mp_decode_batch_torch`.

Integer spec (`oracle.mp.mp_decode_integer`): ``out[t] = f32(sum_i code_i *
rep_q[atom_i][t - pos_i] mod 2^32) * amp_step`` over the events ``i <
count``.  Integer addition is order-free, so a scatter-add gives the spec's
integers in any order; the sums are taken in int64 and reduced mod 2^32
explicitly rather than relying on int32 overflow in a torch kernel.  The
hand-written CUDA kernel (`ops.decode_integer_kernel`) is held bitwise to
this function.
"""

from __future__ import annotations

import torch


def _live_events(positions, atoms, count, *, n: int, k: int, w: int):
    """``[B, M]`` mask of the events a decode adds: those before `count`
    that fit the block (an event that does not is never in a valid stream
    and contributes nothing)."""
    pos, atm = positions.long(), atoms.long()
    return (
        (torch.arange(positions.shape[1], device=positions.device)[None, :] < count[:, None].long())
        & (pos >= 0) & (pos <= n - w) & (atm >= 0) & (atm < k)
    )


def mp_decode_batch_torch(
    positions: torch.Tensor,  # [B, M] i32
    atoms: torch.Tensor,  # [B, M] i32
    codes: torch.Tensor,  # [B, M] i32
    count: torch.Tensor,  # [B] i32
    scale: torch.Tensor,  # [B] f32
    bank: torch.Tensor,  # [K, W, C] f32
    *,
    n: int,
) -> torch.Tensor:
    """Batched ordered decode -> ``[B, n, C]`` float32, bitwise
    `oracle.mp.mp_decode` per block.  Every product and every sum is its own
    rounded torch op (no `addcmul`, no `alpha=`): the products are formed
    first, then added to the output one event at a time.  A dead event adds
    ``+0.0`` at position 0, which changes nothing: a sum that starts at
    ``+0.0`` is never ``-0.0``.  A float64 `bank` gives the same sums in
    float64 (``code * scale`` is exact there), and autograd runs through it:
    the reference for the online learner's gradient."""
    b, m = positions.shape
    k, w, c = bank.shape
    dev = positions.device
    live = _live_events(positions, atoms, count, n=n, k=k, w=w)
    c_hat = codes.to(bank.dtype) * scale[:, None].to(bank.dtype)  # rn(code * scale)
    atm = torch.where(live, atoms.long(), 0)
    prods = torch.where(live[:, :, None, None], c_hat[:, :, None, None] * bank[atm], 0.0)
    cols = torch.where(live, positions.long(), 0)[:, :, None] + torch.arange(w, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    out = torch.zeros((b, n, c), dtype=bank.dtype, device=dev)
    for i in range(m):
        at = (rows, cols[:, i])
        out[at] = out[at] + prods[:, i]
    return out


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
    live = _live_events(positions, atoms, count, n=n, k=k, w=w)
    cz = torch.where(live, codes.long(), 0)
    pos = torch.where(live, positions.long(), 0)
    atm = torch.where(live, atoms.long(), 0)
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
