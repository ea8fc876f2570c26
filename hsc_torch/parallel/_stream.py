"""The replicated half of a sharded greedy loop (`sp.sp_loop`, `tp.tp_loop`).

In the JAX package every shard of `shard_map` carries the same event
buffers, count, residual energy and stop flag, and updates them with the
same arithmetic after the selection collectives.  In one process one copy
is enough: it lives on the first shard's device, and each shard's
contribution to a collective is moved there.  Nothing here reads a device
value on the host.

The arithmetic is the single-device loop's (`ops.encode
.mp_encode_from_init_torch`): the quantizer and the energy recursion are
its own functions, `ops.encode.quantize` and `ops.encode.energy_step`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.encode import EncodedBlock, energy_step


def selection_weights(ids: torch.Tensor, n_raw: int, singleton_weight: float) -> torch.Tensor:
    """float32 selection weight of each global atom id in `ids`: 1 for a raw
    atom, `singleton_weight` (as float32) for a singleton."""
    return torch.where(
        ids < n_raw,
        torch.ones((), dtype=torch.float32, device=ids.device),
        torch.tensor(np.float32(singleton_weight), device=ids.device),
    )


def psum_winner(mask: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The packed `psum` of the JAX loops: each shard contributes its value
    where `mask` holds and 0 elsewhere, summed over the shard axis (dim 0).
    With one winner the sum is the winner's value exactly."""
    return torch.where(mask, values, torch.zeros((), dtype=values.dtype, device=values.device)).sum(dim=0)


def gather_to(dev: torch.device, parts: list[torch.Tensor]) -> torch.Tensor:
    """The shards' values stacked in shard order on `dev` (an all-gather)."""
    return torch.stack([p.to(dev) for p in parts])


class ReplicatedStream:
    """Event buffers, count, residual energy and stop flag of one block's
    sharded encode, on device `dev`."""

    def __init__(self, dev, num_coefs: int, e0, scale, inv_scale, tolerance_snr):
        f32 = torch.float32
        self.dev = dev
        self.num_coefs = int(num_coefs)
        self.e0 = torch.as_tensor(e0, dtype=f32).to(dev).reshape(())
        self.scale = torch.tensor(np.float32(scale), device=dev)
        self.inv_scale = torch.tensor(np.float32(inv_scale), device=dev)
        if tolerance_snr is not None:
            self.snr_thr = self.e0 * torch.tensor(np.float32(10.0 ** (-tolerance_snr / 10.0)), device=dev)
        else:
            self.snr_thr = torch.tensor(-1.0, dtype=f32, device=dev)
        self.positions = torch.zeros((self.num_coefs,), dtype=torch.int32, device=dev)
        self.atoms = torch.zeros_like(self.positions)
        self.codes = torch.zeros_like(self.positions)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.e_res = self.e0.clone()
        self.done = ~(self.scale > 0)

    def more(self) -> bool:
        """Host read: is the block still open (the sweep loop's condition)?"""
        return bool(~self.done & (self.count < self.num_coefs))

    def record(self, emit, t, f, code, s) -> torch.Tensor:
        """Store event ``(t, f, code)`` at the count where `emit` holds and
        advance the count and the residual energy by the score `s`; returns
        ``c_hat`` (0 where nothing was emitted)."""
        zero = torch.zeros((), dtype=torch.float32, device=self.dev)
        c_hat = torch.where(emit, code.to(torch.float32) * self.scale, zero)
        slot = self.count.clamp(max=max(self.num_coefs - 1, 0)).long().view(1)
        for buf, val in ((self.positions, t), (self.atoms, f), (self.codes, code)):
            buf[slot] = torch.where(emit, val.to(torch.int32), buf.index_select(0, slot))
        self.count = self.count + emit.to(torch.int32)
        self.e_res = torch.where(emit, energy_step(self.e_res, c_hat, s), self.e_res)
        return c_hat

    def result(self) -> EncodedBlock:
        return EncodedBlock(
            positions=self.positions,
            atoms=self.atoms,
            codes=self.codes,
            count=self.count,
            scale=self.scale,
            energy0=self.e0,
            energy_res=self.e_res.clamp_min(0.0),
        )
