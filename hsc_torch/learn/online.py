"""Online convolutional dictionary learning — minibatch gradient updates,
counterpart of `hsc_tpu.learn.online`.

BASELINE.json config 4: "Online dictionary learning (MP + gradient/k-SVD-
style update)".  The k-means alternating path lives in `learn.kmeans`; this
is the *online* form:

  per minibatch:  MP-encode the blocks with the current bank (the greedy-loop
  kernel on a card; amplitudes quantized and then FROZEN)  ->  one gradient
  step on the reconstruction loss wrt the bank (the loss is linear in the
  bank given the frozen events)  ->  one `torch.optim` step  ->  re-project
  atoms to unit norm.

The reconstruction is `_OverlapAdd`: its forward is the ordered decode
(`ops.decode_kernel.mp_decode_batch`, the CUDA kernel on a card), and its
backward gathers each live event's window of the incoming gradient and sums
them per atom with one signed one-hot product in IEEE float32
(`device.spec_numerics`), so two runs give the same gradient bit for bit.
With a `mesh`, the minibatch encode stays unsharded (as in the JAX
package); each shard computes the loss and gradient of its
blocks on its device, the shards' losses and gradients are summed in shard
order, and one optimizer step follows.  optax's Adam becomes
`torch.optim.Adam` with the same defaults (b1 0.9, b2 0.999, eps 1e-8); the
two round differently, so a bank agrees with the JAX package's to a
tolerance, not bitwise.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import resolve_device, spec_numerics
from ..dictionary import bank_gram
from ..models.coder import ConvolutionalMatchingPursuit
from ..ops.decode import _live_events
from ..ops.decode_kernel import mp_decode_batch


class _OverlapAdd(torch.autograd.Function):
    """``recon [B, n, C]`` of frozen events against ``bank [K, W, C]``:
    ``amp = code * scale``, then the overlap-add of ``amp * bank[atom]`` in
    stream order, events past `count` dropped (JAX's `_reconstruct`).  Only
    the bank gets a gradient."""

    @staticmethod
    def forward(ctx, bank, positions, atoms, codes, count, scale, n: int):
        ctx.save_for_backward(positions, atoms, codes, count, scale)
        ctx.bank_shape, ctx.n = tuple(bank.shape), int(n)
        return mp_decode_batch(positions, atoms, codes, count, scale, bank, n=int(n))

    @staticmethod
    def backward(ctx, grad):
        """``dbank[k, u, c] = sum over live events (b, i) with atom k of
        amp_{b,i} * grad[b, pos_{b,i} + u, c]``."""
        positions, atoms, codes, count, scale = ctx.saved_tensors
        k, w, c = ctx.bank_shape
        b, m = positions.shape
        live = _live_events(positions, atoms, count, n=ctx.n, k=k, w=w)
        amp = torch.where(live, codes.to(grad.dtype) * scale[:, None].to(grad.dtype), 0.0)
        pos = torch.where(live, positions.long(), 0)
        cols = pos[:, :, None] + torch.arange(w, device=grad.device)  # [B, M, W]
        windows = grad[torch.arange(b, device=grad.device)[:, None, None], cols]  # [B, M, W, C]
        atm = torch.where(live, atoms.long(), 0).reshape(-1)
        onehot = (atm[:, None] == torch.arange(k, device=grad.device)).to(grad.dtype)
        weighted = onehot * amp.reshape(-1, 1)  # [B*M, K]
        # pinned at the op, whoever calls backward() and on whichever
        # thread autograd runs it
        with spec_numerics():
            dbank = weighted.T @ windows.reshape(b * m, w * c)
        return dbank.reshape(k, w, c), None, None, None, None, None, None


class OnlineConvolutionalDictionaryLearner:
    """Streaming learner for one level's bank (single- or multi-channel) on
    `device`."""

    def __init__(
        self,
        bank0: np.ndarray,  # [K, W, C] initial (e.g. from 'samples' init)
        *,
        num_coefs: int = 64,
        amp_bits: int = 16,
        optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
        learning_rate: float = 1e-2,
        mesh=None,
        mesh_axis: str = "data",
        device,
    ):
        self.device = resolve_device(device)
        if mesh is not None:
            from ..parallel.mesh import check_mesh_device

            check_mesh_device(mesh, self.device, "OnlineConvolutionalDictionaryLearner")
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.bank = torch.nn.Parameter(
            torch.tensor(np.asarray(bank0, dtype=np.float32), device=self.device)
        )
        self.num_coefs = int(num_coefs)
        self.amp_bits = int(amp_bits)
        if optimizer is None:
            def optimizer(params):
                return torch.optim.Adam(params, lr=learning_rate)
        self.opt = optimizer([self.bank])
        self.step_count = 0
        self.loss_history: list[float] = []

    def step(self, blocks: np.ndarray) -> float:
        """One online step on a minibatch ``[B, N, C]`` (or ``[B, N]``);
        returns the minibatch reconstruction loss (pre-update)."""
        xs = np.asarray(blocks, dtype=np.float32)
        if xs.ndim == 2:
            xs = xs[:, :, None]
        n = xs.shape[1]
        # 1. sparse-code the minibatch with the CURRENT bank
        bank_np = self.bank.detach().cpu().numpy()
        mp = ConvolutionalMatchingPursuit(
            bank_np, bank_gram(bank_np),
            num_coefs=self.num_coefs, amp_bits=self.amp_bits, device=self.device,
        )
        enc = mp.compute_coefficients_batch(xs)
        # 2. gradient step on the frozen-event reconstruction loss: the sum's
        # gradient, then both divided by the element count (as the JAX step)
        total = int(np.prod(xs.shape))
        self.opt.zero_grad(set_to_none=True)
        events = (enc.positions, enc.atoms, enc.codes, enc.count, enc.scale)
        loss = self._sharded_backward(xs, events, n)
        self.bank.grad.div_(total)
        self.opt.step()
        # 3. re-project to unit-norm atoms (the codec invariant)
        with torch.no_grad():
            norms = self.bank.square().sum(dim=(1, 2), keepdim=True).sqrt()
            self.bank.div_(norms.clamp_min(1e-8))
        self.step_count += 1
        val = float(loss.detach() / total)
        self.loss_history.append(val)
        return val

    def _sharded_backward(self, xs: np.ndarray, events, n: int) -> torch.Tensor:
        """Loss and gradient of the minibatch split over the mesh axis (one
        shard on ``self.device`` without a mesh): each shard's sum of
        squares and its gradient through `_OverlapAdd` on its device, summed
        in shard order into the loss (returned) and ``bank.grad``."""
        from ..parallel.mesh import psum

        devs = [self.device] if self.mesh is None else self.mesh.axis_devices(self.mesh_axis)
        b = xs.shape[0]
        if b % len(devs):
            raise ValueError(
                f"a minibatch of {b} blocks must divide the {self.mesh_axis}-axis size {len(devs)}"
            )
        per = b // len(devs)
        losses, grads = [], []
        for i, dev in enumerate(devs):
            rows = slice(i * per, (i + 1) * per)
            bank = self.bank.detach().to(dev).requires_grad_(True)
            recon = _OverlapAdd.apply(bank, *(e[rows].to(dev) for e in events), n)
            loss = (torch.from_numpy(xs[rows]).to(dev) - recon).square().sum()
            (grad,) = torch.autograd.grad(loss, bank)
            losses.append(loss.detach())
            grads.append(grad)
        self.bank.grad = psum(self.device, grads)
        return psum(self.device, losses)
