"""The MP init step: valid cross-correlation of blocks against a bank.

Counterpart of `hsc_tpu.ops.correlate.correlate_bank_jax` (an XLA conv at
`Precision.HIGHEST`, outside any Pallas kernel).  Here it is `F.conv1d` in
float32 — TF32 is off (`device.resolve_device`) because the scores feed the
quantizer directly.  The reduction order is the backend's choice, so the
scores agree with JAX only to a tolerance; everything after the init is
bitwise (README "Determinism contract").
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def correlate_bank_torch(x: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """``x [B, N, C]`` against ``bank [K, W, C]`` -> scores ``[B, K, npos]``
    with ``scores[b, k, t] = sum_{u,c} x[b, t+u, c] * bank[k, u, c]``
    (conv1d is cross-correlation: no kernel flip)."""
    return F.conv1d(x.transpose(1, 2), bank.permute(0, 2, 1))
