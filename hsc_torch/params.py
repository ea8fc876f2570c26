"""One level's weights as tensors: the bank, its Gram tensor, the selection
weights and the integer-decode table.

Counterpart of the arrays `hsc_tpu.models.coder.ConvolutionalMatchingPursuit`
builds (`bank`, `gram_t`, the `weights` of `ops.encode.mp_encode_from_init`)
and of `HierarchicalConvolutionalSparseCoder._rep_q`.  Every value is derived
on the host from the dictionary bytes alone, so the JAX package and the port
hold bit-identical tables (`level_params_from_numpy` carries the JAX coder's
own arrays across; `level_params_from_mld` rebuilds them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hsc_tpu.dictionary import MultilevelDictionary
from hsc_tpu.oracle.mp import rep_quantize

from .device import resolve_device


@dataclasses.dataclass(frozen=True)
class LevelParams:
    bank: torch.Tensor  # [K, W, C] f32
    gram_t: torch.Tensor  # [K, K, 2W-1] f32, gram_t[f][g, d] = G[g, f, d]
    weights: torch.Tensor  # [K] f32 selection weights (singleton weighting)
    rep_q: torch.Tensor | None  # [K, W, 1] i32 integer-decode table
    rep_step: np.float32 | None  # its f32 quantizer step (host scalar)


def level_params_from_numpy(
    bank,
    gram_t,
    *,
    rep_q=None,
    rep_step=None,
    n_raw: int,
    singleton_weight: float,
    device,
) -> LevelParams:
    """Tensors from host arrays: ``bank [K, W, C]``, the TRANSPOSED Gram
    ``gram_t [K, K, 2W-1]`` (as `np.asarray(jax_coder.mp.gram_t)`), and
    optionally the integer-decode table with its step."""
    dev = resolve_device(device)
    bank = np.asarray(bank, dtype=np.float32)
    k = bank.shape[0]
    weights = np.where(
        np.arange(k) < int(n_raw), np.float32(1), np.float32(singleton_weight)
    ).astype(np.float32)
    # torch.tensor copies: the tables never alias the caller's arrays
    return LevelParams(
        bank=torch.tensor(bank, device=dev),
        gram_t=torch.tensor(np.asarray(gram_t, dtype=np.float32), device=dev),
        weights=torch.tensor(weights, device=dev),
        rep_q=(
            None if rep_q is None
            else torch.tensor(np.asarray(rep_q, dtype=np.int32), device=dev)
        ),
        rep_step=None if rep_step is None else np.float32(rep_step),
    )


def level_params_from_mld(
    mld: MultilevelDictionary, level: int, device, rep_bits: int | None = None
) -> LevelParams:
    """The same tables built from a `MultilevelDictionary` (``rep_bits``
    defaults to the dictionary config's)."""
    cfg = mld.config
    gram_t = np.ascontiguousarray(mld.gram(level).transpose(1, 0, 2))
    rep_q, step = rep_quantize(
        mld.representations(level)[:, :, None], rep_bits or cfg.rep_bits
    )
    return level_params_from_numpy(
        mld.augmented(level),
        gram_t,
        rep_q=rep_q,
        rep_step=step,
        n_raw=cfg.counts[level],
        singleton_weight=cfg.singleton_weight if level > 0 else 1.0,
        device=device,
    )
