"""One level's weights as tensors: the bank, its Gram tensor, the selection
weights, both decode tables and the int8 init tables.

Counterpart of the arrays `hsc_tpu.models.coder.ConvolutionalMatchingPursuit`
builds (`bank`, `gram_t`, the `weights` of `ops.encode.mp_encode_from_init`,
and under ``int8_init`` its `bank_planes` / `bank_step`) and of
`HierarchicalConvolutionalSparseCoder._rep_q` / `._rep_banks`.  Every value is
derived on the host from the dictionary bytes alone, so the JAX package and
the port hold bit-identical tables (`level_params_from_numpy` carries the JAX
coder's own arrays across; `level_params_from_mld` rebuilds them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import CodecConfig
from .device import resolve_device
from .dictionary import MultilevelDictionary
from .oracle.mp import balanced_digits, bank_quantize_int16, rep_quantize


@dataclasses.dataclass(frozen=True)
class LevelParams:
    bank: torch.Tensor  # [K, W, C] f32
    gram_t: torch.Tensor  # [K, K, 2W-1] f32, gram_t[f][g, d] = G[g, f, d]
    weights: torch.Tensor  # [K] f32 selection weights (singleton weighting)
    rep_q: torch.Tensor | None  # [K, W, 1] i32 integer-decode table
    rep_step: np.float32 | None  # its f32 quantizer step (host scalar)
    # int8 level >= 1 init (hier_init='int8'): the balanced int8 digit planes
    # of the RAW sub-bank's int16 quantization, and its f32 step
    bank_planes: torch.Tensor | None = None  # [n_raw, W, C, 2] i8
    bank_step: np.float32 | None = None
    # ordered-decode table: the signal-space representations
    rep_bank: torch.Tensor | None = None  # [K, scales[level], 1] f32


def dictionary_from_arrays(config_json: str, dicts: list[np.ndarray]) -> MultilevelDictionary:
    """The port's `MultilevelDictionary` from a config's JSON and the raw
    per-level arrays (``hsc_tpu``'s ``mld.config.to_json()`` and
    ``mld.dicts``): how a dictionary crosses over from the JAX package.
    The arrays are copied, so the two never alias."""
    return MultilevelDictionary(
        CodecConfig.from_json(config_json), [np.array(d, dtype=np.float32) for d in dicts]
    )


def int8_bank_tables(bank_raw) -> tuple[np.ndarray, np.float32]:
    """``(bank_planes [n_raw, W, C, 2] int8, bank_step f32)`` of a raw
    sub-bank, as `hsc_tpu.models.coder.ConvolutionalMatchingPursuit` derives
    them (`oracle.mp.bank_quantize_int16`, then two balanced digits)."""
    bank_q, step = bank_quantize_int16(np.asarray(bank_raw, dtype=np.float32))
    return balanced_digits(bank_q, 2).astype(np.int8), np.float32(step)


def level_params_from_numpy(
    bank,
    gram_t,
    *,
    rep_q=None,
    rep_step=None,
    bank_planes=None,
    bank_step=None,
    rep_bank=None,
    n_raw: int,
    singleton_weight: float,
    device,
) -> LevelParams:
    """Tensors from host arrays: ``bank [K, W, C]``, the TRANSPOSED Gram
    ``gram_t [K, K, 2W-1]`` (as `np.asarray(jax_coder.mp.gram_t)`), and
    optionally the integer-decode table with its step, the int8 init planes
    with their step (``jax_coder.coders[k].mp.bank_planes`` / ``.bank_step``)
    and the ordered-decode table (``jax_coder._rep_banks[k]``)."""
    dev = resolve_device(device)
    bank = np.asarray(bank, dtype=np.float32)
    k = bank.shape[0]
    weights = np.where(
        np.arange(k) < int(n_raw), np.float32(1), np.float32(singleton_weight)
    ).astype(np.float32)

    def tensor(a, dtype):
        # torch.tensor copies: the tables never alias the caller's arrays
        return None if a is None else torch.tensor(np.asarray(a, dtype=dtype), device=dev)

    return LevelParams(
        bank=tensor(bank, np.float32),
        gram_t=tensor(gram_t, np.float32),
        weights=tensor(weights, np.float32),
        rep_q=tensor(rep_q, np.int32),
        rep_step=None if rep_step is None else np.float32(rep_step),
        bank_planes=tensor(bank_planes, np.int8),
        bank_step=None if bank_step is None else np.float32(bank_step),
        rep_bank=tensor(rep_bank, np.float32),
    )


def level_params_from_mld(
    mld: MultilevelDictionary, level: int, device, rep_bits: int | None = None
) -> LevelParams:
    """The same tables built from a `MultilevelDictionary` (``rep_bits``
    defaults to the dictionary config's).  The int8 init tables exist at
    levels >= 1 of a ``hier_init='int8'`` dictionary."""
    cfg = mld.config
    gram_t = np.ascontiguousarray(mld.gram(level).transpose(1, 0, 2))
    reps = mld.representations(level)[:, :, None]
    rep_q, step = rep_quantize(reps, rep_bits or cfg.rep_bits)
    planes = bank_step = None
    if level > 0 and cfg.hier_init == "int8":
        planes, bank_step = int8_bank_tables(mld.augmented(level)[: cfg.counts[level]])
    return level_params_from_numpy(
        mld.augmented(level),
        gram_t,
        rep_q=rep_q,
        rep_step=step,
        bank_planes=planes,
        bank_step=bank_step,
        rep_bank=reps,
        n_raw=cfg.counts[level],
        singleton_weight=cfg.singleton_weight if level > 0 else 1.0,
        device=device,
    )
