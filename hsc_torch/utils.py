"""Small numeric helpers shared by host-side code.

The port's own copy of `normalize` and `snr_db` from
`hsc_tpu/utils/__init__.py` (the dictionary generator and the SNR readouts
depend on them); tests/test_torch_copies.py holds them equal to the originals.
"""

from __future__ import annotations

import math

import numpy as np


def normalize(x: np.ndarray, axis=None, eps: float = 1e-12) -> np.ndarray:
    """Scale `x` to unit L2 norm (over `axis`, or globally if None).

    Reference: `hsc/utils.py :: normalize` — atoms are unit-norm so the MP
    amplitude equals the raw correlation.
    """
    x = np.asarray(x, dtype=np.float32)
    norm = np.sqrt(np.sum(np.square(x.astype(np.float64)), axis=axis, keepdims=axis is not None))
    norm = np.maximum(norm, eps)
    return (x / norm).astype(np.float32)


def snr_db(reference: np.ndarray, approx: np.ndarray) -> float:
    """SNR in dB of `approx` against `reference` (both float arrays)."""
    ref = np.asarray(reference, dtype=np.float64)
    err = ref - np.asarray(approx, dtype=np.float64)
    num = float(np.sum(ref * ref))
    den = float(np.sum(err * err))
    if den == 0.0:
        return float("inf")
    if num == 0.0:
        return float("-inf")
    return 10.0 * math.log10(num / den)
