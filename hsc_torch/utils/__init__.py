"""Small numeric helpers shared by host-side code.

The port's own copy of `hsc_tpu/utils/__init__.py` but for
`device_get_pipelined` (JAX only): `normalize`, `overlap_add`,
`overlap_replace`, `find_grid_size`, `snr_db` and `Timer`.  Reference
parity: `hsc/utils.py :: normalize, overlapAdd, overlapReplace,
findGridSize` (SURVEY.md §2 C10).  They run on the host (NumPy); the
dictionary generator, its `visualize` and the SNR readouts use them, and
`Timer` times the measuring scripts' host steps.
tests/test_torch_copies.py holds them equal to the originals.
"""

from __future__ import annotations

import math
import time

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


def overlap_add(signal: np.ndarray, patch: np.ndarray, t: int) -> None:
    """In-place ``signal[t : t+len(patch)] += patch`` (leading axis).

    Reference: `hsc/utils.py :: overlapAdd`.  Bounds must be valid — the codec
    spec only places atoms at fully-interior positions (CodecConfig.num_positions).
    """
    w = patch.shape[0]
    signal[t : t + w] += patch


def overlap_replace(signal: np.ndarray, patch: np.ndarray, t: int) -> None:
    """In-place ``signal[t : t+len(patch)] = patch``.

    Reference: `hsc/utils.py :: overlapReplace`.
    """
    w = patch.shape[0]
    signal[t : t + w] = patch


def find_grid_size(n: int) -> tuple[int, int]:
    """(rows, cols) of the squarest grid holding n panels.

    Reference: `hsc/utils.py :: findGridSize` (figure layout helper).
    """
    if n <= 0:
        return (0, 0)
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    return rows, cols


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


class Timer:
    """Context-manager wall-clock timer (reference keeps a profiling helper in
    `hsc/utils.py`; here it feeds the bench harness)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False
