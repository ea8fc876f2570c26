"""The dictionary model: a frozen copy of the parts of the port's
`hsc_torch/dictionary.py` that the benchmark needs.

`generate` makes a cell's dictionaries from the seed (the program receives
the same arrays through `hsc_torch.params.dictionary_from_arrays`), and the
reference derives from them what it judges with: the augmented banks, the
signal-space representations and the integer-decode tables.  The
generation loop, `normalize` and `_compose_signal` are copied verbatim, so
a seed gives the dictionaries the port's own generator would give.
"""

from __future__ import annotations

import numpy as np

from .config import CodecConfig


def normalize(x: np.ndarray, axis=None, eps: float = 1e-12) -> np.ndarray:
    """Scale `x` to unit L2 norm (over `axis`, or globally if None)."""
    x = np.asarray(x, dtype=np.float32)
    norm = np.sqrt(np.sum(np.square(x.astype(np.float64)), axis=axis, keepdims=axis is not None))
    norm = np.maximum(norm, eps)
    return (x / norm).astype(np.float32)


def _compose_signal(filt: np.ndarray, lower_reps: np.ndarray, scale: int) -> np.ndarray:
    """Overlap-add expansion of one level-k filter into signal space."""
    w, c = filt.shape
    lower_len = lower_reps.shape[1]
    out = np.zeros(scale, dtype=np.float64)
    offs, chans = np.nonzero(filt)
    for u, ch in zip(offs, chans):
        out[u : u + lower_len] += float(filt[u, ch]) * lower_reps[ch].astype(np.float64)
    return out.astype(np.float32)


class MultilevelDictionary:
    """Per-level raw dictionaries and what the reference derives from them."""

    def __init__(self, config: CodecConfig, dicts: list[np.ndarray]):
        if len(dicts) != config.num_levels:
            raise ValueError("need one raw dictionary per level")
        self.config = config
        self.dicts: list[np.ndarray] = []
        ws, ch = config.window_sizes, config.channels
        for k, d in enumerate(dicts):
            d = np.asarray(d, dtype=np.float32)
            if k == 0 and d.ndim == 2:
                d = d[:, :, None]
            expect = (config.counts[k], ws[k], ch[k])
            if d.shape != expect:
                raise ValueError(f"level {k}: dict shape {d.shape} != {expect}")
            self.dicts.append(d)
        self._representations: dict[int, np.ndarray] = {}

    @classmethod
    def generate(
        cls,
        config: CodecConfig,
        seed: int = 0,
        decomposition_size: int = 3,
        max_correlation: float = 0.9,
        max_rejected: int = 100,
    ) -> "MultilevelDictionary":
        """Random ground-truth dictionary with a correlation-rejection loop
        (verbatim the port's `MultilevelDictionary.generate`)."""
        rng = np.random.default_rng(seed)
        ws, ch = config.window_sizes, config.channels
        dicts: list[np.ndarray] = []
        reps_prev: np.ndarray | None = None

        for k in range(config.num_levels):
            atoms = []
            sig_atoms = []
            rejected = 0
            while len(atoms) < config.counts[k]:
                if k == 0:
                    w = ws[0]
                    raw = rng.standard_normal(w).astype(np.float32)
                    kern = np.hanning(max(3, w // 4)).astype(np.float32)
                    raw = np.convolve(raw, kern / kern.sum(), mode="same")
                    raw *= np.hanning(w).astype(np.float32)
                    atom = normalize(raw)[:, None]
                    sig = atom[:, 0]
                else:
                    n_lower = reps_prev.shape[0]
                    size = min(decomposition_size, n_lower)
                    chans = rng.choice(n_lower, size=size, replace=False)
                    offs = rng.choice(ws[k], size=size, replace=True)
                    wts = rng.uniform(0.25, 1.0, size=size) * rng.choice(
                        [-1.0, 1.0], size=size
                    )
                    atom = np.zeros((ws[k], ch[k]), dtype=np.float32)
                    atom[offs, chans] = wts.astype(np.float32)
                    atom = normalize(atom)
                    sig = _compose_signal(atom, reps_prev, config.scales[k])
                ok = True
                for prev in sig_atoms:
                    c = np.correlate(sig, prev, mode="full")
                    denom = np.linalg.norm(sig) * np.linalg.norm(prev) + 1e-12
                    if np.max(np.abs(c)) / denom > max_correlation:
                        ok = False
                        break
                if ok:
                    atoms.append(atom)
                    sig_atoms.append(sig)
                    rejected = 0
                else:
                    rejected += 1
                    if rejected > max_rejected:
                        raise RuntimeError(
                            f"level {k}: exceeded {max_rejected} consecutive rejections"
                        )
            raw = np.stack(atoms)
            dicts.append(raw)
            if k == 0:
                reps_prev = raw[:, :, 0]
            else:
                c = ch[k]
                singles = np.zeros((c, ws[k], c), dtype=np.float32)
                singles[np.arange(c), 0, np.arange(c)] = 1.0
                aug = np.concatenate([raw, singles], axis=0)
                reps = np.zeros((aug.shape[0], config.scales[k]), dtype=np.float32)
                for a in range(aug.shape[0]):
                    reps[a] = _compose_signal(aug[a], reps_prev, config.scales[k])
                reps_prev = reps
        return cls(config, dicts)

    def augmented(self, level: int) -> np.ndarray:
        """``[Ka, W, C]``: raw atoms, then one singleton (unit delta at
        offset 0 on channel s) per lower channel at levels >= 1."""
        raw = self.dicts[level]
        if level == 0:
            return raw
        k, w, c = raw.shape
        singles = np.zeros((c, w, c), dtype=np.float32)
        singles[np.arange(c), 0, np.arange(c)] = 1.0
        return np.concatenate([raw, singles], axis=0)

    def representations(self, level: int) -> np.ndarray:
        """Signal-space expansion of every augmented atom, ``[Ka, scales[k]]``."""
        if level not in self._representations:
            if level == 0:
                self._representations[0] = self.dicts[0][:, :, 0]
            else:
                lower = self.representations(level - 1)
                scale = self.config.scales[level]
                aug = self.augmented(level)
                reps = np.zeros((aug.shape[0], scale), dtype=np.float32)
                for a in range(aug.shape[0]):
                    reps[a] = _compose_signal(aug[a], lower, scale)
                self._representations[level] = reps
        return self._representations[level]
