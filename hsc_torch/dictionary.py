"""Multilevel ("atoms-of-atoms") dictionary model.

Reference parity (SURVEY.md §2 C1–C2): `hsc/dataset.py :: MultilevelDictionary`
(generate / fromRawDictionaries / fromDecompositions / getRawDictionary /
upToLevel / visualize) and `hsc/dataset.py :: addSingletonBases`.

Design notes (TPU-first, not a port):
  * A level-k *raw* filter is stored dense as ``[W_k, C_k]`` float32 where
    ``C_k`` is the number of augmented atoms at level k-1 (channels).  The
    reference keeps decompositions (index/offset/weight triples) as the primary
    structure; here the dense filter IS the decomposition — nonzeros of the
    filter are exactly the (offset, channel, weight) triples.  Dense storage is
    what the MXU wants: level-k correlation is one big matmul.
  * Singleton (passthrough) atoms are *derived*, never stored: augmented
    dictionary at level k = concat(raw atoms, one delta-at-(0, s) atom per
    lower channel s).  This keeps save/load minimal and the augmentation
    bit-exactly reproducible.
  * Gram tensors (filter×filter correlations at all lags) are computed here on
    the host in float64 and cast to float32 once, then shared verbatim by the
    NumPy oracle and the TPU encoder — both run the *same* Gram-domain greedy
    update, which is what makes encode streams reproducible across backends
    (SURVEY.md §7 H2).

The port's own copy of `hsc_tpu/dictionary.py`: the container bytes and
the NumPy spec depend on this code, so it is copied verbatim, quirks
included, and tests/test_torch_copies.py holds it equal to the original
(`visualize` imports matplotlib only when it is called).
"""

from __future__ import annotations

import numpy as np

from .config import CodecConfig
from .utils import normalize


def bank_gram(bank: np.ndarray) -> np.ndarray:
    """Filter-bank autocorrelation ``G[f, g, d]`` for any ``[K, W, C]`` bank;
    lag index d in [0, 2W-2] maps to shift ``d - (W-1)``.

    ``G[f, g, d] = sum_{u, c} A[f, u, c] * A[g, u + d - (W-1), c]`` with zero
    padding.  Computed in float64, cast to float32 once — this is a
    bit-exactness-critical spec surface: the SAME array feeds the NumPy
    oracle and the TPU encoder (SURVEY.md §7 H2), and the online learner
    (`learn.online`) builds its per-step Gram with this same function."""
    a = np.asarray(bank, dtype=np.float64)  # [K, W, C]
    k, w, c = a.shape
    pad = np.zeros((k, 3 * w - 2, c), dtype=np.float64)
    pad[:, w - 1 : 2 * w - 1, :] = a
    # windows[g, d, u, c] = pad[g, d + u, c]; shape [K, 2W-1, C, W]
    windows = np.lib.stride_tricks.sliding_window_view(pad, w, axis=1)
    g = np.einsum("fuc,gdcu->fgd", a, windows, optimize=True)
    return g.astype(np.float32)


class MultilevelDictionary:
    """Per-level raw dictionaries + derived augmented filters, representations
    (signal-space expansions) and Gram tensors."""

    def __init__(self, config: CodecConfig, dicts: list[np.ndarray]):
        if len(dicts) != config.num_levels:
            raise ValueError("need one raw dictionary per level")
        self.config = config
        self.dicts: list[np.ndarray] = []
        ws = config.window_sizes
        ch = config.channels
        for k, d in enumerate(dicts):
            d = np.asarray(d, dtype=np.float32)
            if k == 0 and d.ndim == 2:
                d = d[:, :, None]  # [K0, W0] -> [K0, W0, 1]
            expect = (config.counts[k], ws[k], ch[k])
            if d.shape != expect:
                raise ValueError(f"level {k}: dict shape {d.shape} != {expect}")
            self.dicts.append(d)
        self._augmented: dict[int, np.ndarray] = {}
        self._representations: dict[int, np.ndarray] = {}
        self._grams: dict[int, np.ndarray] = {}

    # ---- constructors -----------------------------------------------------

    @classmethod
    def from_raw_dictionaries(cls, dicts, config: CodecConfig) -> "MultilevelDictionary":
        """Reference: `hsc/dataset.py :: MultilevelDictionary.fromRawDictionaries`."""
        return cls(config, list(dicts))

    @classmethod
    def from_decompositions(
        cls,
        level0: np.ndarray,
        decompositions: list[list[tuple[np.ndarray, np.ndarray, np.ndarray]]],
        config: CodecConfig,
    ) -> "MultilevelDictionary":
        """Build from (channels, offsets, weights) triples per atom per level>=1.

        Reference: `hsc/dataset.py :: MultilevelDictionary.fromDecompositions`.
        """
        dicts = [np.asarray(level0, dtype=np.float32)]
        ws, ch = config.window_sizes, config.channels
        for k, level in enumerate(decompositions, start=1):
            d = np.zeros((config.counts[k], ws[k], ch[k]), dtype=np.float32)
            for a, (channels, offsets, weights) in enumerate(level):
                d[a, np.asarray(offsets), np.asarray(channels)] = np.asarray(
                    weights, dtype=np.float32
                )
            dicts.append(d)
        return cls(config, dicts)

    @classmethod
    def generate(
        cls,
        config: CodecConfig,
        seed: int = 0,
        decomposition_size: int = 3,
        max_correlation: float = 0.9,
        max_rejected: int = 100,
    ) -> "MultilevelDictionary":
        """Random ground-truth dictionary with a correlation-rejection loop so
        atoms stay diverse.

        Reference: `hsc/dataset.py :: MultilevelDictionary.generate` (noise ->
        smoothing -> normalize; per-atom rejection against accepted atoms,
        guarded by `maxNbPatternsConsecutiveRejected`).  Host-side NumPy by
        design — generation is one-off (SURVEY.md §3.1).
        """
        rng = np.random.default_rng(seed)
        ws, ch = config.window_sizes, config.channels
        dicts: list[np.ndarray] = []
        reps_prev: np.ndarray | None = None  # augmented reps of previous level

        for k in range(config.num_levels):
            atoms = []
            sig_atoms = []  # signal-space representations, for rejection test
            rejected = 0
            while len(atoms) < config.counts[k]:
                if k == 0:
                    w = ws[0]
                    raw = rng.standard_normal(w).astype(np.float32)
                    # smooth: moving average + Hann taper so atoms are bandlimited
                    kern = np.hanning(max(3, w // 4)).astype(np.float32)
                    raw = np.convolve(raw, kern / kern.sum(), mode="same")
                    raw *= np.hanning(w).astype(np.float32)
                    atom = normalize(raw)[:, None]  # [W0, 1]
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
                # rejection: near-duplicate (max cross-correlation at any lag)
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
            # augmented representations of this level, feeding the next level's
            # composition (mirrors MultilevelDictionary.representations)
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

    # ---- derived structures ----------------------------------------------

    def augmented(self, level: int) -> np.ndarray:
        """Augmented filter bank ``[Ka_k, W_k, C_k]``: raw atoms then one
        singleton (unit delta at offset 0, channel s) per lower channel.

        Reference: `hsc/dataset.py :: addSingletonBases`; selection-side
        weighting lives in the encoder (`singleton_weight`).
        """
        if level not in self._augmented:
            raw = self.dicts[level]
            if level == 0:
                self._augmented[level] = raw
            else:
                k, w, c = raw.shape
                singles = np.zeros((c, w, c), dtype=np.float32)
                singles[np.arange(c), 0, np.arange(c)] = 1.0
                self._augmented[level] = np.concatenate([raw, singles], axis=0)
        return self._augmented[level]

    def num_atoms(self, level: int, with_singletons: bool = True) -> int:
        if with_singletons:
            return self.config.counts_with_singletons[level]
        return self.config.counts[level]

    def decompositions(self, level: int) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Per raw atom: (channels, offsets, weights) nonzero triples.

        Reference: `hsc/dataset.py` decomposition accessors — here derived from
        the dense filters (they are the same information).
        """
        if level == 0:
            raise ValueError("level 0 atoms have no decomposition")
        out = []
        for a in range(self.config.counts[level]):
            offs, chans = np.nonzero(self.dicts[level][a])
            out.append((chans, offs, self.dicts[level][a][offs, chans]))
        return out

    def representations(self, level: int) -> np.ndarray:
        """Signal-space expansion of every *augmented* atom: ``[Ka, scales[k]]``.

        Raw atoms expand recursively through lower representations; singleton s
        is the lower atom s left-aligned and zero-padded to scales[k].
        Reference: the `representations` arrays of
        `hsc/dataset.py :: MultilevelDictionary` (used by `SignalGenerator` and
        reconstruction).
        """
        if level not in self._representations:
            if level == 0:
                self._representations[0] = self.dicts[0][:, :, 0]
            else:
                lower = self.representations(level - 1)  # [C, scale_{k-1}]
                scale = self.config.scales[level]
                aug = self.augmented(level)  # [Ka, W, C]
                ka = aug.shape[0]
                reps = np.zeros((ka, scale), dtype=np.float32)
                for a in range(ka):
                    reps[a] = _compose_signal(aug[a], lower, scale)
                self._representations[level] = reps
        return self._representations[level]

    def gram(self, level: int) -> np.ndarray:
        """Filter-bank autocorrelation ``G[f, g, d]`` for the augmented bank at
        `level`; lag index d in [0, 2W-2] maps to shift ``d - (W-1)``.

        ``G[f, g, d] = sum_{u, c} A[f, u, c] * A[g, u + d - (W-1), c]`` with
        zero padding.  Computed in float64, cast to float32 once — this exact
        array is shared by the NumPy oracle and the TPU encoder so their
        Gram-domain greedy updates are bitwise identical (SURVEY.md §7 H2).
        """
        if level not in self._grams:
            self._grams[level] = bank_gram(self.augmented(level))
        return self._grams[level]

    def up_to_level(self, level: int) -> "MultilevelDictionary":
        """Truncated copy with levels [0, level].  Reference:
        `hsc/dataset.py :: MultilevelDictionary.upToLevel`."""
        import dataclasses as dc

        n = level + 1
        cfg = dc.replace(
            self.config,
            counts=self.config.counts[:n],
            scales=self.config.scales[:n],
            num_coefs=self.config.num_coefs[:n],
        )
        return MultilevelDictionary(cfg, [d.copy() for d in self.dicts[:n]])

    # ---- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        """Save config + raw dictionaries (np archive).  Reference:
        `hsc/dataset.py :: MultilevelDictionary.save` (pickle/np archive)."""
        arrays = {f"dict_{k}": d for k, d in enumerate(self.dicts)}
        np.savez(path, config=np.frombuffer(self.config.to_json().encode(), dtype=np.uint8), **arrays)

    @classmethod
    def load(cls, path: str) -> "MultilevelDictionary":
        with np.load(path) as z:
            cfg = CodecConfig.from_json(bytes(z["config"]).decode())
            dicts = [z[f"dict_{k}"] for k in range(cfg.num_levels)]
        return cls(cfg, dicts)

    def visualize(self, path: str | None = None):
        """Plot every level's signal-space atoms in a near-square grid.

        Reference: `hsc/dataset.py :: MultilevelDictionary.visualize`.
        Returns the matplotlib figure list (one per level)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from .utils import find_grid_size

        figs = []
        for k in range(self.config.num_levels):
            reps = self.representations(k)[: self.config.counts[k]]
            rows, cols = find_grid_size(reps.shape[0])
            fig, axes = plt.subplots(rows, cols, figsize=(2 * cols, 1.5 * rows))
            axes = np.atleast_1d(axes).ravel()
            for i, ax in enumerate(axes):
                if i < reps.shape[0]:
                    ax.plot(reps[i], lw=0.8)
                ax.set_xticks([])
                ax.set_yticks([])
            fig.suptitle(f"level {k} atoms (signal space)")
            if path:
                fig.savefig(f"{path}.level{k}.png", dpi=100)
            figs.append(fig)
        return figs


def _compose_signal(filt: np.ndarray, lower_reps: np.ndarray, scale: int) -> np.ndarray:
    """Overlap-add expansion of one level-k filter into signal space.

    ``out = sum_{u, c} filt[u, c] * shift(lower_reps[c], by=u)``; coefficient
    offset u maps 1:1 to a signal offset because level-(k-1) coefficient
    position p means "atom placed at sample p" (valid-mode correlation, no
    padding anywhere in the spec).
    """
    w, c = filt.shape
    lower_len = lower_reps.shape[1]
    out = np.zeros(scale, dtype=np.float64)
    offs, chans = np.nonzero(filt)
    for u, ch in zip(offs, chans):
        out[u : u + lower_len] += float(filt[u, ch]) * lower_reps[ch].astype(np.float64)
    return out.astype(np.float32)
