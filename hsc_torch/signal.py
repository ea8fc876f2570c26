"""Synthetic event-stream signal generator — the fixture factory.

Reference parity (SURVEY.md §2 C3): `hsc/dataset.py :: SignalGenerator`
(`generateEvents`, `generateSignalFromEvents`): sample sparse events
(time, level, atom, coefficient) from per-atom rates, overlap-add atom
representations into a 1-D signal.  Host-side NumPy, seeded — byte-reproducible
because golden vectors for the bit-exactness tests derive from it
(SURVEY.md §3.2).

The port's own copy of `hsc_tpu/signal.py` (`Event` and `SignalGenerator`;
the audio synthesizers and WAV helpers stay in the JAX package): the
container bytes and the NumPy spec depend on this code, so it is copied
verbatim, quirks included, and tests/test_torch_copies.py holds it equal to
the original.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .dictionary import MultilevelDictionary


@dataclasses.dataclass(frozen=True)
class Event:
    time: int
    level: int
    atom: int
    coefficient: float


class SignalGenerator:
    """Samples events at per-(level, atom) rates and renders signals."""

    def __init__(
        self,
        mld: MultilevelDictionary,
        rates: list[np.ndarray] | float = 1e-3,
        amplitude_range: tuple[float, float] = (0.25, 2.0),
    ):
        """`rates`: per-level arrays of per-atom event probability per sample,
        or one scalar applied to every raw atom (singletons excluded — they are
        an encoder construct, not a generative one)."""
        self.mld = mld
        cfg = mld.config
        if isinstance(rates, (int, float)):
            self.rates = [
                np.full(cfg.counts[k], float(rates), dtype=np.float64)
                for k in range(cfg.num_levels)
            ]
        else:
            self.rates = [np.asarray(r, dtype=np.float64) for r in rates]
            for k, r in enumerate(self.rates):
                if r.shape != (cfg.counts[k],):
                    raise ValueError(f"rates[{k}] shape {r.shape} != ({cfg.counts[k]},)")
        self.amplitude_range = amplitude_range

    def generate_events(self, nb_samples: int, seed: int = 0) -> list[Event]:
        """Bernoulli thinning per atom per valid placement.

        Reference: `hsc/dataset.py :: SignalGenerator.generateEvents`.
        """
        rng = np.random.default_rng(seed)
        cfg = self.mld.config
        lo, hi = self.amplitude_range
        events: list[Event] = []
        for level in range(cfg.num_levels):
            scale = cfg.scales[level]
            n_pos = nb_samples - scale + 1
            if n_pos <= 0:
                continue
            for atom in range(cfg.counts[level]):
                hits = np.nonzero(rng.random(n_pos) < self.rates[level][atom])[0]
                for t in hits:
                    amp = float(rng.uniform(lo, hi)) * float(rng.choice([-1.0, 1.0]))
                    events.append(Event(int(t), level, atom, amp))
        events.sort(key=lambda e: (e.time, e.level, e.atom))
        return events

    def generate_signal_from_events(
        self, events: list[Event], nb_samples: int
    ) -> np.ndarray:
        """Overlap-add of signal-space representations.

        Reference: `hsc/dataset.py :: SignalGenerator.generateSignalFromEvents`.
        """
        signal = np.zeros(nb_samples, dtype=np.float32)
        for e in events:
            rep = self.mld.representations(e.level)[e.atom]
            signal[e.time : e.time + rep.shape[0]] += np.float32(e.coefficient) * rep
        return signal

    def generate_signals(
        self, nb_blocks: int, nb_samples: int, seed: int = 0
    ) -> np.ndarray:
        """Batch of independent blocks ``[nb_blocks, nb_samples]`` (the data-
        parallel unit of the TPU codec)."""
        out = np.zeros((nb_blocks, nb_samples), dtype=np.float32)
        for b in range(nb_blocks):
            ev = self.generate_events(nb_samples, seed=seed * 100003 + b)
            out[b] = self.generate_signal_from_events(ev, nb_samples)
        return out
