"""Synthetic event-stream signal generator — the fixture factory.

Reference parity (SURVEY.md §2 C3): `hsc/dataset.py :: SignalGenerator`
(`generateEvents`, `generateSignalFromEvents`): sample sparse events
(time, level, atom, coefficient) from per-atom rates, overlap-add atom
representations into a 1-D signal.  Host-side NumPy, seeded — byte-reproducible
because golden vectors for the bit-exactness tests derive from it
(SURVEY.md §3.2).

The port's own copy of `hsc_tpu/signal.py`, whole: `Event`,
`SignalGenerator`, the audio synthesizers and the WAV helpers (scipy is
imported where they need it).  The container bytes and the NumPy spec
depend on this code, so it is copied verbatim, quirks included, and
tests/test_torch_copies.py holds it equal to the original statement for
statement.
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


def synthesize_music(
    n_samples: int, rate: int = 16000, seed: int = 0, *, polyphony: int = 3
) -> np.ndarray:
    """Realistically synthesized polyphonic music (float32, peak <= 1).

    The reference's purpose is hierarchical sparse coding of *audio*
    (SURVEY.md §6; `hsc/analysis.py :: calculateMultilevelInformationRates`
    runs on audio corpora).  This environment has no network, so the audio
    experiment corpus is synthesized with musical structure rather than
    drawn from event-stream dictionary atoms: plucked-string notes from a
    pentatonic scale with per-partial exponential decay, 1/h^1.6 harmonic
    rolloff, slight inharmonicity, vibrato, onset transients, and up to
    `polyphony` overlapping voices.  Seeded and byte-reproducible.
    """
    rng = np.random.default_rng(seed)
    out = np.zeros(n_samples, dtype=np.float64)
    # A-minor pentatonic across two octaves
    base = 220.0
    scale_steps = np.array([0, 3, 5, 7, 10, 12, 15, 17, 19, 22])
    freqs = base * 2.0 ** (scale_steps / 12.0)
    t_axis = np.arange(n_samples) / rate
    for _voice in range(polyphony):
        t = 0
        while t < n_samples:
            dur = int(rng.uniform(0.12, 0.5) * rate)  # 120-500 ms notes
            if rng.random() < 0.15:  # rests
                t += dur
                continue
            f0 = float(rng.choice(freqs)) * (1.0 + rng.normal(0, 2e-4))
            n = min(dur, n_samples - t)
            tt = t_axis[:n]
            # per-note vibrato (5 Hz, ~10 cents) after a 60 ms onset
            vib_depth = 0.006 * np.clip(tt / 0.06, 0, 1)
            phase_mod = 1.0 + vib_depth * np.sin(
                2 * np.pi * rng.uniform(4.5, 6.0) * tt
            )
            note = np.zeros(n)
            amp0 = rng.uniform(0.3, 1.0)
            decay = rng.uniform(1.5, 4.0)  # 1/s
            for h in range(1, 9):
                inharm = 1.0 + 4e-4 * h * h  # stiff-string stretch
                fh = f0 * h * inharm
                if fh >= rate / 2:
                    break
                a_h = amp0 / h ** 1.6
                env = np.exp(-decay * (1 + 0.35 * (h - 1)) * tt)
                note += a_h * env * np.sin(
                    2 * np.pi * fh * tt * phase_mod + rng.uniform(0, 2 * np.pi)
                )
            # attack ramp + pluck noise burst (first ~8 ms); both clamped to
            # the note length — the corpus tail can truncate a note below
            # the ramp/burst windows (unclamped, the fixed-length RHS
            # arrays raise a broadcast ValueError)
            atk = min(int(0.004 * rate), n)
            if atk > 1:
                note[:atk] *= np.linspace(0, 1, atk)
            burst = min(int(0.008 * rate), n)
            if burst > 0:
                note[:burst] += (
                    amp0 * 0.15 * rng.standard_normal(burst)
                    * np.linspace(1, 0, burst)
                )
            out[t : t + n] += note
            t += dur
    peak = np.max(np.abs(out))
    if peak > 0:
        out /= peak
    return out.astype(np.float32)


def synthesize_speech(
    n_samples: int, rate: int = 16000, seed: int = 0
) -> np.ndarray:
    """Realistically synthesized speech-like audio (float32, peak <= 1).

    Formant synthesis: voiced segments are glottal pulse trains with a
    declining pitch contour and jitter/shimmer, filtered through 3 vowel
    formant resonators (two-pole IIR sections); unvoiced segments are
    high-passed noise bursts (fricatives); short silences separate
    "words".  Seeded and byte-reproducible.  Companion to
    `synthesize_music` for the audio R-D experiment.
    """
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    # vowel formant tables (F1, F2, F3) in Hz
    vowels = np.array([
        [730, 1090, 2440],   # /a/
        [270, 2290, 3010],   # /i/
        [300, 870, 2240],    # /u/
        [530, 1840, 2480],   # /e/
        [570, 840, 2410],    # /o/
    ])
    out = np.zeros(n_samples, dtype=np.float64)
    t = 0
    while t < n_samples:
        kind = rng.random()
        if kind < 0.55:  # voiced vowel, 80-300 ms
            dur = int(rng.uniform(0.08, 0.3) * rate)
            n = min(dur, n_samples - t)
            f0_start = rng.uniform(95, 220)
            f0 = f0_start * np.linspace(1.0, rng.uniform(0.8, 0.95), n)
            # glottal pulse train with jitter
            phase = np.cumsum(f0 / rate)
            pulses = np.zeros(n)
            marks = np.nonzero(np.diff(np.floor(phase)) > 0)[0]
            for m in marks:
                j = m + int(rng.normal(0, 0.0005) * rate)
                if 0 <= j < n:
                    pulses[j] = rng.uniform(0.8, 1.2)
            # glottal shaping: simple 2-sample difference of an exponential
            glot = lfilter([1.0], [1.0, -0.96], pulses)
            sig = np.diff(glot, prepend=0.0)
            for f_c in vowels[rng.integers(len(vowels))]:
                bw = 60 + 0.05 * f_c
                r = np.exp(-np.pi * bw / rate)
                theta = 2 * np.pi * f_c / rate
                sig = lfilter([1.0], [1.0, -2 * r * np.cos(theta), r * r], sig)
            env = np.ones(n)
            # clamp to the segment length like the fricative branch does —
            # a tail-truncated vowel shorter than the 10 ms ramp would
            # otherwise raise a broadcast ValueError
            ramp = min(max(2, int(0.01 * rate)), n)
            env[:ramp] = np.linspace(0, 1, ramp)
            env[-ramp:] *= np.linspace(1, 0, ramp)
            out[t : t + n] += sig * env * rng.uniform(0.5, 1.0)
            t += n
        elif kind < 0.8:  # fricative burst, 40-150 ms
            dur = int(rng.uniform(0.04, 0.15) * rate)
            n = min(dur, n_samples - t)
            noise = rng.standard_normal(n)
            sig = lfilter([1.0, -0.97], [1.0], noise)  # high-pass
            env = np.hanning(max(n, 2))[:n]
            out[t : t + n] += 0.12 * sig * env
            t += n
        else:  # pause
            t += int(rng.uniform(0.03, 0.15) * rate)
    peak = np.max(np.abs(out))
    if peak > 0:
        out /= peak
    return out.astype(np.float32)


def load_wav_blocks(
    path: str, block_size: int, *, normalize_peak: bool = True
) -> np.ndarray:
    """Load a WAV file as float32 codec blocks ``[B, block_size]``.

    The reference's real corpora are audio (SURVEY.md provenance: Brodeur &
    Rouat's hierarchical sparse coding of audio).  Multichannel audio is
    averaged to mono; the tail is zero-padded to a whole block; peak
    normalization keeps quantizer scales comparable across files.
    """
    from scipy.io import wavfile

    rate, data = wavfile.read(path)
    x = np.asarray(data, dtype=np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    if np.issubdtype(np.asarray(data).dtype, np.integer):
        x = x / float(np.iinfo(np.asarray(data).dtype).max)
    if normalize_peak:
        peak = float(np.max(np.abs(x)))
        if peak > 0:
            x = x / peak
    nb = -(-x.shape[0] // block_size)
    out = np.zeros(nb * block_size, dtype=np.float32)
    out[: x.shape[0]] = x
    return out.reshape(nb, block_size)


def save_wav(path: str, signal: np.ndarray, rate: int = 16000) -> None:
    """Write a float32 signal (blocks are concatenated) as 16-bit WAV."""
    from scipy.io import wavfile

    x = np.asarray(signal, dtype=np.float32).reshape(-1)
    peak = float(np.max(np.abs(x)))
    if peak > 1.0:
        x = x / peak
    wavfile.write(path, rate, (x * 32767.0).astype(np.int16))
