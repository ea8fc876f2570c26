"""Codec configuration: a frozen copy of the port's `hsc_torch/config.py`.

The benchmark's plain reference keeps its own copy of the codec contract
(field widths, derived geometry, the JSON written into a container's
header), so that neither a later change to the program nor the program's
import can move what the reference judges against.  Copied verbatim; only
this docstring differs.
"""

from __future__ import annotations

import dataclasses
import json


def ceil_log2(n: int) -> int:
    """Number of bits needed to represent values in [0, n)."""
    if n <= 1:
        return 0
    return (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Full contract for one hierarchical sparse-coding codec instance.

    Attributes:
      counts: number of *learned* atoms per level, e.g. (64,) or (32, 16).
      scales: signal-space extent (samples) of atoms per level, strictly
        increasing, e.g. (32,) or (32, 96).  ``window_sizes`` (filter widths in
        the previous level's coefficient space) are derived:
        ``W[0] = scales[0]``; ``W[k] = scales[k] - scales[k-1] + 1``.
        (Reference: `hsc/dataset.py :: scalesToWindowSizes`.)
      block_size: samples per independently-coded signal block (the DP unit).
      num_coefs: per-level greedy coefficient budget (max iterations).
      tolerance_snr: optional per-level SNR (dB) early-stop target; None = run
        the full budget.  (Reference kwarg `toleranceSnr`.)
      singleton_weight: multiplicative selection weight (<= 1) applied to
        singleton (passthrough) atoms at levels >= 1.  (Reference kwarg
        `singletonWeight`.)
      amp_bits: amplitude quantizer width (signed); 16 => codes in
        [-32767, 32767] with a per-(block, level) float32 scale in the stream.
      num_select: selections per greedy sweep (reference kwarg `nbBlocks`):
        1 = plain greedy; >1 = one candidate per contiguous position segment,
        accepted left-to-right under a 2W-1 interference guard.
      entropy: position coding in the stream — 'fixed' (pos_bits per event) or
        'rice' (position-sorted events, Rice/Golomb-coded deltas; typically
        30-50%% smaller streams).  Decode order is stream order either way.
      decode_mode: reconstruction arithmetic (stream format v2) —
        'ordered': stream-order float32 overlap-add (the v1 surface; decode is
        inherently sequential per block);
        'integer': order-free exact integer reconstruction against
        rep_bits-quantized atom representations, reduced mod 2^32 — summation
        order is irrelevant, so decode runs as dense MXU matmuls
        (`ops.decode.mp_decode_integer_jax`).  Requires
        ``max(num_coefs) * amp_maxcode < 2^24`` so the dense coefficient map
        stays exactly representable (enforced below).
        The DEFAULT is 'auto', resolved at construction to 'integer' when
        the capacity bound holds, else 'ordered' — serialized streams always
        carry the resolved concrete mode.  Integer mode is the recommended
        (and default) surface: it decodes 20-28x faster on TPU (1.78
        µs/block fused kernel vs 49.7 µs/block ordered) at a measured
        fidelity cost of 0.000 dB at rep_bits=12 on every corpus studied
        (flagship synthetic, music, speech — integer and ordered
        reconstructions agree at ~73 dB SNR; BASELINE.md "decode-mode
        fidelity").  Choose 'ordered' explicitly when bit-exact v1 float
        reconstruction is required or the budget exceeds the bound.
      rep_bits: representation quantizer width for decode_mode='integer'
        (unsigned magnitude; codes in [-(2^rep_bits - 1), 2^rep_bits - 1]).
        Max 12 so the plane-split matmuls stay exact (docs/FORMAT.md v2).
      hier_init: init-correlation arithmetic for levels >= 1 (encode-side
        only; decode never recomputes scores) —
        'f32': f32-HIGHEST conv of the f32 feature map (the level-0
        arithmetic; multi-pass bf16 emulation on the MXU);
        'int8': exact int8 digit-plane correlation of the integer feature
        map against the int16-quantized bank
        (`oracle.mp.int8_init_scores`) — bitwise identical across backends
        (the f32 init is the one fp-order-dependent stage; the int8 one
        has none) and faster on TPU, where the f32 level-1 init was 63%%
        of the whole flagship 2-level encode (BASELINE.md "hierarchical
        speed-of-light").  Requires ``num_coefs[k]*amp_maxcode <=
        2139062143`` for every non-top level (four balanced int8 digits
        must cover any feature-map cell — practically always true) and
        ``window*channels <= 65535`` at every level >= 1 (int32 plane
        accumulators).
        The DEFAULT is 'auto', resolved at construction to 'int8' whenever
        those bounds hold, else 'f32'; serialized headers always carry the
        resolved concrete value.  Streams from containers written before
        this field existed parse as 'f32' (their encoder's arithmetic).
    """

    counts: tuple[int, ...] = (64,)
    scales: tuple[int, ...] = (32,)
    block_size: int = 16384
    num_coefs: tuple[int, ...] = (512,)
    tolerance_snr: float | None = None
    singleton_weight: float = 0.9
    amp_bits: int = 16
    num_select: int = 1
    entropy: str = "fixed"
    decode_mode: str = "auto"
    rep_bits: int = 12
    hier_init: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "counts", tuple(int(c) for c in self.counts))
        object.__setattr__(self, "scales", tuple(int(s) for s in self.scales))
        object.__setattr__(self, "num_coefs", tuple(int(n) for n in self.num_coefs))
        if len(self.counts) != len(self.scales):
            raise ValueError("counts and scales must have the same length")
        if len(self.num_coefs) != len(self.counts):
            raise ValueError("num_coefs must have one entry per level")
        # hostile-header hardening (container configs are untrusted input —
        # the mutation fuzz drives these): every level needs at least one
        # atom and a non-negative budget, and the layer widths must be
        # positive before any derived-geometry arithmetic runs on them
        if any(c < 1 for c in self.counts):
            raise ValueError("counts must all be >= 1")
        if any(n < 0 for n in self.num_coefs):
            raise ValueError("num_coefs must all be >= 0")
        if any(s < 1 for s in self.scales):
            raise ValueError("scales must all be >= 1")
        if any(b <= a for a, b in zip(self.scales, self.scales[1:])):
            raise ValueError("scales must be strictly increasing")
        if not (2 <= self.amp_bits <= 16):
            raise ValueError("amp_bits must be in [2, 16]")
        for level in range(len(self.counts)):
            # every level needs at least one valid filter placement; without
            # this the failure surfaces as an obscure mid-encode shape error
            if self.num_positions(level) < 1:
                raise ValueError(
                    f"block_size={self.block_size} leaves no valid filter "
                    f"placement at level {level} "
                    f"(window {self.window_sizes[level]} over "
                    f"{self.seq_len(level)} positions)"
                )
        if self.num_select < 1:
            raise ValueError("num_select must be >= 1")
        if self.entropy not in ("fixed", "rice"):
            raise ValueError("entropy must be 'fixed' or 'rice'")
        if self.decode_mode == "auto":
            # resolve to the fast integer decoder whenever its exactness
            # bound holds (measured fidelity cost: 0.000 dB at rep_bits=12 —
            # BASELINE.md); streams always carry the resolved concrete mode
            object.__setattr__(
                self,
                "decode_mode",
                "integer"
                if max(self.num_coefs) * self.amp_maxcode < (1 << 24)
                else "ordered",
            )
        if self.decode_mode not in ("ordered", "integer"):
            raise ValueError("decode_mode must be 'auto', 'ordered' or 'integer'")
        if not (2 <= self.rep_bits <= 12):
            raise ValueError("rep_bits must be in [2, 12]")
        if self.decode_mode == "integer":
            # the dense per-(position, atom) code sums must stay exactly
            # f32-representable for the plane-split MXU matmuls
            if max(self.num_coefs) * self.amp_maxcode >= (1 << 24):
                raise ValueError(
                    "decode_mode='integer' requires max(num_coefs) * "
                    f"amp_maxcode < 2^24 (got {max(self.num_coefs)} * "
                    f"{self.amp_maxcode})"
                )
            # (the round-2 bf16-plane decoder also required
            # max(num_coefs) * 255 < 2^24 for its f32 one-hot dots; the
            # int8 balanced-digit decoder needs only m < 2^24, implied by
            # the amp_maxcode bound above, so that check is gone)
        if self.hier_init == "auto":
            # resolve to the exact int8 digit-plane init whenever its
            # exactness bounds hold (see the class docstring); single-level
            # configs have no level >= 1 init, so the value is inert there —
            # resolve it anyway so serialized headers are always concrete
            ok = self._int8_hier_init_ok()
            object.__setattr__(self, "hier_init", "int8" if ok else "f32")
        if self.hier_init not in ("int8", "f32"):
            raise ValueError("hier_init must be 'auto', 'int8' or 'f32'")
        if self.hier_init == "int8" and not self._int8_hier_init_ok():
            raise ValueError(
                "hier_init='int8' requires num_coefs*amp_maxcode <= 8355711 "
                "at every non-top level and window*channels <= 65535 at "
                "every level >= 1 (exact int8 digit-plane bounds)"
            )
        if len(self.counts) > 1:
            # the level hand-off (ops.encode.feature_map_jax / oracle
            # feature_map_from_events) builds dense exact-integer code maps
            # with int8-digit one-hot matmuls regardless of decode_mode;
            # validate its capacity bound here so multi-level configs fail
            # at construction, not mid-encode at trace time
            if max(self.num_coefs[:-1]) >= (1 << 24):
                raise ValueError(
                    "multi-level configs require num_coefs[level] < 2^24 "
                    "for every non-top level (the feature-map hand-off "
                    f"capacity bound; got {max(self.num_coefs[:-1])})"
                )

    def _int8_hier_init_ok(self) -> bool:
        """Exactness bounds for hier_init='int8' (oracle.mp.int8_init_scores):
        every non-top level's feature-map cells must fit FOUR balanced int8
        digits (cell sums <= num_coefs * amp_maxcode; the bound is 128x the
        flagship's, so practically every config qualifies), and every
        level >= 1 plane correlation must fit int32."""
        if self.num_levels == 1:
            return True
        if max(self.num_coefs[:-1]) * self.amp_maxcode > 2139062143:
            return False  # oracle.mp.FMAP4_DIGIT_BOUND
        return all(
            self.window_sizes[k] * self.channels[k] <= 65535
            for k in range(1, self.num_levels)
        )

    # ---- derived geometry -------------------------------------------------

    @property
    def num_levels(self) -> int:
        return len(self.counts)

    @property
    def window_sizes(self) -> tuple[int, ...]:
        """Filter width per level, in the coordinate space that level encodes."""
        w = [self.scales[0]]
        for k in range(1, self.num_levels):
            w.append(self.scales[k] - self.scales[k - 1] + 1)
        return tuple(w)

    @property
    def counts_with_singletons(self) -> tuple[int, ...]:
        """Atoms per level after singleton augmentation.

        Level 0 has no singletons.  Level k >= 1 gains one passthrough atom per
        *augmented* level-(k-1) atom (reference:
        `hsc/dataset.py :: addSingletonBases`).
        """
        cws = [self.counts[0]]
        for k in range(1, self.num_levels):
            cws.append(self.counts[k] + cws[k - 1])
        return tuple(cws)

    @property
    def channels(self) -> tuple[int, ...]:
        """Input channel count per level (1 for the raw signal at level 0)."""
        cws = self.counts_with_singletons
        return (1,) + cws[:-1]

    def seq_len(self, level: int) -> int:
        """Length of the sequence encoded at `level` (coefficient-map length)."""
        n = self.block_size
        w = self.window_sizes
        for k in range(level):
            n = n - w[k] + 1
        return n

    def num_positions(self, level: int) -> int:
        """Valid filter placements at `level` (no edge padding — spec choice)."""
        return self.seq_len(level) - self.window_sizes[level] + 1

    def pos_bits(self, level: int) -> int:
        return ceil_log2(self.num_positions(level))

    def atom_bits(self, level: int) -> int:
        return ceil_log2(self.counts_with_singletons[level])

    @property
    def amp_maxcode(self) -> int:
        return (1 << (self.amp_bits - 1)) - 1

    def event_bits(self, level: int) -> int:
        return self.pos_bits(level) + self.atom_bits(level) + self.amp_bits

    # ---- serialization ----------------------------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str | bytes) -> "CodecConfig":
        d = json.loads(s)
        for key in ("counts", "scales", "num_coefs"):
            d[key] = tuple(d[key])
        # headers/journals written before hier_init existed were encoded
        # with the f32 init — never let the 'auto' default reinterpret the
        # arithmetic an old stream was actually produced with
        d.setdefault("hier_init", "f32")
        return cls(**d)


def make_test_config(**overrides) -> CodecConfig:
    """Small config used across the test suite (fast on CPU)."""
    base = dict(
        counts=(16,),
        scales=(16,),
        block_size=1024,
        num_coefs=(64,),
        tolerance_snr=None,
    )
    base.update(overrides)
    return CodecConfig(**base)
