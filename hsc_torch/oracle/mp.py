"""NumPy oracle for convolutional matching pursuit (single-level and
hierarchical) — the executable codec specification.

Reference parity (SURVEY.md §2 C4–C7, §3.3–3.4):
  * `hsc/modeling.py :: ConvolutionalMatchingPursuit.computeCoefficients` —
    greedy shift-invariant MP with singleton weighting and SNR / budget stops.
  * `hsc/modeling.py :: ConvolutionalSparseCoder.encode / reconstruct`.
  * `hsc/modeling.py :: HierarchicalConvolutionalMatchingPursuit` /
    `HierarchicalConvolutionalSparseCoder` — level-by-level coding where the
    level-(k-1) coefficient map is the level-k input sequence.

Deliberate spec departures from the reference (TPU-first, SURVEY.md §7 H2):
  * The greedy score update runs in the *Gram domain*: after selecting
    (t, f, c), scores in the ±(W-1) window are updated by subtracting
    ``c_hat * G[f]`` — elementwise float32, bitwise reproducible on any IEEE
    backend — instead of re-correlating an explicit residual (the reference's
    local-update strategy, whose summation order is backend-dependent).
    Mathematically identical; G is precomputed once on the host
    (`MultilevelDictionary.gram`) and shared verbatim with the TPU encoder.
  * Amplitudes are quantized *inside the loop* (closed-loop quantization):
    the quantized value c_hat is what gets subtracted, so encoder and decoder
    see identical state and residual error does not drift.
  * Decode is defined as summation of ``c_hat * atom`` contributions in
    **stream order** — a fixed sequential order making float32 reconstruction
    bitwise identical between this oracle and the TPU decoder.

The port's own copy of `hsc_tpu/oracle/mp.py`: the container bytes and the
NumPy spec depend on this code, so it is copied verbatim, quirks included,
and tests/test_torch_copies.py holds it equal to the original.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..dictionary import MultilevelDictionary


@dataclasses.dataclass
class LevelStream:
    """Encoded events of one level for one block.

    ``positions``/``atoms``/``codes`` are parallel arrays in greedy selection
    order; ``scale`` is the float32 amplitude dequantization step; ``energy0``
    and ``energy_res`` are the level input / residual energies (for analysis).
    """

    positions: np.ndarray  # int32 [n]
    atoms: np.ndarray  # int32 [n]
    codes: np.ndarray  # int32 [n], in [-amp_maxcode, amp_maxcode]
    scale: np.float32
    energy0: float
    energy_res: float

    @property
    def amplitudes(self) -> np.ndarray:
        """Dequantized float32 amplitudes (the decoder-visible values)."""
        return (self.codes.astype(np.float32) * np.float32(self.scale)).astype(np.float32)

    def snr_db(self) -> float:
        if self.energy_res <= 0:
            return float("inf")
        if self.energy0 <= 0:
            return float("-inf")
        return 10.0 * math.log10(self.energy0 / self.energy_res)


def correlate_bank(x: np.ndarray, bank: np.ndarray) -> np.ndarray:
    """Valid-mode correlation scores ``[K, Npos]`` of multichannel input
    ``x [N, C]`` against filter bank ``[K, W, C]``.

    This is the MP init step (`hsc/modeling.py` innerProducts init,
    SURVEY.md §3.3) — on TPU it is an im2col matmul on the MXU; here it is the
    equivalent float32 einsum.  The ``[K, Npos]`` layout is the spec layout:
    atoms on the sublane axis, positions on the 128-wide lane axis (long,
    tileable), and the flat row-major argmax tie-break is therefore
    (lowest atom, then lowest position) on both backends.
    """
    x = np.ascontiguousarray(x, dtype=np.float32)
    k, w, c = bank.shape
    windows = np.lib.stride_tricks.sliding_window_view(x, w, axis=0)  # [Npos, C, W]
    return np.einsum("tcw,kwc->kt", windows, bank, optimize=True).astype(np.float32)


def mp_encode(
    x: np.ndarray,
    bank: np.ndarray,
    gram: np.ndarray,
    num_coefs: int,
    amp_bits: int = 16,
    tolerance_snr: float | None = None,
    singleton_weight: float = 1.0,
    n_raw: int | None = None,
    scores0: np.ndarray | None = None,
    energy0: float | None = None,
    num_select: int = 1,
) -> LevelStream:
    """Greedy convolutional MP of one block against one (augmented) bank.

    Reference: `hsc/modeling.py :: ConvolutionalMatchingPursuit
    .computeCoefficients` (kwargs `nbNonzeroCoefs`, `toleranceSnr`,
    `singletonWeight`).  Selection: argmax over |scores| x weight, two-stage
    by spec — first the best *position* (max over atoms per position, ties to
    the lowest position), then the best *atom* at that position (ties to the
    lowest atom).  The two-stage rule is what lets the device encoder keep an
    incrementally-maintained per-position max (exact — max has no rounding)
    instead of scanning the full [K, Npos] matrix every iteration.

    Determinism contract (SURVEY.md §7 H2): given the same float32 initial
    scores, the greedy loop — selection, quantization, Gram update, energy
    recursion, stopping — is bitwise identical on every IEEE backend.  The
    *initial correlation* is the one fp-order-dependent stage (a backend's
    conv may reduce in any order), so `scores0`/`energy0` may be injected to
    pin the loop to another backend's init (that is how the golden-loop tests
    compare the TPU encoder against this oracle); left as None, they are
    computed here in NumPy and the oracle is a self-contained encoder of the
    same spec family.

    `num_select` (reference kwarg `nbBlocks` — SURVEY.md §2 C4 "multi-block
    selection of several far-apart maxima per sweep with an interference
    guard"): positions are split into `num_select` contiguous segments; each
    sweep selects one candidate per segment (two-stage rule within the
    segment), then accepts them left-to-right, skipping any candidate closer
    than 2W-1 to the previously accepted one (so the per-sweep updates touch
    disjoint windows and every accepted score is exact).  Segments are
    ``128*ceil(npos/(128*S))`` positions long (lane-aligned, so the device's
    folded selection-cache rows are exactly the segments when S equals the
    fold factor).  Amortizes selection cost across several retained
    coefficients at a small greediness cost; `num_select=1` is the plain
    greedy spec.
    """
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[:, None]
    k, w, _ = bank.shape
    if n_raw is None:
        n_raw = k
    if scores0 is None:
        scores = correlate_bank(x, bank)  # [K, Npos] float32
    else:
        scores = np.array(scores0, dtype=np.float32, copy=True)
    npos = scores.shape[1]

    weights = np.ones((k,), dtype=np.float32)
    weights[n_raw:] = np.float32(singleton_weight)

    maxcode = (1 << (amp_bits - 1)) - 1
    # Quantizer step: covers the largest initial correlation.  Stored in the
    # stream, so decode needs no other context.  float32 throughout.  The
    # in-loop quantizer MULTIPLIES by inv_scale (one up-front exact IEEE
    # division) — in-loop division is banned by spec because some backends
    # lower it to an approximate reciprocal (SURVEY.md H2).
    peak = np.float32(np.max(np.abs(scores))) if scores.size else np.float32(0)
    scale = np.float32(peak / np.float32(maxcode)) if peak > 0 else np.float32(0)
    inv_scale = np.float32(np.float32(maxcode) / peak) if peak > 0 else np.float32(0)

    if energy0 is None:
        e0 = float(np.float32(np.sum(np.square(x, dtype=np.float32), dtype=np.float32)))
    else:
        e0 = float(np.float32(energy0))
    e_res = np.float32(e0)
    # SNR stop as a float32 threshold compare (no logs in the loop) so the
    # device encoder can reproduce the stopping decision bit-for-bit:
    # stop when e_res <= e0 * 10^(-tol/10).
    snr_thr = (
        np.float32(np.float32(e0) * np.float32(10.0 ** (-tolerance_snr / 10.0)))
        if tolerance_snr is not None
        else None
    )

    positions, atoms, codes = [], [], []
    if scale > 0 and num_select > 1:
        s_count = int(num_select)
        # spec segment length: 128-lane aligned so the device's folded
        # selection cache rows ARE the segments when S == fold
        seg_len = 128 * (-(-npos // (128 * s_count)))
        done = False
        while not done and len(positions) < int(num_coefs):
            weighted = np.abs(scores) * weights[:, None]
            colmax = weighted.max(axis=0)
            accepted_last = None
            accepted_any = False
            for j in range(s_count):
                if len(positions) >= int(num_coefs):
                    break
                lo = j * seg_len
                hi = min((j + 1) * seg_len, npos)
                if lo >= hi:
                    continue
                t = lo + int(np.argmax(colmax[lo:hi]))  # ties: lowest position
                f = int(np.argmax(weighted[:, t]))  # ties: lowest atom
                s = np.float32(scores[f, t])
                y = np.float32(s * inv_scale)
                r = np.float32(np.floor(np.abs(y) + np.float32(0.5))) * np.sign(y)
                code = int(np.clip(r, -maxcode, maxcode))
                if code == 0:
                    continue
                if accepted_last is not None and t - accepted_last < 2 * w - 1:
                    continue  # interference guard: windows must stay disjoint
                c_hat = np.float32(np.float32(code) * scale)
                positions.append(t)
                atoms.append(f)
                codes.append(code)
                accepted_last = t
                accepted_any = True
                e_res = np.float32(e_res - np.float32(2.0) * c_hat * s + c_hat * c_hat)
                lo_u = max(0, t - w + 1)
                hi_u = min(npos, t + w)
                dlo = lo_u - (t - w + 1)
                scores[:, lo_u:hi_u] -= c_hat * gram[:, f, dlo : dlo + (hi_u - lo_u)]
                if snr_thr is not None and e_res <= snr_thr:
                    done = True
                    break
            if not accepted_any:
                done = True
    elif scale > 0:
        for _ in range(int(num_coefs)):
            weighted = np.abs(scores) * weights[:, None]
            colmax = weighted.max(axis=0)  # [Npos]
            t = int(np.argmax(colmax))  # first max wins: lowest position
            f = int(np.argmax(weighted[:, t]))  # then lowest atom
            s = np.float32(scores[f, t])
            # Quantizer spec: round half away from zero, computed explicitly
            # as sign * floor(|x| + 0.5) — exact in float32 for |x| < 2^23 on
            # every backend (backend rint modes differ: NumPy/XLA round half
            # to even, Mosaic rounds half away).
            y = np.float32(s * inv_scale)
            r = np.float32(np.floor(np.abs(y) + np.float32(0.5))) * np.sign(y)
            code = int(np.clip(r, -maxcode, maxcode))
            if code == 0:
                break  # below quantizer resolution — no progress possible
            c_hat = np.float32(np.float32(code) * scale)
            positions.append(t)
            atoms.append(f)
            codes.append(code)
            # Residual energy in the Gram domain (unit-norm atoms):
            # ||r - c_hat d||^2 = ||r||^2 - 2 c_hat <r,d> + c_hat^2
            e_res = np.float32(e_res - np.float32(2.0) * c_hat * s + c_hat * c_hat)
            # Gram-domain local score update (SURVEY.md §3.3 "local update"):
            # score[g, tau] -= c_hat * sum_u A[g,u] A[f, u+(tau-t)]
            #               =  c_hat * G[g, f, (tau-t)+(W-1)]
            lo = max(0, t - w + 1)
            hi = min(npos, t + w)
            dlo = lo - (t - w + 1)
            scores[:, lo:hi] -= c_hat * gram[:, f, dlo : dlo + (hi - lo)]
            if snr_thr is not None and e_res <= snr_thr:
                break

    return LevelStream(
        positions=np.asarray(positions, dtype=np.int32),
        atoms=np.asarray(atoms, dtype=np.int32),
        codes=np.asarray(codes, dtype=np.int32),
        scale=scale,
        energy0=e0,
        energy_res=float(max(e_res, np.float32(0))),
    )


def mp_decode(stream: LevelStream, bank: np.ndarray, n: int) -> np.ndarray:
    """Reconstruct ``[N, C]`` by overlap-adding ``c_hat * bank[f]`` at each
    event position **in stream order** (the bit-exactness surface:
    `hsc/modeling.py :: ConvolutionalSparseCoder.reconstruct`, SURVEY.md §3.4).
    """
    k, w, c = bank.shape
    out = np.zeros((n, c), dtype=np.float32)
    amps = stream.amplitudes
    for i in range(stream.positions.shape[0]):
        t = int(stream.positions[i])
        f = int(stream.atoms[i])
        out[t : t + w, :] += amps[i] * bank[f]
    return out


def rep_quantize(bank: np.ndarray, rep_bits: int) -> tuple[np.ndarray, np.float32]:
    """Quantize a representation bank for decode_mode='integer' (format v2).

    Host-side IEEE float32, same round-half-away-from-zero convention as the
    amplitude quantizer (`mp_encode`): with ``maxcode = 2^rep_bits - 1`` and
    ``peak = max|bank|``, ``step = f32(peak / maxcode)``,
    ``inv = f32(maxcode / peak)``, each value maps to
    ``sign(v) * floor(|f32(v * inv)| + 0.5)`` clipped to ±maxcode.

    Returns (rep_q int32 same shape, step float32).  Deterministic from the
    dictionary bytes alone — encoder and decoder derive identical rep_q.
    """
    bank = np.asarray(bank, dtype=np.float32)
    maxcode = np.float32((1 << rep_bits) - 1)
    peak = np.float32(np.max(np.abs(bank))) if bank.size else np.float32(0)
    if not peak > 0:
        return np.zeros(bank.shape, np.int32), np.float32(0)
    step = np.float32(peak / maxcode)
    inv = np.float32(maxcode / peak)
    y = (bank * inv).astype(np.float32)
    r = np.floor(np.abs(y) + np.float32(0.5)).astype(np.float32) * np.sign(y)
    q = np.clip(r, -maxcode, maxcode).astype(np.int32)
    return q, step


# ---- int8 level->=1 init scoring (hier_init='int8') -------------------------
#
# A level k >= 1 input is an EXACT integer map times one f32 scale (the
# quantized feature-map hand-off), so the init correlation can be respecified
# as exact int8 digit-plane products accumulated in int32 — bitwise
# deterministic for ANY reduction order, which removes the one
# fp-order-dependent stage (SURVEY.md §7 H2) from every level above 0, and
# runs on the MXU at 2x the bf16 MAC rate instead of f32-HIGHEST's multi-pass
# emulation (measured 63%% of the whole flagship 2-level encode —
# BASELINE.md "hierarchical speed-of-light").

# 127*256 + 127: the largest magnitude whose TWO balanced base-256 digits both
# stay in [-128, 127] (int8).
BANK_MAXCODE_INT16 = 32639
# 127*(1 + 256 + 65536): the largest magnitude whose THREE balanced digits all
# stay in [-128, 127].
FMAP_DIGIT_BOUND = 8355711
# The init spec uses FOUR map digits: canonical (greedy) balanced digits of
# v stay int8 for v in [-(8421504 + 128*2^24), 8355711 + 127*2^24] — the
# symmetric safe bound below covers any realistic feature-map cell (code
# sums up to num_coefs * amp_maxcode; the flagship's 512 * 32767 is 128x
# inside it), so hier_init='int8' carries NO practical budget bound.
FMAP4_DIGIT_BOUND = 8355711 + 127 * (1 << 24)  # 2_139_062_143


def balanced_digits(v: np.ndarray, ndigits: int) -> np.ndarray:
    """Split integers into `ndigits` balanced signed base-256 digits
    (``v = sum_j d_j * 256**j``, every ``d_j`` in [-128, 127]) — the same
    decomposition the feature-map hand-off and the integer decoder use.
    Exact; raises if the final digit overflows int8 (caller must respect
    the range bound, e.g. FMAP_DIGIT_BOUND for ndigits=3)."""
    r = np.asarray(v).astype(np.int64)
    digs = []
    for _ in range(ndigits - 1):
        d = ((r + 128) & 255) - 128
        digs.append(d)
        r = (r - d) >> 8
    if r.size and (r.max(initial=0) > 127 or r.min(initial=0) < -128):
        raise ValueError(
            f"value out of range for {ndigits} balanced base-256 digits"
        )
    digs.append(r)
    return np.stack(digs, axis=-1)


def bank_quantize_int16(bank: np.ndarray) -> tuple[np.ndarray, np.float32]:
    """Quantize a filter bank to int16-range codes for the int8 digit-plane
    init conv (hier_init='int8').

    Same host-side IEEE-f32 convention as `rep_quantize`, with
    ``maxcode = BANK_MAXCODE_INT16`` (32639, not 32767, so both balanced
    base-256 digits of every code are native int8).  Returns
    (bank_q int32 [K, W, C], step f32) with ``bank ~= bank_q * step``.
    Deterministic from the bank bytes alone — every backend derives
    identical planes."""
    bank = np.asarray(bank, dtype=np.float32)
    maxcode = np.float32(BANK_MAXCODE_INT16)
    peak = np.float32(np.max(np.abs(bank))) if bank.size else np.float32(0)
    if not peak > 0:
        return np.zeros(bank.shape, np.int32), np.float32(0)
    step = np.float32(peak / maxcode)
    inv = np.float32(maxcode / peak)
    y = (bank * inv).astype(np.float32)
    r = np.floor(np.abs(y) + np.float32(0.5)).astype(np.float32) * np.sign(y)
    q = np.clip(r, -maxcode, maxcode).astype(np.int32)
    return q, step


def int8_init_scores(
    m_int: np.ndarray,
    bank_q: np.ndarray,
    step: np.float32,
    prev_scale: np.float32,
) -> np.ndarray:
    """Init correlation scores ``[n_raw + C, Npos]`` of an exact integer map
    ``m_int [N, C]`` (the level input, before its f32 scale) against an
    int16-quantized RAW sub-bank ``bank_q [n_raw, W, C]``
    (`bank_quantize_int16` of ``augmented[:n_raw]`` — the learned atoms
    only).

    SINGLETON rows are NOT scored through the quantized bank: a singleton
    is a unit delta at offset 0 on channel s (`dictionary.augmented`), so
    its correlation is exactly the scaled map value —
    ``scores[n_raw + s, t] = f32(f32(m_int[t, s]) * prev_scale)`` — the
    bit-identical value the f32 conv produced (a unit atom contributes one
    exact product).  This keeps the structural identity ``scale_k ==
    scale_{k-1}`` (the level peak is the largest map cell via its
    singleton, so each level's quantizer step reproduces the previous
    one's), which `to_top_level`'s one-scale-per-stream merge relies on,
    and gives the raw atoms a finer quantizer (their own absmax, not the
    singletons' 1.0).

    Raw-row spec arithmetic, shared bit-for-bit by the device executable
    (`ops.encode.encode_init_int_batched`):

      * m splits into FOUR balanced int8 digit planes d_j (four, not three,
        so feature-map cells carry no practical budget bound —
        FMAP4_DIGIT_BOUND), bank_q into TWO (b_p); the eight plane
        correlations ``P_jp`` are exact integer sums (int32 on device —
        guarded by W*C <= 65535 in CodecConfig);
      * the anti-diagonal sums ``T_s = sum_{j+p=s} P_jp`` (s = 0..4) are
        exact int32;
      * f32 recombination in a FIXED grouping with power-of-two weights —
        ``R = ((f32(T0) + 256*f32(T1)) + (65536*f32(T2) + 2^24*f32(T3)))
        + 2^32*f32(T4)`` — is backend-invariant: int32->f32 conversion is
        correctly rounded everywhere, the products are exact (powers of
        two), so even an FMA contraction cannot change a bit;
      * ``scores = R * g`` with ``g = f32(prev_scale * step)``.

    Unlike the f32 level-0 init, this stage needs NO score injection to pin
    cross-backend parity — the integers make it bitwise by construction.
    """
    d = balanced_digits(m_int, 4)  # [N, C, 4]
    b = balanced_digits(bank_q, 2)  # [K, W, C, 2]
    w = bank_q.shape[1]
    windows = np.lib.stride_tricks.sliding_window_view(
        d, w, axis=0
    )  # [Npos, C, 4, W]
    # exact integer plane correlations, all (j, p) at once
    p_jp = np.einsum("tcjw,kwcp->jpkt", windows, b, optimize=True)  # int64
    t0 = p_jp[0, 0]
    t1 = p_jp[0, 1] + p_jp[1, 0]
    t2 = p_jp[1, 1] + p_jp[2, 0]
    t3 = p_jp[2, 1] + p_jp[3, 0]
    t4 = p_jp[3, 1]
    lo = t0.astype(np.float32) + np.float32(256.0) * t1.astype(np.float32)
    hi = np.float32(65536.0) * t2.astype(np.float32) + np.float32(
        16777216.0
    ) * t3.astype(np.float32)
    r = (lo + hi) + np.float32(4294967296.0) * t4.astype(np.float32)
    g = np.float32(np.float32(prev_scale) * np.float32(step))
    raw_scores = (r * g).astype(np.float32)
    npos = raw_scores.shape[1]
    sing = (
        m_int[:npos].astype(np.float32) * np.float32(prev_scale)
    ).astype(np.float32).T  # [C, Npos] — exact unit-delta passthrough
    return np.concatenate([raw_scores, sing], axis=0)


def _wrap_int32(acc: np.ndarray) -> np.ndarray:
    """Reduce exact integer sums mod 2^32 into signed int32 (the spec's
    wraparound semantics — a ring homomorphism, so any backend's sequence of
    int32 adds/multiplies produces the same values)."""
    return (
        ((acc.astype(np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)
    ).astype(np.int32)


def mp_decode_integer(
    stream: LevelStream, rep_q: np.ndarray, step: np.float32, n: int
) -> np.ndarray:
    """Order-free integer reconstruction (decode_mode='integer', format v2).

    Spec: ``out_int[t] = sum_i codes[i] * rep_q[atoms[i]][t - positions[i]]``
    accumulated as exact integers and reduced mod 2^32 (int32 wraparound);
    ``out = f32(out_int) * amp_step`` with ``amp_step = f32(f32(scale) * step)``.
    Modular integer addition is associative and commutative, so summation
    order is irrelevant — the TPU decoder runs this as dense plane-split MXU
    matmuls (`ops.decode.mp_decode_integer_jax`) and produces identical
    bytes.  With the config bound ``max(num_coefs) * amp_maxcode < 2^24`` and
    ``rep_bits <= 12`` no wraparound occurs on realistic streams; the mod is
    the deterministic overflow semantics, not an expected path.
    """
    k, w, c = rep_q.shape
    acc = np.zeros((n, c), dtype=np.int64)
    for i in range(stream.positions.shape[0]):
        t = int(stream.positions[i])
        f = int(stream.atoms[i])
        acc[t : t + w, :] += int(stream.codes[i]) * rep_q[f].astype(np.int64)
    amp_step = np.float32(np.float32(stream.scale) * np.float32(step))
    return (_wrap_int32(acc).astype(np.float32) * amp_step).astype(np.float32)


def feature_map_from_events(stream: LevelStream, npos: int, k: int) -> np.ndarray:
    """Dense coefficient map ``[Npos, K]`` from events.

    This is the level-(k) -> level-(k+1) hand-off: the map becomes the next
    level's input sequence (`hsc/modeling.py ::
    HierarchicalConvolutionalMatchingPursuit`, SURVEY.md §3.4).  Built from
    *quantized* amplitudes so every level codes decoder-visible state.

    Spec (round 2): each cell is the EXACT integer sum of its codes (mod
    2^32), times the stream's float32 scale —
    ``fmap[p, a] = f32(int32(sum codes)) * scale``.  Order-free: cells hit
    once equal the old stream-order float add bit-for-bit (``f32(code) *
    scale``); duplicate hits accumulate exactly instead of rounding per add.
    This is what lets the device hand-off run as MXU one-hot matmuls
    (`ops.encode.feature_map_jax`) instead of a serial per-event scan.
    """
    return (
        feature_map_int_from_events(stream, npos, k).astype(np.float32)
        * np.float32(stream.scale)
    ).astype(np.float32)


def feature_map_int_from_events(
    stream: LevelStream, npos: int, k: int
) -> np.ndarray:
    """The EXACT integer part of `feature_map_from_events` (code sums per
    cell, mod 2^32) — the int32 map the int8 init conv (hier_init='int8')
    consumes directly; the f32 hand-off is this times the stream scale."""
    acc = np.zeros((npos, k), dtype=np.int64)
    np.add.at(
        acc,
        (stream.positions.astype(np.int64), stream.atoms.astype(np.int64)),
        stream.codes.astype(np.int64),
    )
    return _wrap_int32(acc)


def hierarchical_encode(
    x: np.ndarray, mld: MultilevelDictionary
) -> list[LevelStream]:
    """Level-by-level greedy MP (SURVEY.md §3.4).

    Level 0 codes the raw signal; level k codes the quantized level-(k-1)
    coefficient map with the singleton-augmented bank.  Returns one
    LevelStream per level; the *top* stream alone is the compressed
    representation (singletons carry unexplained lower structure upward).
    """
    cfg = mld.config
    streams: list[LevelStream] = []
    seq = np.asarray(x, dtype=np.float32)
    if seq.ndim == 1:
        seq = seq[:, None]
    use_int8 = getattr(cfg, "hier_init", "f32") == "int8"
    seq_int = None  # exact integer map for the current level (levels >= 1)
    prev_scale = np.float32(0)
    for level in range(cfg.num_levels):
        bank = mld.augmented(level)
        scores0 = None
        if level >= 1 and use_int8:
            bank_q, step = bank_quantize_int16(bank[: cfg.counts[level]])
            scores0 = int8_init_scores(seq_int, bank_q, step, prev_scale)
        stream = mp_encode(
            seq,
            bank,
            mld.gram(level),
            scores0=scores0,
            num_coefs=cfg.num_coefs[level],
            amp_bits=cfg.amp_bits,
            tolerance_snr=cfg.tolerance_snr,
            singleton_weight=cfg.singleton_weight if level > 0 else 1.0,
            n_raw=cfg.counts[level],
            num_select=cfg.num_select,
        )
        streams.append(stream)
        if level + 1 < cfg.num_levels:
            seq_int = feature_map_int_from_events(
                stream, cfg.num_positions(level), bank.shape[0]
            )
            seq = (
                seq_int.astype(np.float32) * np.float32(stream.scale)
            ).astype(np.float32)
            prev_scale = np.float32(stream.scale)
    return streams


def to_distributed(
    cfg, top_stream: LevelStream, level: int | None = None
) -> list[tuple[int, LevelStream]]:
    """Convert a top-level-only stream to the distributed representation
    (SURVEY.md §2 C6: `hsc/modeling.py :: HierarchicalConvolutionalMatchingPursuit`
    converts between distributed and top-level-only representations).

    A top-level event whose atom is a singleton *is* a lower-level event: the
    singleton filter at level k (unit delta at offset 0, channel s) placed at
    position p contributes exactly ``amplitude * representation_{k-1}[s]`` at
    sample p — so the event can be stored at level k-1 as (p, s, code) with
    identical decoded contribution.  Demotion repeats through singleton
    chains until the atom is raw at its level (level-0 atoms are all raw).

    Returns (level, stream) pairs for non-empty levels, ascending; every
    stream keeps the top stream's quantizer scale, and events preserve their
    original relative order (stable partition), so decode — per-level
    stream-order adds, levels in container order — is deterministic.
    Positions are unchanged and always representable (num_positions grows
    downward).  Rate effect: with entropy='fixed', demoted events pay the
    (smaller) lower-level atom_bits, so payload bits never grow; per-stream
    header overhead (9-10 bytes per extra level) and — with entropy='rice' —
    the restart of position-delta coding per stream can still make small
    sparse containers slightly LARGER overall.  The representation choice is
    about structure (events at their native level), not guaranteed rate.
    """
    if level is None:
        level = cfg.num_levels - 1
    n = int(top_stream.positions.shape[0])
    levels = np.full(n, level, np.int32)
    atoms = top_stream.atoms.astype(np.int32).copy()
    # Demotion through singleton chains, vectorized one level per pass: at
    # level lv every event whose atom index is past the raw atoms is a
    # singleton, i.e. the event (atom - counts[lv]) one level down.  A chain
    # can only descend, so `num_levels` passes settle every event — O(L·n)
    # NumPy instead of a per-event Python while loop (corpus-scale streams).
    for lv in range(level, 0, -1):
        demote = (levels == lv) & (atoms >= cfg.counts[lv])
        atoms[demote] -= cfg.counts[lv]
        levels[demote] -= 1
    out = []
    for lv in range(level + 1):
        sel = np.nonzero(levels == lv)[0]
        if sel.size == 0:
            continue
        out.append(
            (
                lv,
                LevelStream(
                    positions=top_stream.positions[sel].astype(np.int32),
                    atoms=atoms[sel],
                    codes=top_stream.codes[sel].astype(np.int32),
                    scale=np.float32(top_stream.scale),
                    energy0=float(top_stream.energy0) if lv == level else 0.0,
                    energy_res=float(top_stream.energy_res) if lv == level else 0.0,
                ),
            )
        )
    return out


def to_top_level(
    cfg, streams: list[tuple[int, LevelStream]], level: int | None = None
) -> LevelStream:
    """Inverse of `to_distributed`: promote every event to `level` through
    singleton chains (atom at level k -> singleton index counts[k+1] + atom at
    level k+1, position unchanged).

    Promotion requires the position to remain a valid placement at each
    higher level (num_positions shrinks upward); encoder-emitted streams
    always satisfy this (they originated at the top), but arbitrary lower
    events near the block tail may not — those raise ValueError.  All streams
    must share one quantizer scale (one scale field per packed stream).

    The merge order is (source level ascending, then source stream order) —
    the same event multiset as the original top stream after a demote
    round-trip, but not necessarily the same interleaving (demotion is a
    stable *partition*; the cross-level interleaving is not stored).
    """
    if level is None:
        level = cfg.num_levels - 1
    if not streams:
        return LevelStream(
            positions=np.zeros(0, np.int32), atoms=np.zeros(0, np.int32),
            codes=np.zeros(0, np.int32), scale=np.float32(0),
            energy0=0.0, energy_res=0.0,
        )
    scales = {float(s.scale) for _, s in streams if s.positions.shape[0]}
    if len(scales) > 1:
        raise ValueError(f"streams carry different quantizer scales: {scales}")
    # Vectorized promotion: the singleton offset from level lv to the target
    # is the constant sum(counts[lv+1 .. level]) added to every atom of the
    # stream; validity is a max-position check per intermediate level
    # (num_positions shrinks upward).  O(streams·L + n) NumPy instead of a
    # per-event Python loop (VERDICT r2 #8; corpus-scale re-promotion).
    lv_parts, i_parts, p_parts, a_parts, c_parts = [], [], [], [], []
    for lv, s in streams:
        if lv > level:
            raise ValueError(f"stream level {lv} above target {level}")
        p = s.positions.astype(np.int32)
        a = s.atoms.astype(np.int32)
        offset = 0
        for up in range(lv + 1, level + 1):
            bad = p >= cfg.num_positions(up)
            if bad.any():
                raise ValueError(
                    f"event at position {int(p[bad.argmax()])} (level {lv}) "
                    f"has no singleton placement at level {up}"
                )
            offset += cfg.counts[up]
        n_s = p.shape[0]
        lv_parts.append(np.full(n_s, lv, np.int32))
        i_parts.append(np.arange(n_s, dtype=np.int64))
        p_parts.append(p)
        a_parts.append(a + np.int32(offset))
        c_parts.append(s.codes.astype(np.int32))
    lv_all = np.concatenate(lv_parts)
    i_all = np.concatenate(i_parts)
    # deterministic merge: ascending source level, then index within stream
    # (lexsort is stable, so full ties keep input stream order — identical to
    # the spec loop's stable sort by (level, index))
    order = np.lexsort((i_all, lv_all))
    top = next((s for lv, s in streams if lv == level), streams[-1][1])
    return LevelStream(
        positions=np.concatenate(p_parts)[order],
        atoms=np.concatenate(a_parts)[order],
        codes=np.concatenate(c_parts)[order],
        scale=np.float32(streams[0][1].scale if not scales else list(scales)[0]),
        energy0=float(top.energy0),
        energy_res=float(top.energy_res),
    )


def hierarchical_decode(
    top_stream: LevelStream, mld: MultilevelDictionary, level: int | None = None
) -> np.ndarray:
    """Signal-space reconstruction of the top-level stream.

    Spec: each event (t, f, c_hat) adds ``c_hat * representations[level][f]``
    at sample t, in stream order.  The representations are the precomputed
    decomposition-chain expansions (`MultilevelDictionary.representations`),
    so this equals expanding atoms through their decompositions
    (`hsc/modeling.py :: HierarchicalConvolutionalSparseCoder.reconstruct`)
    but with a fixed float32 summation order — the bit-exactness surface.
    """
    cfg = mld.config
    if level is None:
        level = cfg.num_levels - 1
    reps = mld.representations(level)  # [Ka, scales[level]]
    bank = reps[:, :, None]  # [Ka, scale, 1]
    # Events at level k live at coefficient positions that map 1:1 to samples.
    return mp_decode(top_stream, bank, cfg.block_size)[:, 0]
