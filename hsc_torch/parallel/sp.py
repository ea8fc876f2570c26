"""Sequence-parallel exact greedy MP — counterpart of `hsc_tpu.parallel.sp`.

For one block too long for one device, the time axis is sharded over the
mesh's 'seq' axis, in two stages that tests can run apart:

  * `sp_init`: each shard takes ``W - 1`` samples of halo from its right
    neighbour (zeros past the last shard) and runs its own valid
    correlation over ``L + W - 1`` samples, so its ``[K, L]`` scores are
    boundary-exact; the peak is the max over shards of each shard's peak
    on positions before ``npos_total``.  e0 is ONE float32 reduction over
    the whole block, the single-device init's expression, never a sum of
    shard partials, so the SNR stop is the single-device stop bit for bit.
  * `sp_loop`: per coefficient, each shard's two-stage selection on its
    own incrementally maintained colmax cache, then the collectives: the
    global best value is the max of the shards' maxima, ties go to the
    lowest global position (a min over candidates, sentinel ``npos_total +
    1``), and the winner's (atom, code, score) is the packed sum.  No score
    moves between shards: every shard applies the lag-masked Gram-row
    subtraction to the part of the ``±(W-1)`` window it owns (start
    clamped, lags offset and masked), so a shard with no overlap does an
    exact no-op.  ``num_select > 1`` runs the spec's sweeps: candidates
    from the sweep-start snapshot, one per segment of ``128·ceil(npos_total
    / (128·num_select))`` positions (segments may span shards), accepted
    under the ``2W - 1`` guard.

The JAX package computes this mode in XLA, outside any Pallas kernel; here
the shard-local work is eager torch ops, the collectives are reductions
over the shard list (`parallel.mesh`), and nothing is read on the host per
coefficient (``num_select > 1`` reads the stop flag once per sweep, as
JAX's `while_loop` condition does).  Given the same init the streams are
the single-device loop's bit for bit.
"""

from __future__ import annotations

import torch

from ..ops.correlate import correlate_bank_torch
from ..ops.encode import EncodedBlock, block_energy, quantize, quantizer_steps
from ._stream import ReplicatedStream, gather_to, psum_winner, selection_weights
from .mesh import Mesh


def _as_block(x) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32)
    return x[:, None] if x.dim() == 1 else x


def _geometry(mesh: Mesh, n: int, w: int, axis: str) -> tuple[int, int]:
    """(shard count, shard length), with the JAX package's errors."""
    s = int(mesh.shape[axis])
    if n % s != 0:
        raise ValueError(f"N={n} must divide the {axis}-axis size {s}")
    l = n // s
    if l < 2 * w:
        raise ValueError(f"shard length {l} must be >= 2*W={2 * w}")
    return s, l


def sp_init(mesh: Mesh, x, bank: torch.Tensor, *, axis: str = "seq"):
    """The sharded init of ONE block ``x [N, C]`` (or ``[N]``) against
    ``bank [K, W, C]``: ``(scores0, e0, peak)`` — one ``[K, L]`` score
    tensor per shard on its device (global positions ``[i·L, i·L + L)``),
    the block energy and the peak (0-d tensors on the first shard's
    device)."""
    x = _as_block(x)
    n, c = x.shape
    w = int(bank.shape[1])
    devs = mesh.axis_devices(axis)
    s, l = _geometry(mesh, n, w, axis)
    npos_total = n - w + 1
    zeros = torch.zeros((w - 1, c), dtype=torch.float32, device=x.device)
    scores0, peaks = [], []
    for i, dev in enumerate(devs):
        halo = x[(i + 1) * l : (i + 1) * l + w - 1] if i + 1 < s else zeros
        x_ext = torch.cat([x[i * l : (i + 1) * l], halo]).to(dev)  # [L + W - 1, C]
        sc = correlate_bank_torch(x_ext[None], bank.to(dev))[0]  # [K, L]
        valid = (i * l + torch.arange(l, device=dev)) < npos_total
        peaks.append(torch.where(valid[None, :], sc.abs(), 0.0).amax())
        scores0.append(sc)
    peak = gather_to(devs[0], peaks).amax()
    return scores0, block_energy(x.to(devs[0])[None])[0], peak


def sp_shard_scores(mesh: Mesh, scores0: torch.Tensor, n: int, *, axis: str = "seq") -> list[torch.Tensor]:
    """A single-device init ``[K, npos]`` (``npos = N - W + 1``) as
    `sp_loop`'s per-shard scores: zero-padded to ``[K, N]`` and split into
    ``[K, L]`` slices on the shards' devices.  The padded columns lie past
    ``npos_total``, where the loop never selects and masks every refresh."""
    devs = mesh.axis_devices(axis)
    k, npos = scores0.shape
    full = torch.zeros((k, n), dtype=torch.float32, device=scores0.device)
    full[:, :npos] = scores0
    l = n // len(devs)
    return [full[:, i * l : (i + 1) * l].to(dev) for i, dev in enumerate(devs)]


class _Shard:
    """One shard's lag-padded scores and colmax cache (local position p at
    column ``p + W - 1``, as in the single-device loop)."""

    def __init__(self, i, dev, scores0, gram_t, weights, *, l, w, npos_total):
        f32 = torch.float32
        self.dev, self.gpos0, self.l, self.w, self.npos_total = dev, i * l, l, w, npos_total
        self.gram_t = gram_t.to(dev, f32)
        self.weights = weights.to(dev)
        k = scores0.shape[0]
        self.lag = 2 * w - 1
        self.scores = torch.zeros((k, l + 2 * w - 2), dtype=f32, device=dev)
        self.scores[:, w - 1 : w - 1 + l] = scores0.to(dev)
        self.gpos = self.gpos0 + torch.arange(l, device=dev)
        self.lags = torch.arange(self.lag, device=dev)
        valid = self.gpos < npos_total
        self.colmax = torch.full((l + 2 * w - 2,), -1.0, dtype=f32, device=dev)
        self.colmax[w - 1 : w - 1 + l] = torch.where(
            valid, (scores0.to(dev).abs() * self.weights[:, None]).amax(dim=0), -1.0
        )

    def cache(self) -> torch.Tensor:
        return self.colmax[self.w - 1 : self.w - 1 + self.l]

    def candidate(self, cached: torch.Tensor):
        """Local (position, value) of the first maximum of `cached` ``[L]``."""
        t = cached.argmax().view(1)
        return t, cached.index_select(0, t)

    def atom(self, t_loc: torch.Tensor, inv_scale, maxcode: float):
        """Winner extraction at local position `t_loc` ``[1]``: packed
        ``(atom, code, score)`` as float32 ``[3]``."""
        col = self.scores.index_select(1, t_loc + (self.w - 1))[:, 0]
        f = (col.abs() * self.weights).argmax().view(1)
        s = col.index_select(0, f)
        code = quantize(s, inv_scale.to(self.dev), maxcode)
        return torch.cat([f.to(torch.float32), code.to(torch.float32), s])

    def update(self, t_glob, f, c_hat) -> None:
        """Boundary-exact window update for the global pick `t_glob`: clamp
        the window start, offset and mask the lags, subtract ``c_hat·row``
        (two ops), refresh the colmax of the touched columns, masked to
        positions before ``npos_total``."""
        w, l, lag = self.w, self.l, self.lag
        t_glob, f, c_hat = t_glob.to(self.dev), f.to(self.dev), c_hat.to(self.dev)
        ps = t_glob - self.gpos0
        ps_c = ps.clamp(0, l - 1)
        lags = self.lags + (ps_c - ps)
        lag_ok = (lags >= 0) & (lags < lag)
        gram_row = self.gram_t.index_select(0, f.view(1))[0]  # [K, lag]
        row = torch.where(lag_ok[None, :], gram_row.index_select(1, lags.clamp(0, lag - 1)), 0.0)
        idx = ps_c + self.lags
        prod = c_hat * row
        window = self.scores.index_select(1, idx) - prod
        self.scores.index_copy_(1, idx, window)
        touched = self.gpos0 + (idx - (w - 1))
        touched_valid = (touched >= 0) & (touched < self.npos_total)
        cm = torch.where(touched_valid, (window.abs() * self.weights[:, None]).amax(dim=0), -1.0)
        self.colmax.index_copy_(0, idx, cm)


def sp_loop(
    mesh: Mesh,
    scores0: list[torch.Tensor],
    e0,
    scale,
    inv_scale,
    gram_t: torch.Tensor,
    *,
    num_coefs: int,
    amp_bits: int = 16,
    tolerance_snr: float | None = None,
    singleton_weight: float = 1.0,
    n_raw: int | None = None,
    num_select: int = 1,
    axis: str = "seq",
) -> EncodedBlock:
    """The sharded greedy loop of ONE block from its init: `scores0` one
    ``[K, L]`` tensor per shard (`sp_init`, or `sp_shard_scores` of a
    single-device init), `e0` the block energy, `scale` / `inv_scale` the
    host quantizer steps, ``gram_t [K, K, 2W-1]``.  Returns an unbatched
    `EncodedBlock` (``[num_coefs]`` buffers and 0-d count, scale and
    energies) on the first shard's device.  The caller's scores are not
    modified."""
    devs = mesh.axis_devices(axis)
    k, lag = int(gram_t.shape[0]), int(gram_t.shape[2])
    w = (lag + 1) // 2
    if n_raw is None:
        n_raw = k
    if len(scores0) != len(devs):
        raise ValueError(f"{len(scores0)} score shards for {len(devs)} shards of {axis!r}")
    l = int(scores0[0].shape[1])
    n = l * len(devs)
    _geometry(mesh, n, w, axis)
    npos_total = n - w + 1
    maxcode = float((1 << (amp_bits - 1)) - 1)
    ctl = devs[0]
    weights = selection_weights(torch.arange(k), n_raw, singleton_weight)
    shards = [
        _Shard(i, dev, sc, gram_t, weights, l=l, w=w, npos_total=npos_total)
        for i, (dev, sc) in enumerate(zip(devs, scores0))
    ]
    st = ReplicatedStream(ctl, num_coefs, e0, scale, inv_scale, tolerance_snr)
    gpos0 = torch.tensor([sh.gpos0 for sh in shards], device=ctl)
    big = torch.tensor(npos_total + 1, device=ctl)

    def select(cached: list[torch.Tensor], gate):
        """The selection collectives over each shard's cached values ``[L]``:
        (global position, its value, the winner's packed atom/code/score).
        `gate(best)` masks the candidates (the sweep's ``best >= 0``)."""
        cands = [sh.candidate(c) for sh, c in zip(shards, cached)]
        t_loc = gather_to(ctl, [t for t, _ in cands])[:, 0]
        v_loc = gather_to(ctl, [v for _, v in cands])[:, 0]
        best = v_loc.amax()
        ok = v_loc == best if gate is None else (v_loc == best) & gate(best)
        cand = torch.where(ok, gpos0 + t_loc, big)
        t_glob = cand.amin()
        winner = cand == t_glob
        if gate is not None:
            winner = winner & gate(best)
        packed = gather_to(ctl, [
            sh.atom((t_glob.to(sh.dev) - sh.gpos0).clamp(0, l - 1).view(1), st.inv_scale, maxcode)
            for sh in shards
        ])
        return t_glob, best, psum_winner(winner[:, None], packed)

    if num_select <= 1:
        for _ in range(int(num_coefs)):
            t_glob, _, (f_g, code_g, s_g) = select([sh.cache() for sh in shards], None)
            f, code = f_g.to(torch.int32), code_g.to(torch.int32)
            emit = ~st.done & (code != 0)
            c_hat = st.record(emit, t_glob, f, code, s_g)
            for sh in shards:
                sh.update(t_glob, f, c_hat)
            st.done = st.done | (code == 0) | (emit & (st.e_res <= st.snr_thr))
        return st.result()

    seg_len = 128 * (-(-npos_total // (128 * num_select)))

    def nonneg(best):  # the sweep's gate: a segment with a candidate
        return best >= 0

    while st.more():
        snapshot = [sh.cache().clone() for sh in shards]
        last_t = torch.tensor(-1, device=ctl)
        any_acc = torch.zeros((), dtype=torch.bool, device=ctl)
        for j in range(num_select):
            lo = j * seg_len
            seg = [
                torch.where((sh.gpos >= lo) & (sh.gpos < lo + seg_len), snap, -1.0)
                for sh, snap in zip(shards, snapshot)
            ]
            t_glob, best, (f_g, code_g, s_g) = select(seg, nonneg)
            f, code = f_g.to(torch.int32), code_g.to(torch.int32)
            guard_ok = (last_t < 0) | (t_glob - last_t >= 2 * w - 1)
            emit = ~st.done & (best >= 0) & (code != 0) & guard_ok & (st.count < num_coefs)
            c_hat = st.record(emit, t_glob, f, code, s_g)
            for sh in shards:
                sh.update(t_glob, f, c_hat)
            last_t = torch.where(emit, t_glob, last_t)
            any_acc = any_acc | emit
            st.done = st.done | (emit & (st.e_res <= st.snr_thr))
        st.done = st.done | ~any_acc
    return st.result()


def sp_encode(
    mesh: Mesh,
    x,
    bank: torch.Tensor,
    gram_t: torch.Tensor,
    *,
    num_coefs: int,
    amp_bits: int = 16,
    tolerance_snr: float | None = None,
    singleton_weight: float = 1.0,
    n_raw: int | None = None,
    num_select: int = 1,
    axis: str = "seq",
) -> EncodedBlock:
    """Encode ONE block ``x [N, C]`` (or ``[N]``) sharded along time over
    `axis`: `sp_init`, the host quantizer steps from its peak, `sp_loop`.
    Raises `ValueError` unless N divides the axis size into shards of at
    least 2W samples."""
    bank = torch.as_tensor(bank, dtype=torch.float32)
    gram_t = torch.as_tensor(gram_t, dtype=torch.float32)
    scores0, e0, peak = sp_init(mesh, x, bank, axis=axis)
    scale, inv = quantizer_steps(peak.cpu().numpy(), amp_bits)
    return sp_loop(
        mesh, scores0, e0, scale, inv, gram_t, num_coefs=num_coefs, amp_bits=amp_bits,
        tolerance_snr=tolerance_snr, singleton_weight=singleton_weight, n_raw=n_raw,
        num_select=num_select, axis=axis,
    )
