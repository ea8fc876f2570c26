"""Tensor-parallel greedy MP — counterpart of `hsc_tpu.parallel.tp`: the
dictionary's atoms sharded over the mesh's 'model' axis, for a K too large
for one device.

  * `tp_init`: each shard correlates the whole block against its ``K/S``
    atoms; the peak is the max over shards; e0 is the single-device init's
    expression on the whole block.
  * `tp_loop`, per coefficient: the position stage is the elementwise max
    over shards of the local colmax caches; the atom stage extracts each
    shard's best atom at that position, and ties go to the lowest GLOBAL
    atom id (a min over candidates, sentinel ``K + 1``); the winner's
    (code, score) is the packed sum.  The update is local by construction:
    `gram` is the untransposed ``G[g, f, lag]`` split on ``g``, so every
    shard holds exactly the rows it updates.  ``num_select > 1`` takes one
    max snapshot of the colmax caches per sweep, then each segment's atom
    stage runs against the current scores.

The local colmax buffer starts at zeros, not -1, as in the JAX package
(its pad columns are never read).  Like `parallel.sp`, this is eager torch
ops with no host read per coefficient; given the same init the streams are
the single-device loop's bit for bit.
"""

from __future__ import annotations

import torch

from ..ops.correlate import correlate_bank_torch
from ..ops.encode import EncodedBlock, block_energy, quantize, quantizer_steps
from ._stream import ReplicatedStream, gather_to, psum_winner, selection_weights
from .mesh import Mesh
from .sp import _as_block


def _shard_count(mesh: Mesh, k: int, axis: str) -> int:
    s = int(mesh.shape[axis])
    if k % s != 0:
        raise ValueError(f"K={k} must divide the {axis}-axis size {s}")
    return s


def tp_init(mesh: Mesh, x, bank: torch.Tensor, *, axis: str = "model"):
    """The sharded init of ONE block ``x [N, C]`` (or ``[N]``) against
    ``bank [K, W, C]``: ``(scores0, e0, peak)`` — one ``[K/S, npos]`` score
    tensor per shard on its device (atoms ``[i·K/S, (i+1)·K/S)``), the block
    energy and the peak (0-d tensors on the first shard's device)."""
    x = _as_block(x)
    devs = mesh.axis_devices(axis)
    k = int(bank.shape[0])
    kl = k // _shard_count(mesh, k, axis)
    scores0 = [
        correlate_bank_torch(x.to(dev)[None], bank[i * kl : (i + 1) * kl].to(dev))[0]
        for i, dev in enumerate(devs)
    ]
    peak = gather_to(devs[0], [sc.abs().amax() for sc in scores0]).amax()
    return scores0, block_energy(x.to(devs[0])[None])[0], peak


def tp_shard_scores(mesh: Mesh, scores0: torch.Tensor, *, axis: str = "model") -> list[torch.Tensor]:
    """A single-device init ``[K, npos]`` as `tp_loop`'s per-shard scores:
    ``K/S`` rows each, on the shards' devices."""
    devs = mesh.axis_devices(axis)
    kl = scores0.shape[0] // _shard_count(mesh, int(scores0.shape[0]), axis)
    return [scores0[i * kl : (i + 1) * kl].to(dev) for i, dev in enumerate(devs)]


class _Shard:
    """One shard's atoms: lag-padded scores ``[K/S, npos + 2W - 2]``, their
    colmax cache and the Gram rows ``G[g, :, :]`` of its atoms."""

    def __init__(self, i, dev, scores0, gram, weights, *, kl, w, npos):
        f32 = torch.float32
        self.dev, self.g0, self.w, self.npos = dev, i * kl, w, npos
        self.lags = torch.arange(2 * w - 1, device=dev)
        self.gram = gram[i * kl : (i + 1) * kl].to(dev, f32)  # [KL, K, lag]
        self.weights = weights[i * kl : (i + 1) * kl].to(dev)
        s0 = scores0.to(dev)
        self.scores = torch.zeros((kl, npos + 2 * w - 2), dtype=f32, device=dev)
        self.scores[:, w - 1 : w - 1 + npos] = s0
        self.colmax = torch.zeros((npos + 2 * w - 2,), dtype=f32, device=dev)
        self.colmax[w - 1 : w - 1 + npos] = (s0.abs() * self.weights[:, None]).amax(dim=0)

    def cache(self) -> torch.Tensor:
        return self.colmax[self.w - 1 : self.w - 1 + self.npos]

    def atom(self, t, inv_scale, maxcode: float):
        """This shard's best atom at position `t`: ``(global id, weighted
        |score|)`` as ``[2]`` int64 / float32 and the packed ``(code,
        score)`` float32 ``[2]``."""
        col = self.scores.index_select(1, t.to(self.dev).view(1) + (self.w - 1))[:, 0]
        wcol = col.abs() * self.weights
        f = wcol.argmax().view(1)
        s = col.index_select(0, f)
        code = quantize(s, inv_scale.to(self.dev), maxcode)
        return self.g0 + f, wcol.index_select(0, f), torch.cat([code.to(torch.float32), s])

    def update(self, t, f_glob, c_hat) -> None:
        """Subtract ``c_hat·G[g, f_glob, :]`` (two ops) over the window at
        `t` and refresh its colmax."""
        t, c_hat = t.to(self.dev), c_hat.to(self.dev)
        k = self.gram.shape[1]
        rows = self.gram.index_select(1, f_glob.to(self.dev).clamp(0, k - 1).view(1))[:, 0, :]
        idx = t + self.lags
        prod = c_hat * rows
        window = self.scores.index_select(1, idx) - prod
        self.scores.index_copy_(1, idx, window)
        self.colmax.index_copy_(0, idx, (window.abs() * self.weights[:, None]).amax(dim=0))


def tp_loop(
    mesh: Mesh,
    scores0: list[torch.Tensor],
    e0,
    scale,
    inv_scale,
    gram: torch.Tensor,
    *,
    num_coefs: int,
    amp_bits: int = 16,
    tolerance_snr: float | None = None,
    singleton_weight: float = 1.0,
    n_raw: int | None = None,
    num_select: int = 1,
    axis: str = "model",
) -> EncodedBlock:
    """The atom-sharded greedy loop of ONE block from its init: `scores0`
    one ``[K/S, npos]`` tensor per shard (`tp_init`, or `tp_shard_scores`
    of a single-device init), `e0` the block energy, `scale` / `inv_scale`
    the host quantizer steps, `gram` the UNtransposed ``G[g, f, lag]``.
    Returns an unbatched `EncodedBlock` on the first shard's device; the
    caller's scores are not modified."""
    devs = mesh.axis_devices(axis)
    k, lag = int(gram.shape[0]), int(gram.shape[2])
    w = (lag + 1) // 2
    s_count = _shard_count(mesh, k, axis)
    kl = k // s_count
    if n_raw is None:
        n_raw = k
    npos = int(scores0[0].shape[1])
    maxcode = float((1 << (amp_bits - 1)) - 1)
    ctl = devs[0]
    weights = selection_weights(torch.arange(k), n_raw, singleton_weight)
    shards = [
        _Shard(i, dev, sc, gram, weights, kl=kl, w=w, npos=npos)
        for i, (dev, sc) in enumerate(zip(devs, scores0))
    ]
    st = ReplicatedStream(ctl, num_coefs, e0, scale, inv_scale, tolerance_snr)
    big = torch.tensor(k + 1, device=ctl)

    def atom_stage(t, v_glob):
        """Winner extraction at position `t`: the global atom id and the
        packed ``(code, score)``; `v_glob` None takes the max of the
        shards' values (the sweep), else the position stage's value."""
        parts = [sh.atom(t, st.inv_scale, maxcode) for sh in shards]
        f_ids = gather_to(ctl, [p[0] for p in parts])[:, 0]
        v_loc = gather_to(ctl, [p[1] for p in parts])[:, 0]
        if v_glob is None:
            v_glob = v_loc.amax()
        cand = torch.where(v_loc == v_glob, f_ids, big)
        f_glob = cand.amin()
        packed = gather_to(ctl, [p[2] for p in parts])
        return f_glob, psum_winner((cand == f_glob)[:, None], packed)

    def colmax_max() -> torch.Tensor:
        return gather_to(ctl, [sh.cache() for sh in shards]).amax(dim=0)

    if num_select <= 1:
        for _ in range(int(num_coefs)):
            colmax_glob = colmax_max()
            t = colmax_glob.argmax()  # ties: lowest position
            f_glob, (code_g, s_val) = atom_stage(t, colmax_glob.index_select(0, t.view(1))[0])
            code = code_g.to(torch.int32)
            emit = ~st.done & (code != 0)
            c_hat = st.record(emit, t, f_glob, code, s_val)
            for sh in shards:
                sh.update(t, f_glob, c_hat)
            st.done = st.done | (code == 0) | (emit & (st.e_res <= st.snr_thr))
        return st.result()

    seg_len = 128 * (-(-npos // (128 * num_select)))
    ids = torch.arange(npos, device=ctl)
    while st.more():
        snapshot = colmax_max()  # one max over shards per sweep
        last_t = torch.tensor(-1, device=ctl)
        any_acc = torch.zeros((), dtype=torch.bool, device=ctl)
        for j in range(num_select):
            lo = j * seg_len
            seg = torch.where((ids >= lo) & (ids < lo + seg_len), snapshot, -1.0)
            seg_best = seg.amax()
            t = seg.argmax().clamp(max=npos - 1)
            f_glob, (code_g, s_val) = atom_stage(t, None)
            code = code_g.to(torch.int32)
            guard_ok = (last_t < 0) | (t - last_t >= 2 * w - 1)
            emit = ~st.done & (seg_best >= 0) & (code != 0) & guard_ok & (st.count < num_coefs)
            c_hat = st.record(emit, t, f_glob, code, s_val)
            for sh in shards:
                sh.update(t, f_glob, c_hat)
            last_t = torch.where(emit, t, last_t)
            any_acc = any_acc | emit
            st.done = st.done | (emit & (st.e_res <= st.snr_thr))
        st.done = st.done | ~any_acc
    return st.result()


def tp_encode(
    mesh: Mesh,
    x,
    bank: torch.Tensor,
    gram: torch.Tensor,
    *,
    num_coefs: int,
    amp_bits: int = 16,
    tolerance_snr: float | None = None,
    singleton_weight: float = 1.0,
    n_raw: int | None = None,
    num_select: int = 1,
    axis: str = "model",
) -> EncodedBlock:
    """Encode ONE block ``x [N, C]`` (or ``[N]``) with atoms sharded over
    `axis`: `tp_init`, the host quantizer steps from its peak, `tp_loop`.
    `gram` is the UNtransposed Gram tensor ``G[g, f, lag]``.  Raises
    `ValueError` unless K divides the axis size."""
    bank = torch.as_tensor(bank, dtype=torch.float32)
    gram = torch.as_tensor(gram, dtype=torch.float32)
    scores0, e0, peak = tp_init(mesh, x, bank, axis=axis)
    scale, inv = quantizer_steps(peak.cpu().numpy(), amp_bits)
    return tp_loop(
        mesh, scores0, e0, scale, inv, gram, num_coefs=num_coefs, amp_bits=amp_bits,
        tolerance_snr=tolerance_snr, singleton_weight=singleton_weight, n_raw=n_raw,
        num_select=num_select, axis=axis,
    )
