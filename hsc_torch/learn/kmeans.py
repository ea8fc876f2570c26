"""Convolutional dictionary learning — spherical k-means, counterpart of
`hsc_tpu.learn.kmeans`.

Reference parity (SURVEY.md §2 C8, §3.5): `hsc/modeling.py ::
ConvolutionalDictionaryLearner.train` — window extraction (random offsets or
local-energy maxima), init from samples, k-means refinement (assign via max
|correlation|, update centroids, dead-atom reset), algorithm selected by
string kwarg (`'samples'`, `'kmean'`).

Host NumPy, copied verbatim from the JAX package so that the 'samples'
algorithm and every k-means start are bitwise its own: `extract_windows`,
`SILENT_NORM` and `ConvolutionalDictionaryLearner._init_centroids`.

Torch tensors on the learner's device, the rest:
  * assignment = one dense ``windows @ centroids^T`` product (sign-aware: a
    window can match an atom with either polarity); `argmax` takes the first
    maximum, as `jnp.argmax` does;
  * update = a signed one-hot product, not `index_add_` (float atomics would
    make the sums depend on the order the card adds them in);
  * `kmeans_refine_device` runs every iteration on the device with no host
    sync: no `.item()`, no test of a device value on the host; the
    objectives are stacked and copied back once.  Both products of
    `kmeans_assign_update` run under `device.spec_numerics`, so they are full
    float32 whatever flags the caller has set (no TF32, no bf16).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import canonical_device, spec_numerics


class KMeansStats(NamedTuple):
    sums: torch.Tensor  # [K, W*C] signed assignment sums
    counts: torch.Tensor  # [K] number of windows assigned
    objective: torch.Tensor  # scalar: sum of |best correlation| (monotone metric)
    best_abs: torch.Tensor  # [M] per-window |best score| (drives dead-atom reset)


def extract_windows(
    xs: np.ndarray,
    window: int,
    num: int,
    *,
    mode: str = "energy",
    seed: int = 0,
) -> np.ndarray:
    """Extract ``[num, window, C]`` training windows from blocks ``[B, N, C]``.

    Reference: `hsc/modeling.py :: ConvolutionalDictionaryLearner`
    `_extract*Windows` — `mode='random'` samples uniform offsets;
    `mode='energy'` centers windows on local energy maxima (the reference's
    local-maxima strategy), implemented as a vectorized moving-energy argsort
    rather than a Python scan.
    """
    xs = np.asarray(xs, dtype=np.float32)
    if xs.ndim == 2:
        xs = xs[:, :, None]
    b, n, c = xs.shape
    npos = n - window + 1
    if npos <= 0:
        raise ValueError("blocks shorter than window")
    rng = np.random.default_rng(seed)
    if mode == "random":
        bi = rng.integers(0, b, size=num)
        ti = rng.integers(0, npos, size=num)
    elif mode == "energy":
        # moving energy per placement, then sample positions with probability
        # proportional to energy (keeps diversity; pure top-k collapses onto
        # one loud event repeated `num` times)
        e = np.square(xs).sum(axis=2)  # [B, N]
        kernel = np.ones(window, dtype=np.float32)
        env = np.stack([np.convolve(e[i], kernel, mode="valid") for i in range(b)])
        p = env.reshape(-1).astype(np.float64)
        tot = p.sum()
        if tot <= 0:
            p = np.full(p.shape, 1.0 / p.size)
        else:
            p = p / tot
        flat = rng.choice(p.size, size=num, replace=True, p=p)
        bi, ti = np.divmod(flat, npos)
    else:
        raise ValueError(f"unknown extraction mode {mode!r}")
    out = np.zeros((num, window, c), dtype=np.float32)
    for j in range(num):
        out[j] = xs[bi[j], ti[j] : ti[j] + window]
    return out


def kmeans_assign_update(windows: torch.Tensor, centroids: torch.Tensor) -> KMeansStats:
    """One assignment pass: (sums, counts, objective, best_abs).

    ``windows [M, D]`` (flattened W*C), ``centroids [K, D]`` unit-norm.
    Polarity-invariant: window m contributes ``sign(score) * window`` to its
    best-|score| centroid (the lowest such centroid on a tie).
    """
    with spec_numerics():
        scores = windows @ centroids.T  # [M, K]
        best = scores.abs().argmax(dim=1)  # [M], the first maximum
        bestval = scores.gather(1, best[:, None])[:, 0]
        sign = torch.where(bestval >= 0, 1.0, -1.0)
        k = centroids.shape[0]
        onehot = (best[:, None] == torch.arange(k, device=best.device)).to(windows.dtype)
        onehot = onehot * sign[:, None]  # [M, K] signed
        sums = onehot.T @ windows
    counts = onehot.abs().sum(dim=0)
    best_abs = bestval.abs()
    return KMeansStats(sums=sums, counts=counts, objective=best_abs.sum(), best_abs=best_abs)


# windows with norm below this are "silent" and never used to reseed a dead
# atom (reference dead-atom handling; shared by the local and distributed
# refinement loops)
SILENT_NORM = 1e-6


def dead_reseed_plan(
    dead: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor, m: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank dead centroid slots against the worst-represented windows.

    ``keys [M]`` is per-window ``|best score|`` with silent windows parked at
    +inf; ``valid`` is the number of non-silent windows (a device scalar).
    Returns ``(use [K] bool — reseed this slot, widx [K] — window index per
    slot)``: the lowest dead slot takes the worst window, stable ties.  All
    on the device: a sort, a prefix sum and a gather.
    """
    order = torch.argsort(keys, stable=True)  # worst-represented first
    rank = torch.cumsum(dead.to(torch.int64), dim=0) - 1  # per dead slot
    use = dead & (rank < torch.clamp(valid, max=m))
    widx = order[rank.clamp(0, m - 1)]  # [K] gather, no scatter
    return use, widx


def apply_reseed(new: torch.Tensor, use: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Replace reseeded slots with their unit-normalized window rows."""
    rows = rows / torch.linalg.vector_norm(rows, dim=1, keepdim=True).clamp_min(1e-8)
    return torch.where(use[:, None], rows, new)


def normalize_centroids(
    sums: torch.Tensor, counts: torch.Tensor, old: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """Deterministic centroid update: unit-normalized sums; dead atoms
    (count == 0) keep their previous value (reference dead-atom handling —
    reset strategies live in the learner)."""
    new = sums / torch.linalg.vector_norm(sums, dim=1, keepdim=True).clamp_min(eps)
    return torch.where((counts <= 0)[:, None], old, new)


def kmeans_refine_device(
    windows: torch.Tensor, cents0: torch.Tensor, *, iterations: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-resident k-means refinement: ``iterations`` full steps
    (assign -> normalize update -> dead-atom reset) on the device of
    `windows`, returning ``(centroids, objectives[iterations])`` there.

    Every step is queued without waiting on the device: dead slots are
    reseeded through a mask (`dead_reseed_plan`), never by a host test of
    whether any slot died.  Same algorithm as `hsc_tpu`'s scanned form
    (reference C8 semantics, SURVEY.md §3.5): dead centroids are reseeded
    from the windows the current dictionary represents worst (smallest
    ``|best score|``), skipping near-silent windows, lowest dead slot taking
    the worst window.
    """
    m = windows.shape[0]
    # reset candidates ranked once per step: silent windows sort to the end
    silent = ~(torch.linalg.vector_norm(windows, dim=1) > SILENT_NORM)
    valid = m - silent.sum()
    cents = cents0
    objectives = []
    for _ in range(int(iterations)):
        stats = kmeans_assign_update(windows, cents)
        new = normalize_centroids(stats.sums, stats.counts, cents)
        keys = stats.best_abs.masked_fill(silent, float("inf"))
        use, widx = dead_reseed_plan(stats.counts <= 0, keys, valid, m)
        cents = apply_reseed(new, use, windows[widx])
        objectives.append(stats.objective)
    if not objectives:
        return cents, torch.zeros((0,), dtype=windows.dtype, device=windows.device)
    return cents, torch.stack(objectives)


class ConvolutionalDictionaryLearner:
    """Learns one level's filter bank from training sequences on `device`.

    Reference: `hsc/modeling.py :: ConvolutionalDictionaryLearner`
    (`k`, `windowSize`, `algorithm` in {'samples', 'kmean'}).
    """

    def __init__(
        self,
        k: int,
        window: int,
        channels: int = 1,
        *,
        algorithm: str = "kmean",
        num_windows: int = 4096,
        iterations: int = 20,
        extraction: str = "energy",
        seed: int = 0,
        device,
    ):
        if algorithm not in ("samples", "kmean"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.device = canonical_device(device)
        self.k = int(k)
        self.window = int(window)
        self.channels = int(channels)
        self.algorithm = algorithm
        self.num_windows = int(num_windows)
        self.iterations = int(iterations)
        self.extraction = extraction
        self.seed = int(seed)
        self.objective_history: list[float] = []

    def _init_centroids(self, windows: np.ndarray) -> np.ndarray:
        """Deterministic farthest-point-style init: first window, then
        greedily the window least correlated with the chosen set."""
        m, d = windows.shape
        norms = np.linalg.norm(windows, axis=1)
        order = np.argsort(-norms, kind="stable")
        chosen = [int(order[0])]
        wn = windows / np.maximum(norms[:, None], 1e-8)
        maxcorr = np.abs(wn @ wn[chosen[0]])
        for _ in range(self.k - 1):
            cand = int(np.argmin(maxcorr))
            chosen.append(cand)
            maxcorr = np.maximum(maxcorr, np.abs(wn @ wn[cand]))
        return wn[np.asarray(chosen)].astype(np.float32)

    def train(self, xs: np.ndarray, *, mesh=None, mesh_axis: str = "data") -> np.ndarray:
        """Learn ``[K, W, C]`` filters from blocks ``[B, N, C]``.  With a
        `mesh` (of the learner's device type) the k-means statistics are
        sharded over `mesh_axis` (`parallel.learn.distributed_kmeans`)."""
        windows = extract_windows(
            xs, self.window, self.num_windows, mode=self.extraction, seed=self.seed
        )
        m = windows.shape[0]
        flat = windows.reshape(m, -1)
        cents = self._init_centroids(flat)
        self.objective_history = []
        if self.algorithm == "samples":
            return cents.reshape(self.k, self.window, self.channels)
        if mesh is not None:
            from ..parallel.learn import distributed_kmeans
            from ..parallel.mesh import check_mesh_device

            check_mesh_device(mesh, self.device, "ConvolutionalDictionaryLearner.train")
            shards = int(mesh.shape[mesh_axis])
            pad = (-m) % shards
            if pad:
                # zero windows assign somewhere with score 0 and add nothing
                # to the sums; counts inflate harmlessly (normalize is
                # direction-only), and silent windows never reseed a dead atom
                flat = np.concatenate([flat, np.zeros((pad, flat.shape[1]), flat.dtype)])
            cents, objs = distributed_kmeans(
                mesh, torch.from_numpy(flat), torch.from_numpy(cents), self.iterations, axis=mesh_axis
            )
        else:
            cents, objs = kmeans_refine_device(
                torch.from_numpy(flat).to(self.device),
                torch.from_numpy(cents).to(self.device),
                iterations=self.iterations,
            )
        self.objective_history = objs.cpu().tolist()
        return cents.cpu().numpy().reshape(self.k, self.window, self.channels)
