"""Distributed dictionary learning — counterpart of `hsc_tpu.parallel.learn`.

Each shard accumulates (assignment sums, counts, objective) over its own
windows; the shards' statistics are summed in shard order (the `psum`),
and the normalize-update runs once on the summed statistics, so every
replica's dictionary is the same by construction.  `distributed_kmeans` is
the sharded counterpart of `learn.kmeans.kmeans_refine_device`, with the
same dead-atom semantics and, like it, no host sync per iteration.
"""

from __future__ import annotations

import torch

from ..learn.kmeans import (
    SILENT_NORM,
    apply_reseed,
    dead_reseed_plan,
    kmeans_assign_update,
    normalize_centroids,
)
from .mesh import Mesh, psum


def _shard_windows(mesh: Mesh, windows, axis: str) -> list[torch.Tensor]:
    """``[M, D]`` windows (M a multiple of the axis size) as contiguous
    slices of M / S rows, each on its shard's device."""
    devs = mesh.axis_devices(axis)
    windows = torch.as_tensor(windows, dtype=torch.float32)
    if windows.shape[0] % len(devs):
        raise ValueError("windows must divide the mesh axis (pad first)")
    mloc = windows.shape[0] // len(devs)
    return [windows[i * mloc : (i + 1) * mloc].to(dev) for i, dev in enumerate(devs)]


def distributed_kmeans_step(mesh: Mesh, windows, centroids, axis: str = "data"):
    """One sharded refinement step: `windows [M, D]` split over `axis`,
    `centroids [K, D]` replicated.  Returns ``(new_centroids [K, D],
    objective)`` on the first shard's device."""
    devs = mesh.axis_devices(axis)
    ws = _shard_windows(mesh, windows, axis)
    c = torch.as_tensor(centroids, dtype=torch.float32)
    stats = [kmeans_assign_update(w, c.to(dev)) for w, dev in zip(ws, devs)]
    ctl = devs[0]
    sums = psum(ctl, [s.sums for s in stats])
    counts = psum(ctl, [s.counts for s in stats])
    obj = psum(ctl, [s.objective for s in stats])
    return normalize_centroids(sums, counts, c.to(ctl)), obj


def distributed_kmeans(mesh: Mesh, windows, centroids0, iterations: int, axis: str = "data"):
    """Full sharded k-means refinement: per iteration assign on every shard,
    sum the statistics in shard order, normalize, reseed dead slots from
    the globally worst-represented non-silent windows.  The keys are the
    shards' keys concatenated in shard order (the tiled all-gather, which
    reproduces the unsharded key vector), and each reseed row comes from
    the shard that owns its window.  Every step is queued without a host
    read.  Windows must divide the mesh axis (the same `ValueError` as the
    JAX package).

    Returns ``(centroids [K, D], objectives [iterations])`` on the first
    shard's device."""
    devs = mesh.axis_devices(axis)
    ws = _shard_windows(mesh, windows, axis)
    ctl = devs[0]
    mloc = ws[0].shape[0]
    m = mloc * len(ws)
    live = [torch.linalg.vector_norm(w, dim=1) > SILENT_NORM for w in ws]
    valid = psum(ctl, [lv.sum() for lv in live])
    c = torch.as_tensor(centroids0, dtype=torch.float32).to(ctl)
    inf = torch.tensor(float("inf"), device=ctl)
    objectives = []
    for _ in range(int(iterations)):
        stats = [kmeans_assign_update(w, c.to(dev)) for w, dev in zip(ws, devs)]
        sums = psum(ctl, [s.sums for s in stats])
        counts = psum(ctl, [s.counts for s in stats])
        obj = psum(ctl, [s.objective for s in stats])
        new = normalize_centroids(sums, counts, c)
        keys = torch.cat([
            torch.where(lv, s.best_abs, inf.to(lv.device)).to(ctl) for lv, s in zip(live, stats)
        ])
        use, widx = dead_reseed_plan(counts <= 0, keys, valid, m)
        rows = []
        for i, (w, dev) in enumerate(zip(ws, devs)):
            lidx = widx.to(dev) - i * mloc
            own = (lidx >= 0) & (lidx < mloc)
            rows.append(torch.where(own[:, None], w.index_select(0, lidx.clamp(0, mloc - 1)), 0.0))
        c = apply_reseed(new, use, psum(ctl, rows))
        objectives.append(obj)
    if not objectives:
        return c, torch.zeros((0,), dtype=torch.float32, device=ctl)
    return c, torch.stack(objectives)
