"""Mesh ingest: `CorpusEncoder(mesh=make_mesh({"data": S}, devices=<the
cell's cards>)).encode(blocks, index=True)` in a closed loop, one client,
each call a window of the pool (`traffic.starts`): the object that
``hsc-torch-codec encode --mesh S`` builds, super-batches of ``batch_size``
blocks a shard.

Timing, the store and the structure checks are `clients/ingest.py`'s.  The
judge replays in each judged call ``judge.blocks_per_call / S`` blocks from
each shard's slice of one seeded super-batch, so every card's streams and
their gather in block order are held to the reference: a shard's blocks
answered with another's read as gaps or unplaced events.  At set-up a run
whose mesh is not S distinct cards (on a card) fails, so a run that fell
back to fewer cards is no result.

The process runs at the configuration's ``intra_op_threads``
(`torch.set_num_threads`, as ``OMP_NUM_THREADS`` sets it for the CLI),
restored when the run ends: one Python thread drives the 4 cards, and on a
shared host a parallel region of a thread a core waits for its slowest
thread.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hscbench import inputs, judge, mesh_spans, traffic
from hscbench.layers import load_file

_INGEST = load_file(os.path.join(os.path.dirname(os.path.abspath(__file__)), "ingest.py"), "client_ingest_base")
KERNELS = _INGEST.KERNELS


class Client(_INGEST.Client):
    def __init__(self, run):
        super().__init__(run)
        self.shards = int(run.config["mesh"]["data"])
        self.batch = int(run.config["batch_size"])
        self.per_shard = int(run.config["judge"]["blocks_per_call"]) // self.shards
        if self.cfg.num_levels != 1:
            raise ValueError("the mesh client judges a one-level codec (its configuration cuts "
                             "configs[4]'s levels to one: `reduced`)")
        if self.shards != int(run.cell["chips"]) or self.per_shard * self.shards != int(
                run.config["judge"]["blocks_per_call"]):
            raise ValueError(f"mesh {run.config['mesh']} against {run.cell['chips']} chips and "
                             f"{run.config['judge']['blocks_per_call']} judged blocks a call")
        if self.corpus < self.batch * self.shards:
            raise ValueError("a call must hold one whole super-batch")
        self.threads_before = torch.get_num_threads()
        torch.set_num_threads(int(run.config["intra_op_threads"]))

    def cleanup(self) -> None:
        torch.set_num_threads(self.threads_before)

    def setup(self) -> None:
        from hsc_torch.parallel import make_mesh
        from hsc_torch.runtime import CorpusEncoder

        run = self.run
        mesh = make_mesh({"data": self.shards}, devices=run.devices)
        cards = mesh.axis_devices("data")
        if run.device.type == "cuda" and len(set(cards)) != self.shards:
            raise RuntimeError(f"the mesh's data axis holds {len(set(cards))} distinct card(s), not {self.shards}")
        run.log(f"mesh data axis: {', '.join(str(d) for d in cards)}")
        pool = inputs.signal_pool(run.ref_mld, self.pool_blocks, run.config["signals"], run.seed, run.device)
        self.pool = np.concatenate([pool, pool[: self.corpus - 1]])
        self.metrics_path = os.path.join(run.tmp, "encode_metrics.jsonl") if run.tracing else None
        self.codec = CorpusEncoder(run.port_mld, device=run.device, batch_size=self.batch,
                                   metrics_path=self.metrics_path, mesh=mesh)
        self.starts = traffic.starts(self.pool_blocks, run.seed)
        self.store = np.ones(judge.STORE_MB << 20, np.uint8)  # touched: no faults in the window
        self.stored = 0
        self.unstored = 0
        self.keep = np.random.default_rng(inputs.derived_seed(run.seed, 21))
        # warm the cell's one shape on every card: a whole call
        self.codec.encode(self.pool[: self.corpus], index=True)
        run.synchronize()

    def window(self, seconds: float, traced_s: float | None) -> None:
        from hsc_torch.parallel import dp

        # the parent of `dp.SHARD_BATCHES` has no such counter: nothing logged
        counter = getattr(dp, "SHARD_BATCHES", None)
        before = dict(counter or {})
        super().window(seconds, traced_s)
        self.run.log(f"call ms: {[round((t1 - t0) * 1e3, 1) for t0, t1 in self.spans]}")
        if counter is not None:
            grown = [counter[i] - before.get(i, 0) for i in range(self.shards)]
            self.run.log(f"batches a shard in the window: {grown}")
        trace = self.run.trace
        if trace is not None and trace.window_s > 0:
            busy = [round(100 * trace.busy_s(c) / trace.window_s, 3) for c in self.run.card_indices]
            self.run.log(f"busy % of the traced window a card: {busy}")
            for name in [f"hsc:mesh.{s}" for s in ("upload", "init", "peaks", "loop", "collect")]:
                shares = mesh_spans.idle_in_span_by_card_pct(self.run, name)
                if shares is not None:
                    self.run.log(f"idle % in {name} a card: {[round(v, 3) for v in shares]}")

    def free(self) -> None:
        run = self.run
        if run.device.type == "cuda":
            peaks = [torch.cuda.max_memory_allocated(d) for d in run.devices]
            run.log(f"memory_peak_bytes a card: {peaks}")
        super().free()

    def draw(self, rng) -> list[int]:
        """The blocks of a call judged: ``per_shard`` from each shard's
        ``batch_size``-block slice of one seeded whole super-batch."""
        sb = self.batch * self.shards
        first = int(rng.integers(0, self.corpus // sb)) * sb
        return sorted(
            first + i * self.batch + int(j)
            for i in range(self.shards)
            for j in rng.choice(self.batch, size=self.per_shard, replace=False)
        )

    def judge(self, control: bool = False) -> dict:
        """The readings of the window's containers; with `control`, of the
        reference at TF32 put in the program's place on the same blocks."""
        run = self.run
        cfg = self.cfg
        blobs = self.blobs
        faults = sum(1 for _, blob in blobs if judge.container_faults(cfg, blob, self.corpus))
        rng = np.random.default_rng(inputs.derived_seed(run.seed, 20))
        calls = rng.choice(len(blobs), size=min(judge.CALLS, len(blobs)), replace=False)
        ej = judge.EncodeJudge(run.ref_mld, run.device)
        if self.unstored:
            run.log(f"{self.unstored} containers past the store's {judge.STORE_MB} MB were not judged")
        readings = {"structure_faults": faults}
        total = None
        for c in calls:
            s, blob = blobs[int(c)]
            if judge.container_faults(cfg, blob, self.corpus):
                continue
            blocks = self.draw(rng)
            run.log(f"judged blocks of the call at {s}: {blocks}")
            signals = [self.pool[s + b] for b in blocks]
            if control:
                tops = [ej.control(x)[1] for x in signals]
            else:
                tops = judge.top_streams(cfg, blob, blocks)
            r = ej.judge(signals, tops)
            total = r if total is None else {k: max(total[k], r[k]) if k != "unplaced_events"
                                             else total[k] + r[k] for k in r}
        if total is None:
            total = {"gap_steps_l0": float("inf"), "scale_gap_rel": float("inf"), "unplaced_events": 0}
        readings.update(total)
        return readings
