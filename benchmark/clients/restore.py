"""Restore: `CorpusReader` slices ``reader[s:s + corpus_blocks]`` in a closed
loop, one client, each call a contiguous run of a container the benchmark
wrote at set-up with its own frozen writer (`inputs.container_records`:
events drawn from the seed at the configuration's shapes), so that the
port's output never becomes its input.

End to end: ``decode_mb_s``, the raw float32 bytes of the rows of every
call completed in the window over the window's wall time (from its start to
the end of the last call).  A share of the calls, drawn from the seed, copy
the rows of a sample of their blocks into a store allocated at set-up;
after the window those rows are compared bit for bit with the reference's
integer decode of the same container bytes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from hscbench import inputs, judge, traffic
from reference import container

KERNELS = {"int_decode": "hsc_torch.ops.decode_integer_kernel"}


class Client:
    def __init__(self, run):
        self.run = run
        self.cfg = run.ref_cfg
        self.mix = run.mix
        self.n_blocks = int(self.mix["container_blocks"])
        self.corpus = int(self.mix["corpus_blocks"])
        # per stored sample: (block, row of the store)
        self.kept: list[tuple[int, int]] = []
        self.spans: list[tuple[float, float]] = []
        self.traced_calls = 0
        self.failed = 0

    def setup(self) -> None:
        from hsc_torch.runtime import CorpusReader

        run = self.run
        if self.cfg.num_levels != 1:
            raise ValueError("the restore cell writes one-level containers")
        self.path = os.path.join(run.tmp, "restore.hsct")
        records = inputs.container_records(self.cfg, self.n_blocks, run.seed)
        with open(self.path, "wb") as f:
            container.write_container(self.cfg, records, f)
        self.reader = CorpusReader(self.path, run.port_mld, device=run.device,
                                   batch_size=int(run.config["batch_size"]))
        self.starts = traffic.starts(self.n_blocks - self.corpus + 1, run.seed)
        self.per_call = int(run.config["judge"]["blocks_per_call"])
        rows = max(self.per_call, (judge.STORE_MB << 20) // (4 * self.cfg.block_size))
        self.store = np.ones((rows, self.cfg.block_size), np.float32)  # touched: no faults in the window
        self.keep = np.random.default_rng(inputs.derived_seed(run.seed, 21))
        # warm the cell's one shape: a whole call
        self.reader[0:self.corpus]
        run.synchronize()

    def call(self, keep: bool = False) -> None:
        s = next(self.starts)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench:restore"):
            try:
                rows = self.reader[s:s + self.corpus]
            except Exception as e:  # a call that fails counts as failed and is reported
                self.run.log(f"restore call failed: {type(e).__name__}: {e}")
                self.failed += 1
                rows = None
        self.spans.append((t0, time.perf_counter()))
        if rows is not None and (rows.shape != (self.corpus, self.cfg.block_size) or rows.dtype != np.float32):
            self.run.log(f"restore call returned {rows.shape} {rows.dtype}")
            self.failed += 1
            rows = None
        if rows is not None and (self.keep.random() < judge.STORE_SHARE or keep):
            n = min(self.per_call, self.store.shape[0] - len(self.kept))
            for b in sorted(self.keep.choice(self.corpus, size=n, replace=False).tolist()):
                self.store[len(self.kept)] = rows[b]
                self.kept.append((s + b, len(self.kept)))

    def window(self, seconds: float, traced_s: float | None) -> None:
        run = self.run
        if traced_s:
            with run.profiler() as prof:
                with torch.profiler.record_function("bench:traced"):
                    self.t_start = time.perf_counter()
                    while not self.traced_calls or time.perf_counter() - self.t_start < traced_s:
                        self.call(keep=True)
                        self.traced_calls += 1
                    run.synchronize()
            run.read_trace(prof)
        else:
            self.t_start = time.perf_counter()
        while not self.spans or time.perf_counter() - self.t_start < seconds:
            self.call()
        self.t_end = time.perf_counter()
        ms = np.array([t1 - t0 for t0, t1 in self.spans]) * 1e3
        run.log(f"{len(ms)} calls: median {np.median(ms):.2f} ms, p10 {np.percentile(ms, 10):.2f}, "
                f"p90 {np.percentile(ms, 90):.2f}, first {ms[0]:.2f}, last {ms[-1]:.2f}")

    @property
    def attempted(self) -> int:
        return len(self.spans)

    def end_to_end(self) -> dict:
        done = len(self.spans) - self.failed
        mb = done * self.corpus * self.cfg.block_size * 4 / 1e6
        return {"decode_mb_s": mb / (self.t_end - self.t_start)}

    def launches(self) -> dict[str, list[dict]]:
        """Every kernel launch of the traced calls, with the sizes its
        least time follows from: one per chunk of `batch_size` blocks."""
        cfg = self.cfg
        batch = int(self.run.config["batch_size"])
        out = []
        for _ in range(self.traced_calls):
            for b0 in range(0, self.corpus, batch):
                nb = min(batch, self.corpus - b0)
                out.append(dict(blocks=nb, events=nb * cfg.num_coefs[0], width=cfg.scales[0],
                                atoms=cfg.counts[0], n=cfg.block_size))
        return {"int_decode": out}

    def free(self) -> None:
        self.reader.close()
        del self.reader

    def judge(self, control: bool = False) -> dict:
        """The stored rows against the reference; with `control`, the
        reference's own decode in bfloat16 put in the program's place."""
        with open(self.path, "rb") as f:
            data = f.read()
        if control:
            kept = [(b, judge.bf16_row(self.cfg, self.run.ref_mld, data, b)) for b, _ in self.kept]
        else:
            kept = [(b, self.store[i]) for b, i in self.kept]
        readings = judge.judge_rows(self.cfg, self.run.ref_mld, data, kept)
        readings["rows_unjudged"] = int(not kept)
        return readings

    def cleanup(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)
