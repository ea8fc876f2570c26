"""Ingest: `CorpusEncoder.encode(blocks, index=True)` in a closed loop, one
client, each call a window of the pool (`traffic.starts`), on one
card.

End to end: ``encode_mb_s``, the raw float32 bytes of every call completed
in the window over the window's wall time (from its start to the end of
the last call).  A share of the calls, drawn from the seed, have their
container copied into a store allocated and touched at set-up; every
container is then dropped, as by a user who writes it out: a window that
kept each container's own bytes object grew the heap call by call, and its
calls slowed from ~100 to ~180 ms over 10 s.  After the window every stored
container is judged (`judge.container_faults`), and a sample of their
blocks is replayed.
"""

from __future__ import annotations

import json
import os
import struct
import time

import numpy as np
import torch

from hscbench import inputs, judge, traffic
from reference.config import CodecConfig

KERNELS = {
    "mp_loop": "hsc_torch.ops.mp_kernels",
    "int8_init": "hsc_torch.ops.init_kernels",
}


class Client:
    def __init__(self, run):
        self.run = run
        self.cfg = run.ref_cfg
        self.mix = run.mix
        self.corpus = int(self.mix["corpus_blocks"])
        self.pool_blocks = int(self.mix["pool_blocks"])
        # per call of the window: (start in the pool, (offset, length) of its
        # container in the store, or None where the call failed or the store
        # was full)
        self.results: list[tuple[int, tuple[int, int] | None]] = []
        self.spans: list[tuple[float, float]] = []
        self.traced_calls: list[int] = []
        self.failed = 0

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        from hsc_torch.runtime import CorpusEncoder

        run = self.run
        pool = inputs.signal_pool(run.ref_mld, self.pool_blocks, run.config["signals"], run.seed, run.device)
        # every window of the pool a contiguous view: the pool, then its
        # first corpus - 1 blocks again
        self.pool = np.concatenate([pool, pool[: self.corpus - 1]])
        self.metrics_path = os.path.join(run.tmp, "encode_metrics.jsonl") if run.tracing else None
        self.codec = CorpusEncoder(
            run.port_mld, device=run.device, batch_size=int(run.config["batch_size"]),
            metrics_path=self.metrics_path,
        )
        self.starts = traffic.starts(self.pool_blocks, run.seed)
        self.store = np.ones(judge.STORE_MB << 20, np.uint8)  # touched: no faults in the window
        self.stored = 0
        self.unstored = 0
        self.keep = np.random.default_rng(inputs.derived_seed(run.seed, 21))
        # warm the cell's one shape: a whole call
        self.codec.encode(self.pool[: self.corpus], index=True)
        run.synchronize()

    # -- the window ------------------------------------------------------------

    def call(self, keep: bool = False) -> None:
        s = next(self.starts)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench:encode"):
            try:
                blob = self.codec.encode(self.pool[s : s + self.corpus], index=True)
            except Exception as e:  # a call that fails counts as failed and is reported
                self.run.log(f"encode call failed: {type(e).__name__}: {e}")
                self.failed += 1
                blob = None
        self.spans.append((t0, time.perf_counter()))
        where = None
        if blob is not None and (self.keep.random() < judge.STORE_SHARE or keep):
            if self.stored + len(blob) <= self.store.size:
                where = (self.stored, len(blob))
                self.store[self.stored:self.stored + len(blob)] = np.frombuffer(blob, np.uint8)
                self.stored += len(blob)
            else:
                self.unstored += 1
        self.results.append((s, where))

    def window(self, seconds: float, traced_s: float | None) -> None:
        run = self.run
        self.records_before = _count_lines(self.metrics_path)
        if traced_s:
            with run.profiler() as prof:
                with torch.profiler.record_function("bench:traced"):
                    self.t_start = time.perf_counter()
                    while not self.traced_calls or time.perf_counter() - self.t_start < traced_s:
                        self.call(keep=True)
                        self.traced_calls.append(len(self.spans) - 1)
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
    def blobs(self) -> list[tuple[int, bytes]]:
        return [(s, self.blob(w)) for s, w in self.results if w is not None]

    def blob(self, where: tuple[int, int]) -> bytes:
        return self.store[where[0]:where[0] + where[1]].tobytes()

    @property
    def attempted(self) -> int:
        return len(self.spans)

    def end_to_end(self) -> dict:
        done = len(self.spans) - self.failed
        mb = done * self.corpus * self.cfg.block_size * 4 / 1e6
        return {"encode_mb_s": mb / (self.t_end - self.t_start)}

    # -- what the per-layer readers read ---------------------------------------

    def program_seconds(self) -> float | None:
        """The program's own `encode_batch` seconds (pipeline to events on
        the host, no packing) over the window's calls."""
        if not self.metrics_path or not os.path.exists(self.metrics_path):
            return None
        with open(self.metrics_path) as f:
            recs = [json.loads(line) for line in f if line.strip()][self.records_before:]
        recs = [r for r in recs if r.get("kind") == "encode_batch"]
        return sum(r["seconds"] for r in recs) if recs else None

    def call_seconds(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.spans)

    def launches(self) -> dict[str, list[dict]]:
        """Every kernel launch of the traced calls, with the sizes its
        least time follows from."""
        cfg = self.cfg
        batch = int(self.run.config["batch_size"])
        out: dict[str, list[dict]] = {"mp_loop": [], "int8_init": []}
        for c in self.traced_calls:
            if self.results[c][1] is None:
                continue
            blob = self.blob(self.results[c][1])
            _, offsets = judge.container.block_offsets(blob)
            top_events = np.array([_events(blob, int(o)) for o in offsets[:-1]])
            for b0 in range(0, self.corpus, batch):
                nb = min(batch, self.corpus - b0)
                for level in range(cfg.num_levels):
                    k = cfg.counts_with_singletons[level]
                    w = cfg.window_sizes[level]
                    ev = int(top_events[b0:b0 + nb].sum()) if level == cfg.num_levels - 1 else nb * cfg.num_coefs[level]
                    out["mp_loop"].append(dict(blocks=nb, atoms=k, npos=cfg.num_positions(level), lag=2 * w - 1,
                                               events=ev))
                    if level >= 1:
                        out["int8_init"].append(dict(
                            blocks=nb, events=nb * cfg.num_coefs[level - 1], n_raw=cfg.counts[level], width=w,
                            channels=cfg.channels[level], atoms=k, npos=cfg.num_positions(level)))
        return out

    # -- after the window --------------------------------------------------------

    def free(self) -> None:
        del self.codec

    def judge(self, control: bool = False) -> dict:
        """The readings of the window's containers; with `control`, of the
        reference at TF32 put in the program's place on the same blocks."""
        run = self.run
        cfg = self.cfg
        blobs = self.blobs
        faults = sum(1 for _, blob in blobs if judge.container_faults(cfg, blob, self.corpus))
        rng = np.random.default_rng(inputs.derived_seed(run.seed, 20))
        per_call = int(run.config["judge"]["blocks_per_call"])
        batch = int(run.config["batch_size"])
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
            if cfg.num_levels == 1:
                blocks = sorted(rng.choice(self.corpus, size=per_call, replace=False).tolist())
                level0 = None
            else:
                # one of the call's batches, as the port batched it
                b0 = int(rng.integers(0, self.corpus // batch)) * batch
                blocks = sorted((b0 + rng.choice(batch, size=per_call, replace=False)).tolist())
                level0 = None if control else self.level0_follow(s + b0, batch, [b - b0 for b in blocks])
            signals = [self.pool[s + b] for b in blocks]
            if control:
                level0, tops = (list(v) for v in zip(*(ej.control(x) for x in signals)))
                r = ej.judge(signals, tops, level0)
            else:
                r = ej.judge(signals, judge.top_streams(cfg, blob, blocks), level0)
            total = r if total is None else {k: max(total[k], r[k]) if k != "unplaced_events"
                                             else total[k] + r[k] for k in r}
        if total is None:
            total = {"gap_steps_l0": float("inf"), "scale_gap_rel": float("inf"), "unplaced_events": 0}
            if cfg.num_levels > 1:
                total["gap_steps_l1"] = float("inf")
        readings.update(total)
        return readings

    def level0_follow(self, first: int, batch: int, rows: list[int]):
        """The port's level-0 events of one batch of the window: its own
        single-level encode of the same 64 blocks (the container of a
        hierarchy holds the top level only)."""
        from hsc_torch.params import dictionary_from_arrays
        from hsc_torch.runtime import CorpusEncoder

        cfg = self.cfg
        flat = CodecConfig(
            counts=cfg.counts[:1], scales=cfg.scales[:1], block_size=cfg.block_size,
            num_coefs=cfg.num_coefs[:1], tolerance_snr=cfg.tolerance_snr, amp_bits=cfg.amp_bits,
            num_select=cfg.num_select, entropy=cfg.entropy, rep_bits=cfg.rep_bits,
        )
        codec = CorpusEncoder(dictionary_from_arrays(flat.to_json(), self.run.ref_mld.dicts[:1]),
                              device=self.run.device, batch_size=batch)
        blob = codec.encode(self.pool[first : first + batch], index=True)
        return judge.top_streams(flat, blob, rows)


def _events(blob: bytes, off: int) -> int:
    """Events of the first stream of the block record at `off`."""
    return struct.unpack_from("<BIf", blob, off + 1)[1]


def _count_lines(path: str | None) -> int:
    if not path or not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for _ in f)
