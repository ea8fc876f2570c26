"""Restore of the distributed form: `CorpusReader` slices
``reader[s:s + corpus_blocks]`` in a closed loop, one client, of a container
whose records hold each event at its native level (``hsc-torch-codec encode
--distributed``), written at set-up by the benchmark's frozen writer
(`reference/levels.py`) from top-level events drawn from the seed.

The configuration states ``"form": "distributed"`` and at least 2 levels,
and its ``writer`` how many blocks of a real distributed encode kept r of
their top events at the top level (the rest are singletons, stored one
level down).  Timing and the store are
`clients/restore.py`'s.  The judge compares the stored rows bit for bit
with the reference's per-level decode (`levels.decode_levels`) of the same
container bytes; its controls put in the program's place that decode with
a bfloat16 epilogue (``judge(control=True)``) or with every stream decoded
through the top level's representations (``judge(control="top_reps")``).
"""

from __future__ import annotations

import os
import time

import numpy as np

from hscbench import inputs, judge, layers, spans, traffic
from hscbench.layers import load_file
from reference import levels

_RESTORE = load_file(os.path.join(os.path.dirname(os.path.abspath(__file__)), "restore.py"), "client_restore_base")
KERNELS = _RESTORE.KERNELS
SPANS = ("unpack", "dispatch", "drain", "levelsum", "stack")


def _rows_summed() -> int | None:
    """The runtime's count of rows summed per level on the host; None in a
    program that keeps no such count."""
    import hsc_torch.runtime as runtime

    return getattr(runtime, "ROWS_SUMMED_BY_LEVEL", None)


def top_events(cfg, n_blocks: int, writer: dict, seed: int):
    """``(positions, atoms, codes, scales)`` of the top level's
    ``num_coefs`` events a block: positions uniform; the count of events a
    block that keep a raw top-level atom drawn from
    ``writer["blocks_by_raw_events"]`` (the count of blocks of a real
    encode holding r of them, r = 0, 1, ...), on events chosen uniformly,
    their atoms uniform over the raw ones, every other atom a singleton
    uniform over the lower level's; codes and scales as the one-level
    restore's (`inputs.container_records`)."""
    rng = np.random.default_rng(inputs.derived_seed(seed, 3))
    top = cfg.num_levels - 1
    m = cfg.num_coefs[top]
    maxcode = cfg.amp_maxcode
    blocks = np.asarray(writer["blocks_by_raw_events"], np.float64)
    if blocks.size > m + 1:
        raise ValueError(f"blocks_by_raw_events counts blocks of more than {m} top events")
    n_raw = rng.choice(blocks.size, size=n_blocks, p=blocks / blocks.sum())
    positions = rng.integers(0, cfg.num_positions(top), (n_blocks, m))
    raw = cfg.counts[top]
    # a uniform permutation of each block's events: its first n_raw are raw
    singleton = np.argsort(rng.random((n_blocks, m)), axis=1) >= n_raw[:, None]
    atoms = np.where(singleton, raw + rng.integers(0, cfg.channels[top], (n_blocks, m)),
                     rng.integers(0, raw, (n_blocks, m)))
    mags = np.maximum(1, np.floor(maxcode * rng.random((n_blocks, m)) ** 3)).astype(np.int64)
    codes = np.where(rng.random((n_blocks, m)) < 0.5, -mags, mags)
    scales = (rng.uniform(4.0, 8.0, n_blocks) / maxcode).astype(np.float32)
    return positions, atoms, codes, scales


class Client(_RESTORE.Client):
    def __init__(self, run):
        super().__init__(run)
        if run.config.get("form") != "distributed" or self.cfg.num_levels < 2:
            raise ValueError("the restore-levels cell reads a distributed container of 2 or more levels")
        self.summed: list[int | None] = []  # rows summed per level, a call

    def setup(self) -> None:
        from hsc_torch.runtime import CorpusReader

        run = self.run
        cfg = self.cfg
        t0 = time.perf_counter()
        self.path = os.path.join(run.tmp, "restore-levels.hsct")
        events = top_events(cfg, self.n_blocks, run.config["writer"], run.seed)
        lv, _ = levels.native_levels(cfg, events[1])
        # events a level of each block, for the launches
        self.per_level = np.stack([(lv == k).sum(1) for k in range(cfg.num_levels)], 1)
        with open(self.path, "wb") as f:
            levels.write_records(cfg, levels.records_distributed(cfg, *events), f)
        t1 = time.perf_counter()
        self.reader = CorpusReader(self.path, run.port_mld, device=run.device,
                                   batch_size=int(run.config["batch_size"]))
        t2 = time.perf_counter()
        self.starts = _Recorded(traffic.starts(self.n_blocks - self.corpus + 1, run.seed))
        self.per_call = int(run.config["judge"]["blocks_per_call"])
        rows = max(self.per_call, (judge.STORE_MB << 20) // (4 * cfg.block_size))
        self.store = np.ones((rows, cfg.block_size), np.float32)  # touched: no faults in the window
        self.keep = np.random.default_rng(inputs.derived_seed(run.seed, 21))
        t3 = time.perf_counter()
        # warm the cell's one shape: a whole call
        self.reader[0:self.corpus]
        run.synchronize()
        run.log(f"set-up (s): container {t1 - t0:.3f}, reader open {t2 - t1:.3f}, store {t3 - t2:.3f}, "
                f"warm call {time.perf_counter() - t3:.3f}")

    def call(self, keep: bool = False) -> None:
        before = _rows_summed()
        super().call(keep)
        after = _rows_summed()
        self.summed.append(None if before is None or after is None else after - before)

    def window(self, seconds: float, traced_s: float | None) -> None:
        super().window(seconds, traced_s)
        run = self.run
        if run.trace is not None:
            shares = {s: spans.idle_in_span_pct(run, f"hsc:decode.{s}") for s in SPANS}
            run.log(f"traced: {self.traced_calls} calls, card idle {layers.idle_pct(run, run.card_indices)} %, "
                    f"idle in spans (%) {shares}, rows summed per level a block "
                    f"{self.summed_rows_per_block()}")

    def summed_rows_per_block(self) -> float | None:
        """The rows the traced calls summed per level on the host, over the
        blocks they restored; None without a trace or without the count."""
        done = self.summed[:self.traced_calls]
        if not done or any(v is None for v in done):
            return None
        return sum(done) / (len(done) * self.corpus)

    def launches(self) -> dict[str, list[dict]]:
        """Every kernel launch of the traced calls: one a level present in
        each chunk of `batch_size` blocks, over that level's blocks and
        events, at its width and atom count."""
        cfg = self.cfg
        batch = int(self.run.config["batch_size"])
        out = []
        for s in self.starts.seen[:self.traced_calls]:
            for b0 in range(s, s + self.corpus, batch):
                chunk = self.per_level[b0:min(b0 + batch, s + self.corpus)]
                for k in range(cfg.num_levels):
                    held = chunk[:, k] > 0
                    if held.any():
                        out.append(dict(blocks=int(held.sum()), events=int(chunk[:, k].sum()),
                                        width=cfg.scales[k], atoms=cfg.counts_with_singletons[k],
                                        n=cfg.block_size))
        return {"int_decode": out}

    def judge(self, control: bool | str = False) -> dict:
        """The stored rows against the reference's per-level decode; with
        `control` True or ``"top_reps"``, that control's rows put in the
        program's place (module docstring)."""
        with open(self.path, "rb") as f:
            data = f.read()
        cfg, mld = self.cfg, self.run.ref_mld
        mismatch = faults = 0
        for b, i in self.kept:
            faults += levels.stream_faults(cfg, data, b)
            ref = levels.decode_levels(cfg, mld, data, b)
            if control:
                row = levels.decode_levels(cfg, mld, data, b, bfloat16=control is True,
                                           top_reps=control == "top_reps")
            else:
                row = self.store[i]
            mismatch += int(np.count_nonzero(ref.view(np.uint32) != row.view(np.uint32)))
        return {"structure_faults": faults, "rows_mismatch": mismatch, "rows_unjudged": int(not self.kept)}


class _Recorded:
    """An iterator of call starts that keeps the starts it gave."""

    def __init__(self, it):
        self.it = it
        self.seen: list[int] = []

    def __iter__(self):
        return self

    def __next__(self) -> int:
        s = next(self.it)
        self.seen.append(s)
        return s
