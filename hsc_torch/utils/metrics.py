"""Structured per-block metrics — JSONL appended by process 0.

SURVEY.md §5 "Metrics / logging": the reference prints and plots; the rebuild
emits machine-readable per-block records (encode MB/s, coefficients/sample,
achieved SNR, bits/sample) that the bench harness and experiment scripts read
back.

The port's own copy of `hsc_tpu/utils/metrics.py`, verbatim: both packages
write the same records, and tests/test_torch_copies.py holds the copy equal
to the original.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, path: str | None, process_index: int = 0):
        """`path=None` (or nonzero process) disables writing — call sites stay
        unconditional (SPMD-friendly: every process logs, one writes)."""
        self._f = None
        if path is not None and process_index == 0:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, record: dict) -> None:
        if self._f is None:
            return
        record = dict(record)
        record.setdefault("ts", time.time())
        self._f.write(json.dumps(record, sort_keys=True) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_metrics(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
