"""Whole runs on the CPU at a tiny geometry with the timed path broken
underneath: each fault a cell can have must turn `correct` false.

- a step that returns its state unchanged: the greedy loop's events never
  written (every block empty); the decode's rows never written (zeros);
- half of the batch left out: the second half of every batch answered
  with the first half's results;
- an answer altered where it is produced: one event's code in every block
  off by one; one value of every decoded chunk changed.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_bench_harness import bench_run, tiny  # noqa: E402,F401


def _streams(transform):
    import hsc_torch.runtime as runtime

    real = runtime.level_streams

    def broken(enc):
        return transform(real(enc))

    return broken


def _empty(streams):
    from hsc_torch.oracle.mp import LevelStream

    z = np.zeros(0, np.int32)
    return [LevelStream(z, z, z, s.scale, s.energy0, s.energy_res) for s in streams]


def _half(streams):
    h = len(streams) // 2
    return streams[:h] + [streams[i % max(h, 1)] for i in range(len(streams) - h)] if h else streams


def _altered(streams):
    out = []
    for s in streams:
        codes = s.codes.copy()
        if codes.size:
            j = codes.size // 2
            codes[j] += 1 if codes[j] > 0 else -1
        out.append(type(s)(s.positions, s.atoms, codes, s.scale, s.energy0, s.energy_res))
    return out


ENCODE_FAULTS = {"unchanged": _empty, "half": _half, "altered": _altered}


@pytest.mark.parametrize("cell", ["fi", "hi"])
@pytest.mark.parametrize("fault", sorted(ENCODE_FAULTS))
def test_an_encode_fault_is_not_correct(tiny, monkeypatch, cell, fault):  # noqa: F811
    import hsc_torch.runtime as runtime

    monkeypatch.setattr(runtime, "level_streams", _streams(ENCODE_FAULTS[fault]))
    r = bench_run.execute(tiny, cell, 424242, 0.4, False, device="cpu")
    assert not r["correct"], r["checks"]


def _chunks(transform):
    import hsc_torch.runtime as runtime

    real = runtime.CorpusEncoder._decode_chunks

    def broken(self, *args, **kwargs):
        for chunk in real(self, *args, **kwargs):
            yield transform(np.array(chunk))

    return broken


def _zeros(chunk):
    return np.zeros_like(chunk)


def _half_rows(chunk):
    h = chunk.shape[0] // 2
    if h:
        chunk[h:] = chunk[np.arange(chunk.shape[0] - h) % h]
    return chunk


def _altered_row(chunk):
    chunk[0, chunk.shape[1] // 2] += 1.0
    return chunk


DECODE_FAULTS = {"unchanged": _zeros, "half": _half_rows, "altered": _altered_row}


@pytest.mark.parametrize("fault", sorted(DECODE_FAULTS))
def test_a_decode_fault_is_not_correct(tiny, monkeypatch, fault):  # noqa: F811
    import hsc_torch.runtime as runtime

    monkeypatch.setattr(runtime.CorpusEncoder, "_decode_chunks", _chunks(DECODE_FAULTS[fault]))
    r = bench_run.execute(tiny, "fr", 616161, 0.4, False, device="cpu")
    assert not r["correct"], r["checks"]
