"""The program's own spans (`hsc:<path>.<stage>`, `hsc_torch/runtime.py`)
against the cards' idle time, in the traced stretch of a window.

A span's share is the part of the traced window during which no card of
the cell is busy (no kernel, copy or fill under way: `profile.Trace`) and
the host is inside a span of that name, in %.  The spans are clipped to
the window and merged first, so nested or repeated spans count once.
The spans of one path are disjoint, so a cell's shares add up to the part
of its idle time that falls inside the program.
"""

from __future__ import annotations

from hscbench.profile import merged


def idle_intervals(trace, cards: list[int]) -> list[tuple[float, float]]:
    """The window's intervals in which none of `cards` is busy."""
    by = trace.cards()
    busy = merged([s for c in cards for s in by.get(c, [])])
    out, prev = [], trace.t0
    for lo, hi in busy:
        if lo > prev:
            out.append((prev, lo))
        prev = max(prev, hi)
    if trace.t1 > prev:
        out.append((prev, trace.t1))
    return out


def span_intervals(trace, name: str) -> list[tuple[float, float]] | None:
    """The host spans named `name`, clipped to the window and merged; None
    where the trace holds no such span at all (a program without it)."""
    found = [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in trace.host_ops
        if e["cat"] == "user_annotation" and e["name"] == name
    ]
    if not found:
        return None
    return merged([(max(lo, trace.t0), min(hi, trace.t1)) for lo, hi in found if hi > trace.t0 and lo < trace.t1])


def overlap(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """Length of the intersection of two lists of disjoint, ordered intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_span_pct(run, name: str) -> float | None:
    """% of the traced window with the cell's cards idle and the host in
    `name`; None without a trace or without any span of that name."""
    trace = run.trace
    if trace is None or trace.t1 <= trace.t0:
        return None
    spans = span_intervals(trace, name)
    if spans is None:
        run.log(f"no {name!r} span in the trace: not read")
        return None
    return 100.0 * overlap(idle_intervals(trace, run.card_indices), spans) / (trace.t1 - trace.t0)
