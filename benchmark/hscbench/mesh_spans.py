"""The program's spans against each card's own idle time, for a cell on
several cards (`hscbench/spans.py` reads the time no card is busy).

A span's share is the mean over the cell's cards of the part of the traced
window in which that card is idle (no kernel, copy or fill of its own under
way: `profile.Trace`) and the host is inside a span of that name, in %.  A
card that idles while another works counts here and not in `spans.py`'s
share; on one card the two are the same.  The spans of one path are
disjoint, so a cell's shares add up to no more than its mean idle share.
"""

from __future__ import annotations

from hscbench.spans import idle_intervals, overlap, span_intervals


def idle_in_span_by_card_pct(run, name: str) -> list[float] | None:
    """For each of the cell's cards, % of the traced window with that card
    idle and the host in `name`; None without a trace or without any span
    of that name."""
    trace = run.trace
    if trace is None or trace.t1 <= trace.t0:
        return None
    spans = span_intervals(trace, name)
    if spans is None:
        run.log(f"no {name!r} span in the trace: not read")
        return None
    return [100.0 * overlap(idle_intervals(trace, [c]), spans) / (trace.t1 - trace.t0) for c in run.card_indices]


def idle_in_span_per_card_pct(run, name: str) -> float | None:
    """The mean over the cell's cards of `idle_in_span_by_card_pct`."""
    shares = idle_in_span_by_card_pct(run, name)
    return None if shares is None else sum(shares) / len(shares)
