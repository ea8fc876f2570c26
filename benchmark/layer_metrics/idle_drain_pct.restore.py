"""Share of the traced window with the card idle and the host draining a
decode unit (the copy's wait, the copy out of pinned memory, the host sum):
`hsc:decode.drain` (`hscbench/spans.py`)."""

from hscbench.spans import idle_in_span_pct


def read(run):
    return idle_in_span_pct(run, "hsc:decode.drain")
