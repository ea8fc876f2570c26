"""Share of the traced window with the card idle and the host summing a
distributed chunk per level (the zeroing of its rows, each level's adds):
`hsc:decode.levelsum` (`hscbench/spans.py`); None in a program without the
span."""

from hscbench.spans import idle_in_span_pct


def read(run):
    return idle_in_span_pct(run, "hsc:decode.levelsum")
