"""Share of the traced window with the card idle and the host stacking a
slice's rows: `hsc:decode.stack` (`hscbench/spans.py`)."""

from hscbench.spans import idle_in_span_pct


def read(run):
    return idle_in_span_pct(run, "hsc:decode.stack")
