"""Share of the traced window with the card idle and the host unpacking a
chunk's blocks from the container: `hsc:decode.unpack`
(`hscbench/spans.py`)."""

from hscbench.spans import idle_in_span_pct


def read(run):
    return idle_in_span_pct(run, "hsc:decode.unpack")
