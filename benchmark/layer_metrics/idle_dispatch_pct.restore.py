"""Share of the traced window with the card idle and the host dispatching a
decode unit (padding, uploads, launch, the copy-back's start):
`hsc:decode.dispatch` (`hscbench/spans.py`)."""

from hscbench.spans import idle_in_span_pct


def read(run):
    return idle_in_span_pct(run, "hsc:decode.dispatch")
