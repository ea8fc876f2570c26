"""Share of the traced window with the card idle and the host gathering an
encode call's host batches from its blocks: `hsc:encode.gather`
(`hscbench/spans.py`)."""

from hscbench.spans import idle_in_span_pct


def read(run):
    return idle_in_span_pct(run, "hsc:encode.gather")
