"""Share of the traced window with the card idle and the host assembling an
encode call's container: `hsc:encode.assemble` (`hscbench/spans.py`)."""

from hscbench.spans import idle_in_span_pct


def read(run):
    return idle_in_span_pct(run, "hsc:encode.assemble")
