"""Share of the traced window with the card idle and the host trimming and
bit-packing a batch and journaling its records: `hsc:encode.pack`
(`hscbench/spans.py`)."""

from hscbench.spans import idle_in_span_pct


def read(run):
    return idle_in_span_pct(run, "hsc:encode.pack")
