"""Share of the traced window with the card idle and the host in the encode
pipeline, from the first upload to the events on the host:
`hsc:encode.pipeline` (`hscbench/spans.py`)."""

from hscbench.spans import idle_in_span_pct


def read(run):
    return idle_in_span_pct(run, "hsc:encode.pipeline")
