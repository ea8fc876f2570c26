"""Mean over the cell's cards of the share of the traced window with that card
idle and the host enqueueing every shard's init: `hsc:mesh.init`
(`hscbench/mesh_spans.py`)."""

from hscbench.mesh_spans import idle_in_span_per_card_pct


def read(run):
    return idle_in_span_per_card_pct(run, "hsc:mesh.init")
