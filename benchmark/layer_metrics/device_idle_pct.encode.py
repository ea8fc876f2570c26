"""Idle share of the traced window on the cell's card, in an ingest cell."""

from hscbench.layers import idle_pct


def read(run):
    return idle_pct(run, run.card_indices)
