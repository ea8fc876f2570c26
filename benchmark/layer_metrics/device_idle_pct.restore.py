"""Idle share of the traced window on the cell's card, in a restore cell."""

from hscbench.layers import idle_pct


def read(run):
    return idle_pct(run, run.card_indices)
