"""The mp_loop kernel's share of its roofline over the traced launches
(`roofline/mp_loop.py`)."""

from hscbench.layers import roofline_pct


def read(run):
    return roofline_pct(run, "mp_loop")
