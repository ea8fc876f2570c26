"""The int_decode kernel's share of its roofline over the traced launches
(`roofline/int_decode.py`)."""

from hscbench.layers import roofline_pct


def read(run):
    return roofline_pct(run, "int_decode")
