"""The int8_init kernel's share of its roofline over the traced launches
(`roofline/int8_init.py`)."""

from hscbench.layers import roofline_pct


def read(run):
    return roofline_pct(run, "int8_init")
