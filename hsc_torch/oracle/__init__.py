"""NumPy oracle — the executable specification of the codec.

This package is the behavioral contract that "bit-exact decode" is measured
against (SURVEY.md §7 risk R1): the TPU
path must produce streams that decode — on any backend — to exactly the bytes
this oracle's decoder produces.

The port's own copy of `hsc_tpu/oracle/__init__.py`: the container bytes and
the NumPy spec depend on this code, so it is copied verbatim, quirks
included, and tests/test_torch_copies.py holds it equal to the original.
"""

from .mp import (
    correlate_bank,
    mp_encode,
    mp_decode,
    hierarchical_encode,
    hierarchical_decode,
    feature_map_from_events,
    to_distributed,
    to_top_level,
)

__all__ = [
    "correlate_bank",
    "mp_encode",
    "mp_decode",
    "hierarchical_encode",
    "hierarchical_decode",
    "feature_map_from_events",
    "to_distributed",
    "to_top_level",
]
