"""Rate accounting and per-level diagnostics — the port's counterpart of
`hsc_tpu.analysis`, with the same exports."""

from .rates import (
    bits_for_dtype,
    stream_rate,
    corpus_rates,
    multilevel_information_rates,
    rate_distortion_curve,
    hierarchical_rate_distortion_curve,
    decode_mode_fidelity,
    visualize_rate_distortion,
)
from .diagnostics import (
    level_energies,
    coefficient_distribution,
    visualize_level_diagnostics,
)

__all__ = [
    "bits_for_dtype",
    "stream_rate",
    "corpus_rates",
    "multilevel_information_rates",
    "rate_distortion_curve",
    "hierarchical_rate_distortion_curve",
    "decode_mode_fidelity",
    "visualize_rate_distortion",
    "level_energies",
    "coefficient_distribution",
    "visualize_level_diagnostics",
]
