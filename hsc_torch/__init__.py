"""hsc_torch — the PyTorch / CUDA port of the hierarchical sparse-coding codec.

The JAX package `hsc_tpu` is the reference; this package is its counterpart
for an NVIDIA Hopper card and mirrors its layout and names:

  device        — explicit device selection and the spec's f32 numerics
  params        — one level's bank, Gram and decode tables as tensors
  ops           — init correlation, greedy loop (plain + CUDA kernel),
                  integer decode (plain + CUDA kernel), batch pipeline
  models        — ConvolutionalMatchingPursuit / ...SparseCoder (nn.Module)
  runtime       — CorpusEncoder: encode -> container -> integer decode

Shared, not ported: `config`, `dictionary`, `signal`, `oracle`, `io` and
`utils` import no JAX, so the port imports them from `hsc_tpu` as they are —
the stream format, the dictionary model and the NumPy spec stay one thing.
Nothing in this package imports JAX.
"""

from hsc_tpu.config import CodecConfig, make_test_config
from hsc_tpu.dictionary import MultilevelDictionary
from hsc_tpu.signal import SignalGenerator

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "make_test_config",
    "MultilevelDictionary",
    "SignalGenerator",
    "CorpusEncoder",
]


def __getattr__(name):
    # lazy, like hsc_tpu: the light surface (config/dictionary/signal) does
    # not pay for importing torch's models and the runtime
    if name == "CorpusEncoder":
        from . import runtime

        return runtime.CorpusEncoder
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
