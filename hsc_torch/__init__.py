"""hsc_torch — the PyTorch / CUDA port of the hierarchical sparse-coding codec.

The JAX package `hsc_tpu` is the reference; this package is its counterpart
for an NVIDIA Hopper card and mirrors its layout and names:

  device        — explicit device selection and the spec's f32 numerics
  params        — one level's bank, Gram, decode and int8 init tables
  ops           — init correlation, level hand-off maps, greedy loop
                  (`mp_kernels`), int8 level >= 1 init (`init_kernels`),
                  integer decode (`decode_integer_kernel`), ordered decode
                  (`decode_kernel`) — each kernel wrapper beside its plain
                  PyTorch version — and the batch and level pipelines
  models        — ConvolutionalMatchingPursuit / ...SparseCoder and the
                  multi-level HierarchicalConvolutionalSparseCoder (nn.Module)
  runtime       — CorpusEncoder: the hierarchy's encode -> container ->
                  decode, both decode modes, top-only or distributed, the
                  seek index and random-access decode, constant bitrate,
                  the resume journal and multi-process shards; CorpusReader
                  serves rows of a container file
  learn         — dictionary learning: spherical k-means on the device
                  (`kmeans`), the multilevel trainer and its resume journal
                  (`trainer`), the online learner, whose overlap-add is the
                  ordered-decode kernel with a hand-written gradient
                  (`online`), and npz checkpoints (`checkpoint`)
  parallel      — a device mesh of one process (devices may repeat),
                  the data-parallel codec, sequence- and tensor-parallel
                  encode of one long block, and distributed k-means
  analysis      — rate accounting, rate-distortion curves and per-level
                  diagnostics
  cli           — the command-line codec (`python -m hsc_torch.cli`,
                  `hsc-torch-codec`): encode, decode, info, learn, assemble

The port keeps its own copies of the JAX package's NumPy modules, verbatim:
`config`, `dictionary`, `signal`, `oracle` (the NumPy spec), `io` (the
container format, its native packer `csrc/bitpack.cpp`, and the encode
journal) and `utils` (`normalize`, `snr_db`, and `metrics`).  tests/test_torch_copies.py holds each equal to its
original.  Nothing in this package imports JAX or `hsc_tpu`; a JAX
package's dictionary crosses over through `params.dictionary_from_arrays`.
"""

from .config import CodecConfig, make_test_config
from .dictionary import MultilevelDictionary
from .signal import SignalGenerator

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "make_test_config",
    "MultilevelDictionary",
    "SignalGenerator",
    "CorpusEncoder",
    "CorpusReader",
]


def __getattr__(name):
    # lazy, like hsc_tpu: the light surface (config/dictionary/signal) does
    # not pay for importing torch's models and the runtime
    if name in ("CorpusEncoder", "CorpusReader"):
        from . import runtime

        return getattr(runtime, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
