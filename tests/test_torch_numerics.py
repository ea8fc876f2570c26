"""The spec's float32 numerics are pinned at each op, not once per process.

The JAX package pins its init conv to `Precision.HIGHEST` at the op; the
port enters `hsc_torch.device.spec_numerics` around the init correlation,
the two k-means products and the online learner's backward product.  Here,
on the CPU, each global precision flag a caller may set is flipped in turn
(oneDNN convolutions on bf16, oneDNN matmuls on bf16,
`torch.set_float32_matmul_precision('medium')`, and the new-API CUDA matmul
flag on TF32), and a freshly built codec, k-means learner and online learner
must give the same container bytes and the same banks, bit for bit, as under
the default flags.  After each run every flag, `cudnn.deterministic` and
`cudnn.benchmark` included, must still read what the caller set.

The geometry: 16 atoms of width 32, 2048-sample blocks, 64 coefficients,
num_select 4, dictionary seed 7, `SignalGenerator(rates=2e-2)` seed 3; 8
blocks for the codec and the online step, 16 for the k-means learner (1024
windows, 10 iterations).

On a CPU without bf16 support (`torch.ops.mkldnn._is_mkldnn_bf16_supported()`
is False) oneDNN ignores the bf16 flags, so the flips change nothing and the
flip cases pass without checking anything; `test_a_bf16_flip_moves_an_unpinned_conv`
shows whether they check something on this host, and skips where they
cannot.  The TF32 flags act only on a card: their case there is
`tests/test_torch_kernels.py::test_tf32_flags_change_no_output`.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
from hsc_torch.device import resolve_device, spec_numerics
from hsc_torch.learn import ConvolutionalDictionaryLearner, OnlineConvolutionalDictionaryLearner
from hsc_torch.runtime import CorpusEncoder

B = torch.backends
# every flag `spec_numerics` sets, read through the API that cannot raise
FLAGS = {
    "cudnn.conv.fp32_precision": (B.cudnn.conv, "fp32_precision"),
    "cuda.matmul.fp32_precision": (B.cuda.matmul, "fp32_precision"),
    "mkldnn.conv.fp32_precision": (B.mkldnn.conv, "fp32_precision"),
    "mkldnn.matmul.fp32_precision": (B.mkldnn.matmul, "fp32_precision"),
    "cudnn.deterministic": (B.cudnn, "deterministic"),
    "cudnn.benchmark": (B.cudnn, "benchmark"),
}
FLIPS = {
    "mkldnn_conv_bf16": lambda: setattr(B.mkldnn.conv, "fp32_precision", "bf16"),
    "mkldnn_matmul_bf16": lambda: setattr(B.mkldnn.matmul, "fp32_precision", "bf16"),
    "matmul_precision_medium": lambda: torch.set_float32_matmul_precision("medium"),
    "cuda_matmul_tf32": lambda: setattr(B.cuda.matmul, "fp32_precision", "tf32"),
}
CFG = dict(counts=(16,), scales=(32,), block_size=2048, num_coefs=(64,), num_select=4)


def read_flags() -> dict:
    return {name: getattr(obj, attr) for name, (obj, attr) in FLAGS.items()}


@pytest.fixture
def restore_flags():
    """Gives every flag back its value once the test ends, the legacy
    matmul precision first (it moves the matmul leaves)."""
    legacy, saved = torch.get_float32_matmul_precision(), read_flags()
    yield
    torch.set_float32_matmul_precision(legacy)
    for name, (obj, attr) in FLAGS.items():
        setattr(obj, attr, saved[name])
    assert torch.get_float32_matmul_precision() == legacy and read_flags() == saved


@pytest.fixture(scope="module")
def corpus():
    mld = MultilevelDictionary.generate(make_test_config(**CFG), seed=7)
    xs = SignalGenerator(mld, rates=2e-2).generate_signals(16, mld.config.block_size, seed=3)
    return mld, xs


def run_all(mld, xs) -> dict:
    """The three spec-critical paths, each built afresh: the codec's
    container, the k-means bank, the bank after one online step."""
    blob = CorpusEncoder(mld, device="cpu").encode(xs[:8])
    learned = ConvolutionalDictionaryLearner(16, 32, num_windows=1024, iterations=10, device="cpu").train(
        xs[:, :, None])
    rng = np.random.default_rng(11)
    bank0 = rng.standard_normal((16, 32, 1)).astype(np.float32)
    bank0 /= np.linalg.norm(bank0, axis=(1, 2), keepdims=True)
    online = OnlineConvolutionalDictionaryLearner(bank0, num_coefs=64, device="cpu")
    loss = online.step(xs[:8])
    return {"blob": blob, "learned": learned, "online": online.bank.detach().numpy().copy(), "loss": loss}


@pytest.fixture(scope="module")
def reference(corpus):
    """Every path under torch's default flags."""
    return run_all(*corpus)


@pytest.mark.parametrize("flip", sorted(FLIPS))
def test_flag_flip_changes_no_output(flip, corpus, reference, restore_flags):
    FLIPS[flip]()
    before = read_flags()
    got = run_all(*corpus)
    assert got["blob"] == reference["blob"], f"container bytes moved under {flip}"
    assert np.array_equal(got["learned"], reference["learned"]), f"k-means bank moved under {flip}"
    assert np.array_equal(got["online"], reference["online"]), f"online bank moved under {flip}"
    assert got["loss"] == reference["loss"]
    assert read_flags() == before, "an encode or a learner left a flag changed"


def test_callers_cudnn_flags_survive(corpus, restore_flags):
    """Building the coder, encoding, learning: `cudnn.deterministic` and
    `cudnn.benchmark` read what the caller set, before and after."""
    mld, xs = corpus
    for det, bench in ((False, True), (True, False), (False, False)):
        B.cudnn.deterministic, B.cudnn.benchmark = det, bench
        before = read_flags()
        resolve_device("cpu")
        run_all(mld, xs)
        assert read_flags() == before == {**before, "cudnn.deterministic": det, "cudnn.benchmark": bench}


def test_spec_numerics_sets_and_restores(restore_flags):
    """Inside: IEEE float32 everywhere, cuDNN deterministic and not
    benchmarked; after a normal exit and after an exception: the caller's
    values, also when the caller used the new API (reading the legacy
    `allow_tf32` would raise then, so it is never read)."""
    B.cuda.matmul.fp32_precision = "tf32"
    B.mkldnn.conv.fp32_precision = "bf16"
    B.cudnn.benchmark = True
    before = read_flags()
    with spec_numerics():
        assert read_flags() == {
            "cudnn.conv.fp32_precision": "ieee", "cuda.matmul.fp32_precision": "ieee",
            "mkldnn.conv.fp32_precision": "ieee", "mkldnn.matmul.fp32_precision": "ieee",
            "cudnn.deterministic": True, "cudnn.benchmark": False,
        }
        with spec_numerics():  # nested: the outer scope's values come back
            pass
        assert read_flags()["mkldnn.conv.fp32_precision"] == "ieee"
    assert read_flags() == before
    with pytest.raises(ZeroDivisionError):
        with spec_numerics():
            1 / 0
    assert read_flags() == before


def test_a_bf16_flip_moves_an_unpinned_conv(corpus, restore_flags):
    """The flips above check something on this host: outside the scope the
    init conv under oneDNN bf16 differs from IEEE float32, inside it does
    not.  Skips on a CPU without bf16, where the flips cannot move anything."""
    if not torch.ops.mkldnn._is_mkldnn_bf16_supported():
        pytest.skip("this CPU has no bf16: oneDNN ignores the bf16 flags")
    mld, xs = corpus
    x = torch.from_numpy(xs[:2, None, :].copy())
    w = torch.from_numpy(mld.augmented(0).transpose(0, 2, 1).copy())
    with spec_numerics():
        exact = F.conv1d(x, w)
    B.mkldnn.conv.fp32_precision = "bf16"
    assert not torch.equal(F.conv1d(x, w), exact)
    with spec_numerics():
        assert torch.equal(F.conv1d(x, w), exact)
