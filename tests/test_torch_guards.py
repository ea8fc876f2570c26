"""Guards of the port: it never imports JAX, never drifts to the CPU, never
falls back from a kernel, and refuses what this slice does not run."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from hsc_tpu import MultilevelDictionary, SignalGenerator, make_test_config

import hsc_torch._build
from hsc_torch.device import resolve_device
from hsc_torch.models import ConvolutionalMatchingPursuit
from hsc_torch.ops import decode_integer_kernel, mp_kernels
from hsc_torch.runtime import CorpusEncoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    """A fresh interpreter imports the port and runs a tiny CPU encode and
    decode without JAX ever entering sys.modules."""
    code = textwrap.dedent(
        """
        import sys
        import hsc_torch, hsc_torch.models, hsc_torch.runtime
        from hsc_torch import CorpusEncoder, MultilevelDictionary, SignalGenerator, make_test_config
        cfg = make_test_config(block_size=256, num_coefs=(16,), counts=(8,), scales=(8,))
        mld = MultilevelDictionary.generate(cfg, seed=1)
        xs = SignalGenerator(mld, rates=4e-3).generate_signals(2, cfg.block_size, seed=2)
        codec = CorpusEncoder(mld, device="cpu")
        rows = codec.decode(codec.encode(xs))
        assert rows.shape == (2, 256)
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        CorpusEncoder(MultilevelDictionary.generate(make_test_config(), seed=7), device="cuda")


def test_backend_cuda_needs_a_cuda_device(mld1):
    with pytest.raises(ValueError, match="CUDA device"):
        CorpusEncoder(mld1, device="cpu", backend="cuda")


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(hsc_torch._build.shutil, "which", lambda _: None)
    monkeypatch.setattr(hsc_torch._build, "_TOOLKIT_NVCC", os.path.join(REPO, "no-such-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        hsc_torch._build._nvcc()


def test_cpu_path_launches_no_kernel(mld1):
    """CPU tensors take the plain versions: both launch counters stay put
    through a whole encode and decode."""
    before = (mp_kernels.LAUNCHES, decode_integer_kernel.LAUNCHES)
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(2, mld1.config.block_size, seed=71)
    codec = CorpusEncoder(mld1, device="cpu", backend="auto")
    codec.decode(codec.encode(xs))
    assert (mp_kernels.LAUNCHES, decode_integer_kernel.LAUNCHES) == before
    if not torch.cuda.is_available():
        assert before == (0, 0)


@pytest.mark.parametrize(
    "what",
    ["journal_dir", "target_bps", "distributed", "mesh", "index", "indices",
     "two_levels", "ordered_decode", "int8_init"],
)
def test_unported_options_raise(mld1, mld2, tmp_path, what):
    cfg = mld1.config
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(1, cfg.block_size, seed=73)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "journal_dir":
            CorpusEncoder(mld1, device="cpu", journal_dir=str(tmp_path))
        elif what == "target_bps":
            CorpusEncoder(mld1, device="cpu", target_bps=2.0)
        elif what == "distributed":
            CorpusEncoder(mld1, device="cpu", distributed=True)
        elif what == "mesh":
            CorpusEncoder(mld1, device="cpu", mesh=object())
        elif what == "index":
            CorpusEncoder(mld1, device="cpu").encode(xs, index=True)
        elif what == "indices":
            codec = CorpusEncoder(mld1, device="cpu")
            next(codec.decode_stream(codec.encode(xs), indices=[0]))
        elif what == "two_levels":
            CorpusEncoder(mld2, device="cpu")
        elif what == "ordered_decode":
            ordered = make_test_config(decode_mode="ordered")
            mld = MultilevelDictionary.generate(ordered, seed=7)
            codec = CorpusEncoder(mld, device="cpu")
            codec.decode(codec.encode(xs))
        else:
            ConvolutionalMatchingPursuit(
                mld1.augmented(0), mld1.gram(0), num_coefs=8, int8_init=True, device="cpu"
            )
