"""Guards of the port: it never imports JAX, never drifts to the CPU, never
falls back from a kernel, and refuses what it does not run yet."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from hsc_tpu import MultilevelDictionary, SignalGenerator, make_test_config

import hsc_torch._build
from hsc_torch.device import resolve_device
from hsc_torch.ops import decode_integer_kernel, decode_kernel, init_kernels, mp_kernels
from hsc_torch.runtime import CorpusEncoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    """A fresh interpreter imports the port and runs tiny CPU encodes and
    decodes (one level; two levels, ordered, distributed) without JAX ever
    entering sys.modules."""
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
        cfg2 = make_test_config(block_size=256, num_coefs=(16, 8), counts=(8, 4), scales=(8, 24),
                                decode_mode="ordered")
        codec2 = CorpusEncoder(MultilevelDictionary.generate(cfg2, seed=1), device="cpu",
                               distributed=True)
        assert codec2.decode(codec2.encode(xs)).shape == (2, 256)
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


def _launches():
    return (mp_kernels.LAUNCHES, decode_integer_kernel.LAUNCHES, init_kernels.LAUNCHES,
            decode_kernel.LAUNCHES)


def test_cpu_path_launches_no_kernel(mld1, mld2):
    """CPU tensors take the plain versions: the four launch counters stay
    put through single-level and 2-level (int8 init) encodes and decodes in
    both modes."""
    before = _launches()
    for mld in (mld1, mld2):
        xs = SignalGenerator(mld, rates=4e-3).generate_signals(2, mld.config.block_size, seed=71)
        for mode in ("integer", "ordered"):
            cfg = dataclasses.replace(mld.config, decode_mode=mode)
            codec = CorpusEncoder(MultilevelDictionary.generate(cfg, seed=7), device="cpu", backend="auto")
            codec.decode(codec.encode(xs))
    assert mld2.config.hier_init == "int8"
    assert _launches() == before
    if not torch.cuda.is_available():
        assert before == (0, 0, 0, 0)


@pytest.mark.parametrize(
    "what",
    ["journal_dir", "target_bps", "mesh", "index", "indices"],
)
def test_unported_options_raise(mld1, tmp_path, what):
    cfg = mld1.config
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(1, cfg.block_size, seed=73)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "journal_dir":
            CorpusEncoder(mld1, device="cpu", journal_dir=str(tmp_path))
        elif what == "target_bps":
            CorpusEncoder(mld1, device="cpu", target_bps=2.0)
        elif what == "mesh":
            CorpusEncoder(mld1, device="cpu", mesh=object())
        elif what == "index":
            CorpusEncoder(mld1, device="cpu").encode(xs, index=True)
        else:
            codec = CorpusEncoder(mld1, device="cpu")
            next(codec.decode_stream(codec.encode(xs), indices=[0]))
