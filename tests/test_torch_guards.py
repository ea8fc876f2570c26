"""Guards of the port: it never imports JAX or the JAX package, never drifts
to the CPU, never falls back from a kernel, and every surface that takes a
mesh runs with one."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import hsc_torch._build
import hsc_torch.cli
from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
from hsc_torch.device import resolve_device
from hsc_torch.learn import ConvolutionalDictionaryLearner, MultilevelTrainer, OnlineConvolutionalDictionaryLearner
from hsc_torch.models import HierarchicalConvolutionalSparseCoder
from hsc_torch.ops import decode_integer_kernel, decode_kernel, init_kernels, mp_kernels
from hsc_torch.params import dictionary_from_arrays
from hsc_torch.parallel import make_mesh
from hsc_torch.runtime import CorpusEncoder, CorpusReader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port_mld1(mld1):
    return dictionary_from_arrays(mld1.config.to_json(), mld1.dicts)


@pytest.fixture(scope="module")
def port_mld2(mld2):
    return dictionary_from_arrays(mld2.config.to_json(), mld2.dicts)


def test_port_never_imports_jax():
    """A fresh interpreter imports the port and runs tiny CPU encodes and
    decodes (one level; two levels, ordered, distributed) and a two-level
    `learn` through the CLI without JAX, optax, orbax or any module of the
    JAX package `hsc_tpu` ever entering sys.modules."""
    code = textwrap.dedent(
        """
        import os, sys, tempfile
        import numpy as np
        import hsc_torch, hsc_torch.models, hsc_torch.runtime, hsc_torch.analysis, hsc_torch.learn
        import hsc_torch.cli
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
        d = tempfile.mkdtemp()
        np.save(os.path.join(d, "x.npy"), xs.reshape(-1))
        hsc_torch.cli.main(["learn", "--input", os.path.join(d, "x.npy"), "--output", os.path.join(d, "l.npz"),
                            "--counts", "6,4", "--scales", "8,24", "--block-size", "256",
                            "--learn-coefs", "16,8", "--num-windows", "64", "--iterations", "2",
                            "--device", "cpu"])
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "hsc_tpu", "optax", "orbax"))
        assert not loaded, loaded
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


def _imported_roots(path):
    """Top-level package names of every import statement in a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "hsc_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py"])
def test_no_jax_package_import_in_source(path):
    """No file of the port and no line of chip_smoke.py imports `hsc_tpu`,
    `jax`, `jaxlib`, `optax` or `orbax`, at module level or inside a
    function."""
    assert not _imported_roots(os.path.join(REPO, path)) & {"hsc_tpu", "jax", "jaxlib", "optax", "orbax"}


def test_jax_package_dictionary_is_refused(mld1, port_mld1):
    """The port's entry points take the port's own dictionary; a JAX package
    one crosses over through `dictionary_from_arrays`."""
    with pytest.raises(TypeError, match="dictionary_from_arrays"):
        CorpusEncoder(mld1, device="cpu")
    with pytest.raises(TypeError, match="dictionary_from_arrays"):
        HierarchicalConvolutionalSparseCoder(mld1, device="cpu")
    assert CorpusEncoder(port_mld1, device="cpu").cfg.to_json() == mld1.config.to_json()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        CorpusEncoder(MultilevelDictionary.generate(make_test_config(), seed=7), device="cuda")


def test_backend_cuda_needs_a_cuda_device(port_mld1):
    with pytest.raises(ValueError, match="CUDA device"):
        CorpusEncoder(port_mld1, device="cpu", backend="cuda")


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(hsc_torch._build.shutil, "which", lambda _: None)
    monkeypatch.setattr(hsc_torch._build, "_TOOLKIT_NVCC", os.path.join(REPO, "no-such-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        hsc_torch._build._nvcc()


def _launches():
    return (mp_kernels.LAUNCHES, decode_integer_kernel.LAUNCHES, init_kernels.LAUNCHES,
            decode_kernel.LAUNCHES)


def test_cpu_path_launches_no_kernel(port_mld1, port_mld2):
    """CPU tensors take the plain versions: the four launch counters stay
    put through single-level and 2-level (int8 init) encodes and decodes in
    both modes."""
    before = _launches()
    for mld in (port_mld1, port_mld2):
        xs = SignalGenerator(mld, rates=4e-3).generate_signals(2, mld.config.block_size, seed=71)
        for mode in ("integer", "ordered"):
            cfg = dataclasses.replace(mld.config, decode_mode=mode)
            codec = CorpusEncoder(MultilevelDictionary.generate(cfg, seed=7), device="cpu", backend="auto")
            codec.decode(codec.encode(xs))
    assert port_mld2.config.hier_init == "int8"
    assert _launches() == before
    if not torch.cuda.is_available():
        assert before == (0, 0, 0, 0)


@pytest.mark.parametrize("what", ["mesh", "reader_mesh", "learner_mesh", "trainer_mesh", "online_mesh",
                                  "cli_mesh"])
def test_mesh_surfaces_run(port_mld1, tmp_path, what):
    """Every entry point that takes a mesh runs with one: here a 2-shard
    mesh of the CPU, with the local path's result where it is bitwise
    (containers, rows) and the right shapes where learning is held to a
    tolerance (tests/test_torch_parallel_runtime.py holds those)."""
    mld1 = port_mld1
    cfg = mld1.config
    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(3, cfg.block_size, seed=73)
    local = CorpusEncoder(mld1, device="cpu")
    blob = local.encode(xs)
    if what == "mesh":
        codec = CorpusEncoder(mld1, device="cpu", mesh=mesh, journal_dir=str(tmp_path / "j"))
        assert codec.encode(xs) == blob
        assert codec.decode(blob).tobytes() == local.decode(blob).tobytes()
    elif what == "reader_mesh":
        path = tmp_path / "c.hsct"
        path.write_bytes(blob)
        with CorpusReader(str(path), mld1, device="cpu", mesh=mesh) as reader:
            assert np.stack(list(reader.rows())).tobytes() == local.decode(blob).tobytes()
    elif what == "learner_mesh":
        d = ConvolutionalDictionaryLearner(4, 8, num_windows=64, iterations=3, device="cpu").train(xs, mesh=mesh)
        assert d.shape == (4, 8, 1) and np.allclose(np.linalg.norm(d.reshape(4, -1), axis=1), 1.0, atol=1e-5)
    elif what == "trainer_mesh":
        learned = MultilevelTrainer(cfg, num_windows=64, iterations=2, checkpoint_dir=str(tmp_path / "j"),
                                    mesh=mesh, device="cpu").train(xs)
        assert [d.shape for d in learned.dicts] == [d.shape for d in mld1.dicts]
    elif what == "online_mesh":
        learner = OnlineConvolutionalDictionaryLearner(mld1.dicts[0], num_coefs=16, mesh=mesh, device="cpu")
        assert np.isfinite(learner.step(xs[:2])) and learner.step_count == 1
    else:
        mld1.save(str(tmp_path / "d.npz"))
        np.save(tmp_path / "x.npy", xs.reshape(-1))
        hsc_torch.cli.main(["encode", "--dict", str(tmp_path / "d.npz"), "--input", str(tmp_path / "x.npy"),
                            "--output", str(tmp_path / "c.hsct"), "--mesh", "2", "--device", "cpu"])
        assert (tmp_path / "c.hsct").read_bytes() == blob


@pytest.mark.cuda
def test_cli_mesh_past_the_visible_cards(port_mld1, tmp_path):
    """`--mesh N --device cuda` with N past the visible cards exits naming
    them, before it writes anything."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    port_mld1.save(str(tmp_path / "d.npz"))
    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit, match=f"only {n - 1} device\\(s\\) visible"):
        hsc_torch.cli.main(["encode", "--dict", str(tmp_path / "d.npz"), "--input", "x.npy",
                            "--output", str(tmp_path / "c.hsct"), "--mesh", str(n), "--device", "cuda"])
    assert not (tmp_path / "c.hsct").exists()