"""The port's command-line codec (`hsc_torch.cli`) against the JAX package's
(`hsc_tpu.cli`) on the CPU, both run in-process.

Mirrors tests/test_cli.py; its mesh round trip is in
tests/test_torch_parallel_runtime.py, and here `--mesh` past the visible
cards exits as the JAX CLI does.  With JAX's level-0 init injected, `encode`
writes byte-identical containers and `learn --algorithm samples` the same
dictionary arrays; `decode` gives rows bitwise JAX's with no injection
(decoding is bitwise in the spec); `info` prints the same JSON; `assemble`
gives the same bytes from one journal directory.  Every port call passes
`--device cpu` but one, which shows that with no `--device` the CLI asks for
the card and exits on a host without one."""

import json
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsc_tpu.cli as jax_cli
import hsc_tpu.utils.cache
from hsc_tpu import SignalGenerator
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.signal import save_wav

import hsc_torch.cli as port_cli
import hsc_torch.models.coder
import hsc_torch.ops.pipeline
from hsc_torch import MultilevelDictionary
from hsc_torch.analysis import corpus_rates
from hsc_torch.io import iter_blocks, peek_corpus_header
from hsc_torch.io.journal import EncodeJournal
from hsc_torch.runtime import _journal_name


@pytest.fixture(scope="module")
def cli_fixture(tmp_path_factory, mld1):
    d = tmp_path_factory.mktemp("cli")
    mld1.save(str(d / "dict.npz"))
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(3, mld1.config.block_size, seed=55)
    np.save(d / "sig.npy", x.reshape(-1))
    return d


@pytest.fixture
def inject(monkeypatch):
    """JAX's level-0 init wherever the port looks up `encode_init_batched`."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    for module in (hsc_torch.ops.pipeline, hsc_torch.models.coder):
        monkeypatch.setattr(module, "encode_init_batched", init)


@pytest.fixture
def jax_run(monkeypatch, capsys):
    """Run the JAX CLI in-process (its own argument parser reads sys.argv)
    and return what it printed."""
    monkeypatch.setattr(hsc_tpu.utils.cache, "enable_compilation_cache", lambda *a, **k: None)

    def run(*args):
        capsys.readouterr()
        monkeypatch.setattr(sys, "argv", ["hsc-codec", *map(str, args)])
        jax_cli.main()
        return capsys.readouterr().out

    return run


@pytest.fixture
def run(capsys):
    """Run the port's CLI in-process on the CPU and return what it printed."""
    def run(*args, device="cpu"):
        capsys.readouterr()
        port_cli.main([*map(str, args)] + (["--device", device] if device else []))
        return capsys.readouterr().out

    return run


def _fails(run, *args, device="cpu") -> str:
    with pytest.raises(SystemExit) as e:
        run(*args, device=device)
    assert e.value.code not in (0, None)
    return str(e.value.code)


def _same_bytes(a, b) -> bool:
    return open(a, "rb").read() == open(b, "rb").read()


def test_cli_roundtrip_info_byte_identical_to_jax(cli_fixture, tmp_path, inject, run, jax_run):
    d = cli_fixture
    out = run("encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "p.hsct")
    assert "bytes" in out
    jax_run("encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "j.hsct",
            "--backend", "jax")
    assert _same_bytes(tmp_path / "p.hsct", tmp_path / "j.hsct")
    run("decode", "--dict", d / "dict.npz", "--input", tmp_path / "j.hsct", "--output", tmp_path / "rp.npy")
    jax_run("decode", "--dict", d / "dict.npz", "--input", tmp_path / "j.hsct", "--output", tmp_path / "rj.npy",
            "--backend", "jax")
    r = np.load(tmp_path / "rp.npy")
    assert r.tobytes() == np.load(tmp_path / "rj.npy").tobytes()
    x = np.load(d / "sig.npy").reshape(r.shape)
    assert (10 * np.log10((x * x).sum(1) / ((x - r) ** 2).sum(1))).mean() > 3.0
    doc = json.loads(run("info", "--input", tmp_path / "j.hsct", device=None))
    assert doc == json.loads(jax_run("info", "--input", tmp_path / "j.hsct"))
    assert doc["blocks"] == 3 and doc["config"]["decode_mode"] == "integer" and doc["compression_ratio"] > 1
    blob = (tmp_path / "j.hsct").read_bytes()
    rates = corpus_rates(peek_corpus_header(blob)[0], iter_blocks(blob))
    assert {k: doc[k] for k in ("total_bytes", "total_events", "bits_per_sample", "compression_ratio")} == {
        k: rates[k] for k in ("total_bytes", "total_events", "bits_per_sample", "compression_ratio")}


def test_cli_overrides_and_errors(cli_fixture, tmp_path, inject, run, jax_run):
    d = cli_fixture
    over = ["--entropy", "rice", "--decode-mode", "integer", "--num-select", "2", "--num-coefs", "32"]
    run("encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "p.hsct", *over)
    jax_run("encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "j.hsct",
            "--backend", "jax", *over)
    assert _same_bytes(tmp_path / "p.hsct", tmp_path / "j.hsct")
    doc = json.loads(run("info", "--input", tmp_path / "p.hsct", device=None))
    assert doc["config"]["entropy"] == "rice" and doc["config"]["num_coefs"][-1] == 32
    with pytest.raises(ValueError, match="bad magic"):
        run("info", "--input", d / "sig.npy", device=None)
    assert "--dict is required" in _fails(run, "encode", "--input", d / "sig.npy", "--output", tmp_path / "x")
    assert "--output is required" in _fails(run, "decode", "--dict", d / "dict.npz", "--input", tmp_path / "p.hsct")


def test_cli_streaming_decode_identical(cli_fixture, tmp_path, run):
    d = cli_fixture
    run("encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "s.hsct")
    run("decode", "--dict", d / "dict.npz", "--input", tmp_path / "s.hsct", "--output", tmp_path / "r.npy")
    run("decode", "--dict", d / "dict.npz", "--input", tmp_path / "s.hsct", "--output", tmp_path / "rs.npy",
        "--streaming")
    assert np.load(tmp_path / "rs.npy").tobytes() == np.load(tmp_path / "r.npy").tobytes()
    assert "--streaming requires a .npy" in _fails(
        run, "decode", "--dict", d / "dict.npz", "--input", tmp_path / "s.hsct", "--output", tmp_path / "r.wav",
        "--streaming")


def test_cli_mmap_encode_identical(cli_fixture, tmp_path, run):
    d = cli_fixture
    run("encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "m0.hsct")
    run("encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "m1.hsct", "--mmap")
    assert _same_bytes(tmp_path / "m0.hsct", tmp_path / "m1.hsct")
    np.save(tmp_path / "f64.npy", np.load(d / "sig.npy").astype(np.float64))
    assert "float32" in _fails(run, "encode", "--dict", d / "dict.npz", "--input", tmp_path / "f64.npy",
                               "--output", tmp_path / "m2.hsct", "--mmap")
    np.save(tmp_path / "ragged.npy", np.load(d / "sig.npy")[:-7])
    assert "whole blocks" in _fails(run, "encode", "--dict", d / "dict.npz", "--input", tmp_path / "ragged.npy",
                                    "--output", tmp_path / "m3.hsct", "--mmap")


def test_cli_wav_in_and_out_match_jax(cli_fixture, tmp_path, inject, run, jax_run):
    """A .wav corpus encodes to JAX's container, and a .wav output is JAX's
    file byte for byte (the port's copies of `load_wav_blocks` and
    `save_wav`)."""
    d = cli_fixture
    save_wav(str(tmp_path / "in.wav"), np.load(d / "sig.npy")[:2500], rate=8000)
    for name, cli, extra in (("p", run, []), ("j", jax_run, ["--backend", "jax"])):
        cli("encode", "--dict", d / "dict.npz", "--input", tmp_path / "in.wav", "--output", tmp_path / f"{name}.hsct",
            *extra)
        cli("decode", "--dict", d / "dict.npz", "--input", tmp_path / f"{name}.hsct", "--output",
            tmp_path / f"{name}.wav", "--wav-rate", "8000", *extra)
    assert _same_bytes(tmp_path / "p.hsct", tmp_path / "j.hsct")
    assert _same_bytes(tmp_path / "p.wav", tmp_path / "j.wav")


def test_cli_learn_then_roundtrip(cli_fixture, tmp_path, run):
    """`learn` (kmean) writes a dictionary the encode/decode verbs accept end
    to end, one level and two."""
    d = cli_fixture
    run("learn", "--input", d / "sig.npy", "--output", tmp_path / "learned.npz", "--counts", "8", "--scales", "16",
        "--block-size", "1024", "--learn-coefs", "48", "--num-windows", "256", "--iterations", "4",
        "--num-coefs", "40")
    assert MultilevelDictionary.load(str(tmp_path / "learned.npz")).config.num_coefs == (40,)
    run("encode", "--dict", tmp_path / "learned.npz", "--input", d / "sig.npy", "--output", tmp_path / "sl.hsct")
    run("decode", "--dict", tmp_path / "learned.npz", "--input", tmp_path / "sl.hsct", "--output",
        tmp_path / "rl.npy")
    r = np.load(tmp_path / "rl.npy")
    x = np.load(d / "sig.npy").reshape(r.shape)
    assert (10 * np.log10((x * x).sum(1) / ((x - r) ** 2).sum(1))).mean() > 2.0
    run("learn", "--input", d / "sig.npy", "--output", tmp_path / "learned2.npz", "--counts", "6,4",
        "--scales", "16,32", "--block-size", "1024", "--learn-coefs", "48,24", "--num-windows", "128",
        "--iterations", "3", "--checkpoint-dir", tmp_path / "ck")
    assert (tmp_path / "ck" / "trainer_state.npz").exists()
    run("encode", "--dict", tmp_path / "learned2.npz", "--input", d / "sig.npy", "--output", tmp_path / "sl2.hsct")
    run("decode", "--dict", tmp_path / "learned2.npz", "--input", tmp_path / "sl2.hsct", "--output",
        tmp_path / "rl2.npy")
    assert np.load(tmp_path / "rl2.npy").shape == x.shape
    assert "--counts" in _fails(run, "learn", "--input", d / "sig.npy", "--output", tmp_path / "y.npz")
    assert "--output" in _fails(run, "learn", "--input", d / "sig.npy", "--counts", "8", "--scales", "16")


@pytest.mark.parametrize("counts,scales,coefs", [("8", "16", "48"), ("6,4", "16,32", "48,24")])
def test_cli_learn_samples_equal_jax(cli_fixture, tmp_path, inject, run, jax_run, counts, scales, coefs):
    """`learn --algorithm samples`, JAX's level-0 init injected for the
    two-level trainer's level-0 encode: the same config and arrays as the
    JAX CLI's dictionary."""
    d = cli_fixture
    args = ["learn", "--input", d / "sig.npy", "--counts", counts, "--scales", scales, "--block-size", "1024",
            "--learn-coefs", coefs, "--num-windows", "128", "--algorithm", "samples", "--seed", "3"]
    run(*args, "--output", tmp_path / "p.npz")
    jax_run(*args, "--output", tmp_path / "j.npz")
    with np.load(tmp_path / "p.npz") as zp, np.load(tmp_path / "j.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype and zp[k].tobytes() == zj[k].tobytes(), k


def test_cli_indexed_encode_and_range_decode(cli_fixture, tmp_path, run, jax_run):
    d = cli_fixture
    run("encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "si.hsct", "--index")
    assert json.loads(run("info", "--input", tmp_path / "si.hsct", device=None))["seek_index"] is True
    run("decode", "--dict", d / "dict.npz", "--input", tmp_path / "si.hsct", "--output", tmp_path / "rall.npy")
    run("decode", "--dict", d / "dict.npz", "--input", tmp_path / "si.hsct", "--output", tmp_path / "r12.npy",
        "--range", "1:3")
    jax_run("decode", "--dict", d / "dict.npz", "--input", tmp_path / "si.hsct", "--output", tmp_path / "j12.npy",
            "--range", "1:3", "--backend", "jax")
    rall, r12 = np.load(tmp_path / "rall.npy"), np.load(tmp_path / "r12.npy")
    assert r12.shape[0] == 2 and r12.tobytes() == rall[1:3].tobytes()
    assert r12.tobytes() == np.load(tmp_path / "j12.npy").tobytes()
    run("decode", "--dict", d / "dict.npz", "--input", tmp_path / "si.hsct", "--output", tmp_path / "rc.npy",
        "--range=-2:999")
    assert np.load(tmp_path / "rc.npy").tobytes() == rall[-2:].tobytes()
    assert "A:B" in _fails(run, "decode", "--dict", d / "dict.npz", "--input", tmp_path / "si.hsct",
                           "--output", tmp_path / "x.npy", "--range", "oops")


@pytest.mark.parametrize("flags", [["--streaming"], ["--mmap", "--streaming"], ["--mmap"]])
def test_cli_streaming_and_mmap_range_decode(cli_fixture, tmp_path, run, flags):
    """--streaming and --mmap compose with --range: the selected rows,
    byte-identical to the full decode's slice."""
    d = cli_fixture
    run("encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "si.hsct", "--index")
    run("decode", "--dict", d / "dict.npz", "--input", tmp_path / "si.hsct", "--output", tmp_path / "rall.npy")
    run("decode", "--dict", d / "dict.npz", "--input", tmp_path / "si.hsct", "--output", tmp_path / "rs.npy",
        "--range", "0:2", *flags)
    rs = np.load(tmp_path / "rs.npy")
    assert rs.shape[0] == 2 and rs.tobytes() == np.load(tmp_path / "rall.npy")[0:2].tobytes()


def test_cli_info_mmap(cli_fixture, tmp_path, run):
    d = cli_fixture
    run("encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "s.hsct")
    a = json.loads(run("info", "--input", tmp_path / "s.hsct", device=None))
    assert a == json.loads(run("info", "--input", tmp_path / "s.hsct", "--mmap", device=None))


def test_cli_assemble_from_journal(cli_fixture, tmp_path, run, jax_run):
    """`assemble` rebuilds the encode's container from its journal
    directory alone — the same bytes as the JAX CLI's `assemble` of that
    directory — from a two-process split too, and fails cleanly on a
    directory that is not a journal and on a block gap."""
    d = cli_fixture
    jdir = tmp_path / "j"
    run("encode", "--input", d / "sig.npy", "--dict", d / "dict.npz", "--output", tmp_path / "enc.hsct",
        "--journal-dir", jdir)
    run("assemble", "--input", jdir, "--output", tmp_path / "asm.hsct", device=None)
    jax_run("assemble", "--input", jdir, "--output", tmp_path / "jasm.hsct")
    assert _same_bytes(tmp_path / "asm.hsct", tmp_path / "enc.hsct")
    assert _same_bytes(tmp_path / "jasm.hsct", tmp_path / "enc.hsct")
    j0 = EncodeJournal(str(jdir), name=_journal_name(0))
    moved = sorted(j0.done_blocks)[1::2]
    j1 = EncodeJournal(str(jdir / "split"), name=_journal_name(1))
    j0_keep = EncodeJournal(str(jdir / "split"), name=_journal_name(0))
    shutil.copy(jdir / "corpus.config", jdir / "split" / "corpus.config")
    for bid in sorted(j0.done_blocks):
        (j1 if bid in moved else j0_keep).record(bid, j0.read(bid))
    for j in (j0, j1, j0_keep):
        j.close()
    run("assemble", "--input", jdir / "split", "--output", tmp_path / "asm2.hsct", device=None)
    assert _same_bytes(tmp_path / "asm2.hsct", tmp_path / "enc.hsct")
    assert "journal" in _fails(run, "assemble", "--input", tmp_path, "--output", tmp_path / "x.hsct", device=None)
    jgap = EncodeJournal(str(jdir / "gap"), name=_journal_name(0))
    src = EncodeJournal(str(jdir), name=_journal_name(0))
    ids = sorted(src.done_blocks)
    for bid in ids:
        if bid != ids[1]:
            jgap.record(bid, src.read(bid))
    jgap.close()
    src.close()
    shutil.copy(jdir / "corpus.config", jdir / "gap" / "corpus.config")
    msg = _fails(run, "assemble", "--input", jdir / "gap", "--output", tmp_path / "g.hsct", device=None)
    assert "not yet encoded" in msg and str(ids[1]) in msg


def test_cli_assemble_cbr_journal(cli_fixture, tmp_path, run):
    """`assemble` of journals written under --target-bps, with and without
    --distributed, and with process 0's files absent: the encode's bytes,
    and no process-0 file fabricated by the probe."""
    d = cli_fixture
    for name, extra in (("jc", []), ("jcd", ["--distributed"])):
        run("encode", "--input", d / "sig.npy", "--dict", d / "dict.npz", "--output", tmp_path / f"{name}.hsct",
            "--journal-dir", tmp_path / name, "--target-bps", "0.5", *extra)
        run("assemble", "--input", tmp_path / name, "--output", tmp_path / f"{name}_asm.hsct", device=None)
        assert _same_bytes(tmp_path / f"{name}_asm.hsct", tmp_path / f"{name}.hsct")
    jdir3 = tmp_path / "jp0"
    jdir3.mkdir()
    for f in (tmp_path / "jcd").iterdir():
        shutil.copy(f, jdir3 / f.name.replace("corpus.", "corpus.p1.", 1))
    run("assemble", "--input", jdir3, "--output", tmp_path / "p0.hsct", device=None)
    assert _same_bytes(tmp_path / "p0.hsct", tmp_path / "jcd.hsct")
    assert not (jdir3 / "corpus.journal").exists() and not (jdir3 / "corpus.config").exists()


def test_cli_mesh_exits_naming_parallel(cli_fixture, tmp_path, run, monkeypatch):
    """`--mesh N` past the visible cards exits with the JAX CLI's text,
    "--mesh N: only M device(s) visible", before any device work: here a
    host that reports one card asks for two, for encode and decode, and
    nothing is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    d = cli_fixture
    for verb, inp in (("encode", d / "sig.npy"), ("decode", d / "sig.npy")):
        msg = _fails(run, verb, "--dict", d / "dict.npz", "--input", inp, "--output", tmp_path / "x", "--mesh", "2",
                     device="cuda")
        assert msg == "--mesh 2: only 1 device(s) visible"
    assert not (tmp_path / "x").exists()


def test_cli_without_device_needs_a_card(cli_fixture, tmp_path, run, monkeypatch):
    """No --device: encode, decode and learn ask for the card and exit with
    `resolve_device`'s error on a host without one — nothing runs on the
    CPU and nothing is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = cli_fixture
    for args in (["encode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "x.hsct"],
                 ["decode", "--dict", d / "dict.npz", "--input", d / "sig.npy", "--output", tmp_path / "x.npy"],
                 ["learn", "--input", d / "sig.npy", "--output", tmp_path / "x.npz", "--counts", "8",
                  "--scales", "16", "--block-size", "1024"]):
        msg = _fails(run, *args, device=None)
        assert "torch.cuda.is_available() is False" in msg and "cuda" in msg
    assert not list(tmp_path.iterdir())
