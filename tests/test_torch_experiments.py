"""The port's experiment drivers (`scripts/torch_run_experiment.py`,
`scripts/torch_run_audio_experiment.py`) against the JAX package's
(`scripts/run_experiment.py`, `scripts/run_audio_experiment.py`) on the CPU.

Each JAX driver runs once per module in a subprocess (`--platform cpu
--backend jax`, as tests/test_signal.py runs the audio driver); the port's
run in-process with `--device cpu`.

- With JAX's level-0 init injected and `--skip-learning`, the port's
  experiment writes the JAX driver's files byte for byte and its report
  value for value, timings aside.
- With learning and no injection, the reports have the same keys; the JAX
  package's analysis functions (the NumPy oracle, of which the port holds
  verbatim copies) applied to the port's dictionary and container give the
  port's report values exactly; JAX's decoder reads the port's container
  bitwise to the port's rows; and the learned level-0 dictionaries agree to
  1e-4.  Levels >= 1 are held from JAX's level 0 (see
  `test_learned_dictionaries_near_jax`).
- Without matplotlib both drivers do all but the figures; without a card
  and `--device` both exit; `--profile-dir` writes a trace.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsc_tpu
import hsc_tpu.analysis as jax_analysis
from hsc_tpu.io import unpack_corpus as jax_unpack
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.runtime import CorpusEncoder as JaxCorpusEncoder
from hsc_tpu.signal import load_wav_blocks as jax_load_wav

import hsc_torch.models.coder
import hsc_torch.ops.pipeline
from hsc_torch import MultilevelDictionary
from hsc_torch.runtime import CorpusEncoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
sys.path.insert(0, SCRIPTS)

import torch_run_audio_experiment as port_audio  # noqa: E402
import torch_run_experiment as port_exp  # noqa: E402

# small configurations: the experiment at its 2-level defaults on 4 blocks,
# the audio one at tests/test_signal.py's
EXP = ["--blocks", "4", "--learn-iterations", "3", "--budget-sweep", "8,16"]
AUDIO = ["--seconds", "2", "--block-size", "2048", "--counts", "8,4", "--scales", "16,48",
         "--num-coefs", "64,24", "--budget-sweep", "4,8", "--rd-blocks", "2", "--learn-iterations", "2"]
FIGURES = {
    "experiment": ["truth.level0.png", "truth.level1.png", "learned.level0.png", "learned.level1.png",
                   "rate_distortion.png", "level_diagnostics.png"],
    "audio": ["learned.level0.png", "learned.level1.png", "rate_distortion.png", "level_diagnostics.png"],
}
FILES = {
    "experiment": ["truth_dict.npz", "learned_dict.npz", "corpus.hsct", "metrics.jsonl", "report.json",
                   "journal", os.path.join("ckpt", "trainer_state.npz")],
    "audio": ["corpus_in.wav", "learned_dict.npz", "corpus.hsct", "decoded.wav", "metrics.jsonl",
              "report.json", os.path.join("ckpt", "trainer_state.npz")],
}


def _inject_jax_init(mp):
    """JAX's level-0 init wherever the port looks up `encode_init_batched`."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    for module in (hsc_torch.ops.pipeline, hsc_torch.models.coder):
        mp.setattr(module, "encode_init_batched", init)


def _resume_from_jax_level0(outdir, jax_dir):
    """A trainer journal holding JAX's learned level 0 only, so the port's
    driver learns levels >= 1 from it."""
    os.makedirs(os.path.join(outdir, "ckpt"))
    with np.load(os.path.join(jax_dir, "learned_dict.npz")) as z:
        np.savez(os.path.join(outdir, "ckpt", "trainer_state.npz"), level=np.int64(1), dict_0=z["dict_0"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every driver run of the module: the JAX ones in parallel
    subprocesses, the port's in this process meanwhile."""
    d = tmp_path_factory.mktemp("experiments")
    jax_args = {
        "skip": ("run_experiment.py", [*EXP, "--skip-learning"]),
        "exp": ("run_experiment.py", EXP),
        "audio": ("run_audio_experiment.py", AUDIO),
    }
    procs = {
        name: subprocess.Popen(
            [sys.executable, os.path.join(SCRIPTS, script), "--outdir", str(d / f"jax_{name}"),
             "--platform", "cpu", "--backend", "jax", *args],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        )
        for name, (script, args) in jax_args.items()
    }
    try:
        with pytest.MonkeyPatch.context() as mp:
            _inject_jax_init(mp)
            port_exp.main(["--outdir", str(d / "port_skip"), "--device", "cpu", *EXP, "--skip-learning"])
        port_exp.main(["--outdir", str(d / "port_exp"), "--device", "cpu", *EXP,
                       "--profile-dir", str(d / "port_exp" / "profile")])
        port_audio.main(["--outdir", str(d / "port_audio"), "--device", "cpu", *AUDIO])
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"JAX {name} driver: {err[-2000:]}"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    # levels >= 1 learned by the port from JAX's level 0 (its init injected)
    with pytest.MonkeyPatch.context() as mp:
        _inject_jax_init(mp)
        _resume_from_jax_level0(d / "port_exp_l0", d / "jax_exp")
        port_exp.main(["--outdir", str(d / "port_exp_l0"), "--device", "cpu", *EXP])
        _resume_from_jax_level0(d / "port_audio_l0", d / "jax_audio")
        port_audio.main(["--outdir", str(d / "port_audio_l0"), "--device", "cpu", *AUDIO])
    return d


def _report(path):
    with open(os.path.join(path, "report.json")) as f:
        return json.load(f)


def _without_seconds(node):
    if isinstance(node, dict):
        return {k: _without_seconds(v) for k, v in node.items() if not k.startswith("seconds")}
    if isinstance(node, list):
        return [_without_seconds(v) for v in node]
    return node


def _keys(node):
    """The report's shape: every key path, no values."""
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_keys(v) for v in node]
    return None


def _blob(path):
    with open(os.path.join(path, "corpus.hsct"), "rb") as f:
        return f.read()


def _jax_dict(path, name):
    return hsc_tpu.MultilevelDictionary.load(os.path.join(path, name))


def _port_rows(path, name):
    return CorpusEncoder(MultilevelDictionary.load(os.path.join(path, name)), device="cpu").decode(_blob(path))


def _as_json(value):
    return json.loads(json.dumps(value))


def test_skip_learning_files_equal_jax(runs):
    """JAX's init injected: the ground truth, the container and the decoded
    rows are the JAX driver's, bit for bit."""
    port, ref = runs / "port_skip", runs / "jax_skip"
    with np.load(port / "truth_dict.npz") as a, np.load(ref / "truth_dict.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    assert _blob(port) == _blob(ref)
    rows = _port_rows(port, "truth_dict.npz")
    jax_rows = JaxCorpusEncoder(_jax_dict(ref, "truth_dict.npz"), backend="jax").decode(_blob(ref))
    assert rows.shape == (4, 1024) and rows.tobytes() == jax_rows.tobytes()
    assert not (port / "learned_dict.npz").exists() and not (ref / "learned_dict.npz").exists()


def test_skip_learning_report_equal_jax(runs):
    """JAX's init injected: report.json equal key for key and value for
    value, but for the `seconds` fields."""
    port, ref = _report(runs / "port_skip"), _report(runs / "jax_skip")
    assert _keys(port) == _keys(ref)
    assert _without_seconds(port) == _without_seconds(ref)


@pytest.mark.parametrize("kind", ["exp", "audio"])
def test_report_keys_equal_jax(runs, kind):
    """No injection: the same report, key for key."""
    assert _keys(_report(runs / f"port_{kind}")) == _keys(_report(runs / f"jax_{kind}"))


def test_experiment_analysis_equals_jax_oracle(runs):
    """JAX's analysis (the NumPy oracle) on the port's dictionary, corpus
    and container gives the port's report values exactly."""
    port = runs / "port_exp"
    report = _report(port)
    mld = _jax_dict(port, "learned_dict.npz")
    truth = _jax_dict(port, "truth_dict.npz")
    corpus = hsc_tpu.SignalGenerator(truth, rates=4e-3).generate_signals(4, 1024, seed=8)
    cfg, blocks = jax_unpack(_blob(port))
    rates = jax_analysis.corpus_rates(cfg, blocks)
    for k in ("bits_per_sample", "compression_ratio"):
        assert report["encode"][k] == rates[k], k
    assert report["encode"]["compressed_bytes"] == len(_blob(port))
    budgets = [8, 16]
    assert report["rate_distortion"]["flat"] == _as_json(
        jax_analysis.rate_distortion_curve(mld.up_to_level(0), corpus, budgets))
    assert report["rate_distortion"]["hierarchical"] == _as_json(
        jax_analysis.hierarchical_rate_distortion_curve(mld, corpus, budgets))
    assert report["level_energies"] == _as_json(
        {str(l): v for l, v in jax_analysis.level_energies(mld, blocks, distributed=True).items()})
    assert report["coefficient_distribution"] == _as_json(
        {str(l): v for l, v in jax_analysis.coefficient_distribution(cfg, blocks, distributed=True).items()})


def test_audio_analysis_equals_jax_oracle(runs):
    """The audio report's oracle-run values (rates, the hierarchical curve,
    the decode-mode table, level energies) are JAX's analysis of the port's
    dictionary, WAV corpus and container, exactly."""
    port = runs / "port_audio"
    report = _report(port)
    mld = _jax_dict(port, "learned_dict.npz")
    corpus = jax_load_wav(str(port / "corpus_in.wav"), 2048)
    assert report["corpus"]["blocks"] == corpus.shape[0] == 16
    rd = corpus[:2]
    cfg, blocks = jax_unpack(_blob(port))
    rates = jax_analysis.corpus_rates(cfg, blocks)
    for k in ("bits_per_sample", "compression_ratio"):
        assert report["encode"][k] == rates[k], k
    assert report["rate_distortion"]["hierarchical"] == _as_json(
        jax_analysis.hierarchical_rate_distortion_curve(mld, rd, [4, 8]))
    assert report["decode_mode_fidelity"] == _as_json(jax_analysis.decode_mode_fidelity(mld, rd))
    assert report["level_energies"] == _as_json(
        {str(l): v for l, v in jax_analysis.level_energies(mld, blocks, distributed=True).items()})
    assert report["encode"]["roundtrip_byte_identity"] is True
    assert len(report["rate_distortion"]["flat"]) == 2


@pytest.mark.parametrize("kind", ["exp", "audio"])
def test_container_decodes_bitwise_in_jax(runs, kind):
    """JAX's decoder reads the port's container to the port's rows, bit for
    bit (decoding is bitwise in the spec)."""
    port = runs / f"port_{kind}"
    rows = _port_rows(port, "learned_dict.npz")
    jax_rows = JaxCorpusEncoder(_jax_dict(port, "learned_dict.npz"), backend="jax").decode(_blob(port))
    assert rows.shape[0] == _report(port)["corpus"]["blocks"]
    assert rows.tobytes() == jax_rows.tobytes()


@pytest.mark.parametrize("kind", ["exp", "audio"])
def test_learned_dictionaries_near_jax(runs, kind):
    """Level 0 learned with no injection is within 1e-4 of JAX's.  Level 1
    is not, at these configs, and that is not a fault: k-means reduces in
    another order, so level 0 comes out an ulp or so off JAX's (1.2e-7 at
    the experiment's config), which moves some cells of the level-0
    coefficient map by ulps; the energy ranking of `extract_windows` then
    picks one other window of the 4096 where two are near-tied, and k-means
    from it ends 0.08 away.  So level 1 is held from JAX's own level 0,
    with JAX's init injected: the port's trainer resumes from a journal
    holding JAX's level 0 and learns level 1 within 1e-4 of JAX's."""
    port, ref, resumed = runs / f"port_{kind}", runs / f"jax_{kind}", runs / f"port_{kind}_l0"
    with np.load(port / "learned_dict.npz") as a, np.load(ref / "learned_dict.npz") as b:
        np.testing.assert_allclose(a["dict_0"], b["dict_0"], rtol=0, atol=1e-4)
    with np.load(resumed / "learned_dict.npz") as a, np.load(ref / "learned_dict.npz") as b:
        assert a["dict_0"].tobytes() == b["dict_0"].tobytes()
        np.testing.assert_allclose(a["dict_1"], b["dict_1"], rtol=0, atol=1e-4)


def test_profile_dir_writes_a_trace(runs):
    with open(runs / "port_exp" / "profile" / "encode.trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]


@pytest.mark.parametrize("kind", ["experiment", "audio"])
def test_without_matplotlib(tmp_path, monkeypatch, capsys, kind):
    """Where matplotlib does not import, a driver still does all its work:
    it writes every file but the figures, names those on one line and
    returns its report."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / kind
    if kind == "experiment":
        report = port_exp.main(["--outdir", str(out), "--device", "cpu", "--blocks", "2",
                                "--learn-iterations", "2", "--budget-sweep", "8"])
    else:
        report = port_audio.main(["--outdir", str(out), "--device", "cpu", *AUDIO, "--seconds", "1",
                                  "--rd-blocks", "1", "--budget-sweep", "4"])
    printed = capsys.readouterr().out
    assert report["encode"]["compression_ratio"] > 1.0
    for name in FILES[kind]:
        assert (out / name).exists(), name
    assert not list(out.glob("**/*.png"))
    line = f"figures not written (matplotlib is not installed): {', '.join(FIGURES[kind])}"
    assert line in printed.splitlines()


@pytest.mark.parametrize("main", [port_exp.main, port_audio.main], ids=["experiment", "audio"])
def test_without_device_needs_a_card(tmp_path, monkeypatch, main):
    """No --device: the driver asks for the card and exits with
    `resolve_device`'s error on a host without one; nothing is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["--outdir", str(tmp_path / "out")])
    msg = str(e.value.code)
    assert "torch.cuda.is_available() is False" in msg and "--device cuda" in msg
    assert not list(tmp_path.iterdir())
