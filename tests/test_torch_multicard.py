"""`scripts/torch_multicard.py` on the CPU, against the JAX package, and the
rules that place the port's shards and processes on cards.

The script's mesh mode runs on 2 CPU devices of their own (``cpu:0``,
``cpu:1``: to the port distinct devices, so `parallel.dp.replica` copies
the coders) and on repeated ones, at its small geometry, and its
multi-process mode over gloo in 2 processes.  JAX's level-0 init is
injected where the port looks it up (in the test process and in each
spawned process), so the containers are held bitwise to JAX's
`CorpusEncoder.encode` and the data-parallel fields to JAX's
`DataParallelEncoder` on conftest's virtual CPU devices.  The card
assignment (shard i on card i mod N, rank p on card p, the CLI's first N
cards, an object keeping the card current when it was built) is checked
with the CUDA calls stubbed.  One case needs two cards and skips without them.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsc_tpu import MultilevelDictionary as JaxMLD
from hsc_tpu import SignalGenerator as JaxSignalGenerator
from hsc_tpu import make_test_config as jax_config
from hsc_tpu.models import ConvolutionalSparseCoder as JaxSparseCoder
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.parallel import DataParallelEncoder as JaxDPEncoder
from hsc_tpu.parallel import make_mesh as jax_make_mesh
from hsc_tpu.runtime import CorpusEncoder as JaxCorpusEncoder

import hsc_torch.cli
import hsc_torch.models.coder
import hsc_torch.ops.pipeline
import hsc_torch.parallel
import hsc_torch.parallel.dp
import hsc_torch.runtime
from hsc_torch.device import resolve_device
from hsc_torch.parallel import initialize_distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import torch_fuzz_parity  # noqa: E402
import torch_multicard  # noqa: E402

FIELDS = ("positions", "atoms", "codes", "count", "scale")


def _jax_init(xb, bank):
    out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
    return tuple(torch.from_numpy(np.array(a)) for a in out)


# every module that looks up the level-0 init by name
INIT_USERS = (hsc_torch.ops.pipeline, hsc_torch.models.coder, torch_multicard)


def _inject_in_this_process():
    for module in INIT_USERS:
        module.encode_init_batched = _jax_init


def _worker_with_jax_init(*args):
    """`torch_multicard.nccl_worker` in a spawned process, with JAX's
    level-0 init where the port looks it up."""
    _inject_in_this_process()
    torch_multicard.nccl_worker(*args)


@pytest.fixture
def inject(monkeypatch):
    for module in INIT_USERS:
        monkeypatch.setattr(module, "encode_init_batched", _jax_init)


def _jax_data(kw, dict_seed, signal_seed, n):
    mld = JaxMLD.generate(jax_config(**kw), seed=dict_seed)
    xs = JaxSignalGenerator(mld, rates=2e-3).generate_signals(n, mld.config.block_size, seed=signal_seed)
    return mld, xs


def _jax_fields_equal(got, ref, n):
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f))[:n], np.asarray(getattr(ref, f))[:n]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


# -- the mesh mode ------------------------------------------------------------------


@pytest.mark.parametrize("placement", ["cpu:i", "repeated"])
def test_mesh_mode_against_jax(inject, tmp_path, capsys, placement):
    """Every mesh check of the script passes at its small geometry on 2 CPU
    "cards" (shard i on ``cpu:i mod 2``, or every shard on the one CPU
    device, a subset of checks), and its outputs are JAX's: the flat and
    the hierarchical containers (top-only and distributed) JAX's
    `CorpusEncoder.encode`, the data-parallel fields JAX's
    `DataParallelEncoder` on 2 virtual devices."""
    geo = torch_multicard.SMALL
    cards = torch_multicard.card_list(2, "cpu") if placement == "cpu:i" else [torch.device("cpu")] * 2
    checks = torch_multicard.MeshChecks(cards, geo, str(tmp_path))
    want = ["dp_encode_flat", "corpus_flat", "dp_decode_flat", "dp_encode_hier", "corpus_hier", "corpus_hier_f32",
            "corpus_hier3", "sp", "tp", "kmeans", "online"]  # the CLI's mesh: test_torch_parallel_runtime.py
    if placement == "repeated":
        want = ["dp_encode_flat", "corpus_flat", "dp_decode_flat", "corpus_hier"]
    lines = checks.run(set(want))
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == lines and all(line["ok"] for line in lines), [line for line in lines if not line["ok"]]
    assert [line["check"] for line in lines] == want
    nb = geo.blocks_per_card * 2 + geo.tail
    mld, xs = _jax_data(geo.flat, 7, 3, nb)
    assert np.array_equal(xs, checks.xs)
    for tag, dist_ in (("top", False), ("distributed", True)):
        ref = JaxCorpusEncoder(mld, backend="jax", distributed=dist_).encode(xs)
        assert checks.keep[f"corpus_flat_{tag}"] == ref, tag
    hmld, hxs = _jax_data(geo.hier, 9, 5, nb)
    for tag, dist_ in (("top", False), ("distributed", True)):
        assert checks.keep[f"corpus_hier_{tag}"] == JaxCorpusEncoder(hmld, backend="jax", distributed=dist_).encode(hxs)
    if placement == "cpu:i":
        ref = JaxDPEncoder(jax_make_mesh({"data": 2}, devices=jax.devices()[:2]), JaxSparseCoder(mld, backend="jax").mp).encode(xs)
        _jax_fields_equal(checks.keep["dp_encode_flat"], ref, nb)


def test_mesh_mode_fails_on_a_changed_shard(monkeypatch, tmp_path, capsys):
    """A shard whose events differ fails its checks (the comparison bites):
    here the greedy loop of card 1 drops every block's last event."""
    import hsc_torch.models.coder as coder_mod

    real = coder_mod.ConvolutionalMatchingPursuit.loop_stage

    def drop_last(self, *args):
        enc = real(self, *args)
        if self.device == torch.device("cpu", 1):
            enc = enc._replace(count=(enc.count - 1).clamp_min(0))
        return enc

    monkeypatch.setattr(coder_mod.ConvolutionalMatchingPursuit, "loop_stage", drop_last)
    checks = torch_multicard.MeshChecks(torch_multicard.card_list(2, "cpu"), torch_multicard.SMALL, str(tmp_path))
    lines = {line["check"]: line for line in checks.run({"dp_encode_flat", "corpus_flat", "dp_encode_hier"})}
    assert not any(line["ok"] for line in lines.values())
    assert "count" in lines["dp_encode_flat"]["error"] and "vs the unsharded encode" in lines["dp_encode_flat"]["error"]
    assert "container vs one card" in lines["corpus_flat"]["error"]


# -- the multi-process mode -----------------------------------------------------------


def test_nccl_mode_over_gloo_against_jax(inject, tmp_path, capsys):
    """2 processes joined by `initialize_distributed` (gloo), each building
    its coder after joining: `DataParallelEncoder.encode_multihost` equals
    the one-process encode, `CorpusEncoder.encode_multihost`'s containers
    (process 0 assembling) the one-process containers, and those JAX's."""
    geo = torch_multicard.SMALL
    cards = torch_multicard.card_list(2, "cpu")
    lines = torch_multicard.run_nccl(cards, geo, str(tmp_path), timeout=240, target=_worker_with_jax_init)
    assert [line["check"] for line in lines] == ["dp_encode_multihost", "corpus_flat", "corpus_hier"]
    assert all(line["ok"] and line["backend"] == "gloo" and line["processes"] == 2 for line in lines), lines
    nb = geo.blocks_per_card * 2 + geo.tail
    for name, kw, seeds in (("flat", geo.flat, (7, 3)), ("hier", geo.hier, (9, 5))):
        mld, xs = _jax_data(kw, *seeds, nb)
        with open(tmp_path / "nccl" / f"corpus_{name}.hsct", "rb") as f:
            assert f.read() == JaxCorpusEncoder(mld, backend="jax").encode(xs), name
    mld, xs = _jax_data(geo.flat, 7, 3, 4 * 2 + 3)
    ref = JaxDPEncoder(jax_make_mesh({"data": 2}, devices=jax.devices()[:2]), JaxSparseCoder(mld, backend="jax").mp).encode(xs)
    with np.load(tmp_path / "nccl" / "dp_encode_multihost.npz") as z:
        for f in FIELDS:
            assert z[f].dtype == np.asarray(getattr(ref, f)).dtype and z[f].tobytes() == np.asarray(
                getattr(ref, f)).tobytes(), f


def test_nccl_mode_fails_when_a_rank_fails(tmp_path, capsys):
    """A rank that exits non-zero fails every multi-process check: no
    rank's failure is caught, none passes on the others' output."""
    lines = torch_multicard.run_nccl(torch_multicard.card_list(2, "cpu"), torch_multicard.SMALL, str(tmp_path),
                                     timeout=120, target=_failing_rank, hier=False)
    assert [line["ok"] for line in lines] == [False, False]
    assert all("rank exit codes" in line["error"] for line in lines)


def _failing_rank(rank, *args):
    if rank == 1:
        sys.exit(3)
    torch_multicard.nccl_worker(rank, 1, *args[1:])  # rank 0 alone, as if its peer had vanished


# -- the card assignment --------------------------------------------------------------


def test_shard_i_takes_card_i_mod_n():
    cards = torch_multicard.card_list(4, "cuda")
    assert torch_multicard.shard_devices(6, cards) == [torch.device("cuda", i) for i in (0, 1, 2, 3, 0, 1)]
    assert torch_multicard.shard_devices(4, cards[:2]) == [torch.device("cuda", i) for i in (0, 1, 0, 1)]
    assert torch_multicard.card_list(2, "cpu") == [torch.device("cpu", 0), torch.device("cpu", 1)]


def test_fuzz_mesh_cards_places_shard_i_on_card_i_mod_n(monkeypatch):
    """`torch_fuzz_parity.py --mesh --cards N`: the mesh's shard i on device
    i mod N and the local path on card 0; without `--cards`, every shard on
    the one device, as before."""
    seen = []

    class Stop(Exception):
        pass

    def make_mesh(axes, devices):
        seen.append(list(devices))
        raise Stop

    monkeypatch.setattr(hsc_torch.parallel, "make_mesh", make_mesh)
    for cards in (None, 2, 3):
        with pytest.raises(Stop):
            torch_fuzz_parity.run_mesh_shape(2001, "cpu", cards=cards)  # 2 shards
    with pytest.raises(Stop):
        torch_fuzz_parity.run_mesh_shape(2002, "cpu", cards=3)  # 4 shards
    assert seen == [[torch.device("cpu")] * 2, [torch.device("cpu", i) for i in (0, 1)],
                    [torch.device("cpu", i) for i in (0, 1)], [torch.device("cpu", i) for i in (0, 1, 2, 0)]]
    with pytest.raises(SystemExit):
        torch_fuzz_parity.main(["--cards", "2", "--device", "cpu", "--shapes", "1"])


def test_rank_p_takes_card_p(monkeypatch):
    """`initialize_distributed` on a host with cards: NCCL, and rank p on
    card p (p mod the card count)."""
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["init_method"], kw["world_size"], kw["rank"])))
    for p in range(4):
        initialize_distributed("127.0.0.1:1234", 4, p)
    initialize_distributed("127.0.0.1:1234", 6, 5)
    initialize_distributed("127.0.0.1:1234", 1, 0)  # one process: nothing
    assert calls == [x for p in range(4) for x in (("set_device", p), ("nccl", "tcp://127.0.0.1:1234", 4, p))] + [
        ("set_device", 1), ("nccl", "tcp://127.0.0.1:1234", 6, 5)]


def test_cli_mesh_takes_the_first_n_cards(monkeypatch, tmp_path):
    """`--mesh N --device cuda` builds its mesh on ``cuda:0`` .. ``cuda:N-1``
    and the codec on the current card."""
    from hsc_torch import MultilevelDictionary, make_test_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    built = {}

    class Stop(Exception):
        pass

    def codec(mld, *, device, mesh, **kw):
        built.update(device=device, mesh=list(mesh.devices.flat))
        raise Stop

    monkeypatch.setattr(hsc_torch.runtime, "CorpusEncoder", codec)
    MultilevelDictionary.generate(make_test_config(**torch_multicard.SMALL.flat), seed=7).save(str(tmp_path / "d.npz"))
    for n in (1, 3):
        with pytest.raises(Stop):
            hsc_torch.cli.main(["encode", "--dict", str(tmp_path / "d.npz"), "--input", "x.npy",
                                "--output", str(tmp_path / "c.hsct"), "--mesh", str(n), "--device", "cuda"])
        assert built == {"device": torch.device("cuda"), "mesh": [torch.device("cuda", i) for i in range(n)]}


def test_canonical_device_keeps_the_current_card(monkeypatch):
    """``'cuda'`` becomes the card current when an object is built, so a
    coder or a learner keeps its card when another becomes current (the
    fault `torch_multicard.py`'s card-switch check found: the coder's
    tensors stayed on card 0 while its uploads followed the current card);
    `resolve_device` itself keeps what it was given."""
    from hsc_torch.device import canonical_device
    from hsc_torch.parallel import make_mesh

    current = [2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    dev = canonical_device("cuda")
    current[0] = 1
    assert dev == torch.device("cuda", 2) and canonical_device("cuda") == torch.device("cuda", 1)
    assert canonical_device("cuda:3") == torch.device("cuda", 3)
    assert canonical_device(torch.device("cuda")) == torch.device("cuda", 1)
    assert canonical_device("cpu") == torch.device("cpu") and canonical_device("cpu:1") == torch.device("cpu", 1)
    assert resolve_device("cuda") == torch.device("cuda")
    mesh = make_mesh({"data": 2}, devices=["cuda", "cuda:0"])
    assert list(mesh.devices.flat) == [torch.device("cuda", 1), torch.device("cuda", 0)]


def test_objects_store_the_canonical_device(monkeypatch):
    """Every class that holds tensors stores `canonical_device` of its
    ``device=``: the coders, the learners, the trainer and a replica."""
    import hsc_torch.device
    from hsc_torch import MultilevelDictionary, make_test_config
    from hsc_torch.learn import (
        ConvolutionalDictionaryLearner,
        MultilevelTrainer,
        OnlineConvolutionalDictionaryLearner,
    )
    from hsc_torch.models import HierarchicalConvolutionalSparseCoder

    seen = []
    real = hsc_torch.device.canonical_device

    def spy(device):
        seen.append(str(device))
        return real(device)

    for module in (hsc_torch.models.coder, hsc_torch.parallel.dp, hsc_torch.learn.kmeans, hsc_torch.learn.online,
                   hsc_torch.learn.trainer):
        monkeypatch.setattr(module, "canonical_device", spy)
    mld = MultilevelDictionary.generate(make_test_config(**torch_multicard.SMALL.flat), seed=7)
    coder = HierarchicalConvolutionalSparseCoder(mld, device="cpu")
    assert seen == ["cpu", "cpu"]  # the hierarchy and its level's greedy loop
    builds = (
        lambda: hsc_torch.parallel.dp.replica(coder, "cpu:1"),
        lambda: ConvolutionalDictionaryLearner(8, 8, device="cpu:0"),
        lambda: OnlineConvolutionalDictionaryLearner(mld.dicts[0], device="cpu:1"),
        lambda: MultilevelTrainer(mld.config, device="cpu:0"),
    )
    for build, want in zip(builds, ("cpu:1", "cpu:0", "cpu:1", "cpu:0")):
        seen.clear()
        obj = build()
        assert seen[:1] == [want] and obj.device == torch.device(want)


# -- chip_smoke.py phase 21 -----------------------------------------------------------


def test_phase_21_does_not_run_on_one_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail("phase 21 ran a command on one card"))
    assert chip_smoke.multicard() == {"cards": 1, "ran": False}
    assert capsys.readouterr().out == "[21] not run: 1 card visible\n"


@pytest.mark.parametrize("visible,ok", [(2, True), (8, True), (4, False)])
def test_phase_21_runs_the_script_on_up_to_4_cards(monkeypatch, capsys, visible, ok):
    """With 2 or more cards phase 21 runs `torch_multicard.py --mode all
    --cards min(4, N)`, logs its lines and fails on a failed check."""
    cards = min(visible, 4)
    summary = {"summary": True, "ok": ok, "cards": cards, "checks": 17, "failed": [] if ok else ["sp"]}
    ran = []

    def run(cmd, **kw):
        ran.append(cmd)
        return subprocess.CompletedProcess(cmd, 0 if ok else 1, stdout='{"check": "sp"}\n' + json.dumps(summary),
                                           stderr="")

    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(subprocess, "run", run)
    if ok:
        out = chip_smoke.multicard()
        assert out["cards"] == cards and out["ran"] and out["checks"] == 17
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.multicard()
    (cmd,) = ran
    assert cmd[1].endswith(os.path.join("scripts", "torch_multicard.py"))
    assert cmd[2:] == ["--mode", "all", "--cards", str(cards)]
    assert '[21] {"check": "sp"}' in capsys.readouterr().out


def test_measure_mode_on_the_cpu(capsys):
    """`--mode measure` through `main`: the corpus codec's rates on one
    device and on the 2-device mesh (their containers and rows the same,
    the journaled encode's too), then the same corpus through 2 gloo
    processes; no device metric is reported from the CPU."""
    assert torch_multicard.main(["--device", "cpu", "--small", "--mode", "measure"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    rates, nccl, summary = lines
    assert rates["check"] == "corpus_rates" and rates["ok"] and rates["blocks"] == 6
    assert all(len(rates[f"{k}_mb_s"]) == 3 for k in ("encode_one", "encode_mesh", "decode_one", "decode_mesh",
                                                      "encode_one_journal"))
    assert not any(k.endswith("_idle") for k in rates)
    assert nccl["check"] == "corpus_flat" and nccl["ok"] and nccl["processes"] == 2 and nccl["blocks"] == 6
    assert summary["ok"] and summary["device"] == "cpu" and summary["smi"] == []


def test_main_without_a_card_exits(capsys):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        torch_multicard.main([])


# -- on the card ---------------------------------------------------------------------


@pytest.mark.cuda
def test_two_cards(tmp_path):
    """The script's mesh and multi-process modes at the small geometry on
    the first two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 NVIDIA GPUs ({torch.cuda.device_count()} visible)")
    cards = torch_multicard.card_list(2, "cuda")
    lines = torch_multicard.MeshChecks(cards, torch_multicard.SMALL, str(tmp_path)).run()
    lines += torch_multicard.run_nccl(cards, torch_multicard.SMALL, str(tmp_path), timeout=300)
    assert all(line["ok"] for line in lines), [line for line in lines if not line["ok"]]
