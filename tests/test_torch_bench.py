"""The port's headline bench, `scripts/torch_bench.py`, on the CPU.

Its cells are `bench.py`'s: the configs, seeds, rates, batch and tile
counts, windows and the k-means geometry are read from `bench.py`'s source
by AST (`bench.py` never runs here) and held against the port's constants,
and so are its JSON keys and metric string.  One run at the small CPU
geometry (`--device cpu`, the plain paths) prints one JSON line with every
key, its checks pass, and with JAX's init injected the first batch of each
flat cell is bitwise `hsc_tpu`'s pinned oracle (`tests/pinned.py`).  Each
check the bench makes raises when its plain version is fed a changed event,
row or repeat; without a card the script exits with the port's device error.
"""

import ast
import importlib
import json
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsc_tpu
from hsc_tpu.ops.encode import encode_init_jax

import hsc_torch.models.coder
import hsc_torch.ops.decode
import hsc_torch.ops.encode
import hsc_torch.ops.pipeline
import hsc_torch.learn.kmeans
from hsc_torch.params import dictionary_from_arrays

from pinned import oracle_encode_pinned

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

# keys only the port prints
PORT_ONLY = {"device", "encode_ns1_mb_s", "launches"}
KERNELS = {"mp_encode", "int_decode", "sparse_init", "ordered_decode"}


def bench():
    return importlib.import_module("torch_bench")


def _bench_main():
    path = os.path.join(REPO, "bench.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    (main,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main"]
    return main


def _calls(node, name):
    """The calls of `name` (a function or a method) under `node`, in source
    order, as {keyword: literal}."""
    calls = [n for n in ast.walk(node) if isinstance(n, ast.Call)
             and getattr(n.func, "id", getattr(n.func, "attr", None)) == name]
    calls.sort(key=lambda n: (n.lineno, n.col_offset))
    return [{k.arg: ast.literal_eval(k.value) for k in c.keywords
             if isinstance(k.value, ast.Constant | ast.Tuple)} for c in calls]


def _accelerator_values(main) -> dict:
    """Every `NAME = <accelerator number> if on_tpu else <CPU number>` of
    `main` -> {NAME: accelerator number} (tuple targets unpacked)."""
    out = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.IfExp) \
                and getattr(node.value.test, "id", None) == "on_tpu" \
                and isinstance(node.value.body, ast.Constant | ast.Tuple):
            value = ast.literal_eval(node.value.body)
            if isinstance(value, str):  # a backend's name, not a size
                continue
            (target,) = node.targets
            if isinstance(target, ast.Tuple):
                out.update(zip((t.id for t in target.elts), value))
            else:
                out[target.id] = value
    return out


def test_cells_are_bench_py():
    """Each config, seed, rate, batch and tile count, window, the k-means
    geometry, the oracle's coefficients and the repeats are bench.py's."""
    tb, main = bench(), _bench_main()
    card = tb.CARD
    assert _calls(main, "make_test_config") == [card["flat"], card["hier"], card["flagship"]]
    assert [c["seed"] for c in _calls(main, "generate")] == [tb.FLAT_SEEDS[0]] + [tb.HIER_SEEDS[0]] * 2
    assert [c["seed"] for c in _calls(main, "generate_signals")] == [tb.FLAT_SEEDS[1]] + [tb.HIER_SEEDS[1]] * 2
    assert [c["rates"] for c in _calls(main, "SignalGenerator")] == [tb.RATES] * 3
    values = _accelerator_values(main)
    assert values == {
        "B": card["batch"], "NBATCH": card["batches"], "DB": card["integer_tiles"],
        "DBO": card["ordered_tiles"], "HB": card["hier_batch"], "HNB": card["hier_batches"],
        "FB": card["flagship_batch"], "FNB": card["flagship_batches"],
        "M": card["kmeans"][0], "D": card["kmeans"][1], "K": card["kmeans"][2], "ITERS": card["kmeans"][3],
    }
    # the flat cell at window=None, then the decode cells' batch at the default
    coefs = card["flat"]["num_coefs"][0]
    assert _calls(main, "encode_batches_pipelined") == [{"num_coefs": coefs, "window": None}, {"num_coefs": coefs}]
    hier_runs = _calls(main, "encode_hierarchical_batches_pipelined")
    assert [r.get("window") for r in hier_runs] == [tb.HIER_WINDOW, None]
    assert [c["num_coefs"] for c in _calls(main, "mp_encode")] == [tb.ORACLE_WARM_COEFS,
                                                                    card["flat"]["num_coefs"][0]]
    loops = [ast.literal_eval(n.iter.args[0]) for n in ast.walk(main) if isinstance(n, ast.For)
             and getattr(n.iter, "func", None) is not None and getattr(n.iter.func, "id", None) == "range"]
    assert sorted(loops) == [tb.ORACLE_REPEATS] + [tb.REPEATS] * 6
    (ns,) = [ast.literal_eval(n.iter) for n in ast.walk(main) if isinstance(n, ast.For)
             and getattr(n.target, "id", None) == "ns"]
    assert ns == tb.NUM_SELECT
    (rng,) = [n for n in ast.walk(main) if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "default_rng"]
    assert ast.literal_eval(rng.args[0]) == tb.KMEANS_SEED


def bench_keys() -> tuple[set, str]:
    """The keys of bench.py's JSON line, and its metric string."""
    (dumps,) = [n for n in ast.walk(_bench_main()) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps"]
    (d,) = dumps.args
    keys = [k.value for k in d.keys]
    return set(keys), ast.literal_eval(d.values[keys.index("metric")])


def test_keys_are_bench_py():
    keys, metric = bench_keys()
    assert bench().METRIC == metric and "TPU" not in metric
    assert not keys & PORT_ONLY


def _jax_init(xb, bank):
    """JAX's single-block init of each block (`encode_init_jax`, as
    `tests/pinned.py` injects it into the oracle), batched."""
    outs = [encode_init_jax(jnp.asarray(x), jnp.asarray(bank.numpy())) for x in xb.numpy()]
    return tuple(torch.from_numpy(np.stack([np.asarray(o[j]) for o in outs])) for j in range(3))


def test_cpu_run_matches_jax(monkeypatch, capsys):
    """`--device cpu`: one JSON line last with bench.py's keys and the
    port's, every rate finite, no launch on the CPU; with JAX's init where
    the port looks it up, the first batch of the flat cell at each
    num_select is bitwise `hsc_tpu`'s pinned oracle, block by block."""
    for module in (hsc_torch.ops.pipeline, hsc_torch.ops.encode, hsc_torch.models.coder):
        monkeypatch.setattr(module, "encode_init_batched", _jax_init)
    first = {}
    encode = hsc_torch.ops.pipeline.encode_batches_pipelined

    def recording(batches, *args, **kwargs):
        out = encode(batches, *args, **kwargs)
        if kwargs.get("window", 8) is None:  # the flat cell's runs
            first.setdefault(kwargs["num_select"], (batches[0], out[0]))
        return out

    monkeypatch.setattr(hsc_torch.ops.pipeline, "encode_batches_pipelined", recording)
    tb = bench()
    out = tb.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    keys, metric = bench_keys()
    assert set(out) == keys | PORT_ONLY and out["metric"] == metric
    assert out["platform"] == "cpu" and out["device"] == "cpu" and out["unit"] == "MB/s"
    assert out["launches"] == dict.fromkeys(KERNELS, 0)
    assert all(math.isfinite(v) and v > 0 for k, v in out.items() if k.endswith("mb_s") or k in
               ("value", "vs_baseline", "learn_mwindows_s"))

    assert sorted(first) == list(tb.NUM_SELECT)
    cfg = hsc_tpu.make_test_config(**tb.SMALL["flat"])
    mld = hsc_tpu.MultilevelDictionary.generate(cfg, seed=tb.FLAT_SEEDS[0])
    assert dictionary_from_arrays(cfg.to_json(), mld.dicts).augmented(0).tobytes() == mld.augmented(0).tobytes()
    for ns, (xb, enc) in first.items():
        assert enc.count.shape == (tb.SMALL["batch"],)
        for b in range(tb.SMALL["batch"]):
            want = oracle_encode_pinned(xb[b], mld, num_select=ns)
            n = int(enc.count[b])
            assert n == want.positions.shape[0] > 0, (ns, b)
            for f in ("positions", "atoms", "codes"):
                assert getattr(enc, f)[b, :n].numpy().tobytes() == getattr(want, f).tobytes(), (ns, b, f)
            assert enc.scale[b].numpy().tobytes() == np.float32(want.scale).tobytes(), (ns, b)


def test_without_device_needs_a_card(monkeypatch):
    """No --device: the bench asks for the card and exits with the port's
    device error on a host without one; there is no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench().main([])
    msg = str(e.value.code)
    assert "torch.cuda.is_available() is False" in msg and "--device cuda" in msg


def _one_ulp(t):
    """`t` with its first element one ulp (or one) up."""
    t = t.clone()
    t.view(torch.int32).reshape(-1)[0] += 1
    return t


def _changed_event(fn):
    def changed(*args, **kwargs):
        out = fn(*args, **kwargs)
        return out._replace(codes=_one_ulp(out.codes))
    return changed


def _changed_output(fn):
    return lambda *args, **kwargs: _one_ulp(fn(*args, **kwargs))


def _changed_top_level(fn):
    def changed(self, xs):
        levels = fn(self, xs)
        return [*levels[:-1], levels[-1]._replace(atoms=_one_ulp(levels[-1].atoms))]
    return changed


def _changed_third_run(fn):
    calls = []

    def changed(*args, **kwargs):
        calls.append(1)
        cents, objectives = fn(*args, **kwargs)
        return (_one_ulp(cents) if len(calls) == 3 else cents), objectives
    return changed


NEGATIVE = {  # cell -> (module, name, change, the message's start)
    "flat": (hsc_torch.ops.encode, "mp_encode_from_init_torch", _changed_event,
             "flat encode, num_select 1: codes of the first"),
    "integer": (hsc_torch.ops.decode, "mp_decode_integer_batch_torch", _changed_output,
                "integer decode: the rows of one"),
    "ordered": (hsc_torch.ops.decode, "mp_decode_batch_torch", _changed_output,
                "ordered decode: the rows of one"),
    "hier": (hsc_torch.models.coder.HierarchicalConvolutionalSparseCoder, "encode_batch_device",
             _changed_top_level, "hierarchical encode: the top level's atoms"),
    "repeat": (hsc_torch.learn.kmeans, "kmeans_refine_device", _changed_third_run,
               "k-means: a timed run returned other results"),
}


@pytest.mark.parametrize("cell", sorted(NEGATIVE))
def test_a_check_fails_on_a_changed_value(monkeypatch, cell):
    """Each check the bench makes raises when its plain version (or a timed
    repeat) gives one value one ulp off."""
    tb = bench()
    module, name, change, message = NEGATIVE[cell]
    monkeypatch.setattr(module, name, change(getattr(module, name)))
    dev, geo = torch.device("cpu"), tb.SMALL
    with pytest.raises(AssertionError, match=message):
        if cell == "flat":
            tb.flat_cells(dev, geo, *tb.flat_data(geo))
        elif cell in ("integer", "ordered"):
            tb.decode_cells(dev, geo, *tb.flat_data(geo))
        elif cell == "hier":
            tb.hier_cell(dev, geo["hier"], geo["hier_batch"], geo["hier_batches"], tb.HIER_WINDOW,
                         "hierarchical encode")
        else:
            tb.kmeans_cell(dev, geo)
