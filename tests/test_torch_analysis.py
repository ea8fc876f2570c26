"""The port's analysis module (`hsc_torch.analysis`) against the JAX package on
the CPU.

Mirrors tests/test_analysis.py.  Every NumPy function (the rate accounting,
the oracle rate-distortion curves, the decode-mode table and the per-level
diagnostics) gives exactly JAX's output.  `rate_distortion_curve(
use_device=True, device="cpu")`, JAX's level-0 init injected so both encode
the same events, gives JAX's rates exactly and its SNR to 1e-3 dB: the
port's ordered decode rounds each product where JAX's batched decode may
fuse a multiply-add."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hsc_tpu.analysis as jax_analysis
from hsc_tpu import SignalGenerator
from hsc_tpu.io import pack_corpus
from hsc_tpu.oracle import hierarchical_encode, mp_encode
from hsc_tpu.oracle.mp import to_top_level
from hsc_tpu.ops.encode import encode_init_batched as jax_init

import hsc_torch.analysis as port_analysis
import hsc_torch.models.coder
from hsc_torch.config import CodecConfig
from hsc_torch.params import dictionary_from_arrays


def _port(mld):
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


def test_same_exports():
    assert port_analysis.__all__ == jax_analysis.__all__
    assert len(port_analysis.__all__) == 11


def test_bits_for_dtype():
    for dt in (np.float32, np.float64, np.int16, np.int8):
        assert port_analysis.bits_for_dtype(dt) == jax_analysis.bits_for_dtype(dt)


@pytest.mark.parametrize("entropy", ["fixed", "rice"])
def test_stream_and_corpus_rates_equal_jax(mld1, signal1, entropy):
    cfg = dataclasses.replace(mld1.config, entropy=entropy)
    stream = mp_encode(signal1[:, None], mld1.augmented(0), mld1.gram(0), num_coefs=cfg.num_coefs[0])
    pcfg = CodecConfig.from_json(cfg.to_json())
    got = port_analysis.stream_rate(pcfg, 0, stream)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_analysis.stream_rate(cfg, 0, stream))
    blocks = [[(0, stream)], [(0, stream)]]
    agg = port_analysis.corpus_rates(pcfg, iter(blocks))
    assert agg == jax_analysis.corpus_rates(cfg, blocks)
    assert 0 < len(pack_corpus(cfg, blocks)) - agg["total_bytes"] < 256


def test_multilevel_rates_equal_jax(mld2, signal2):
    streams = hierarchical_encode(signal2, mld2)
    got = port_analysis.multilevel_information_rates(_port(mld2).config, streams)
    want = jax_analysis.multilevel_information_rates(mld2.config, streams)
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert [r.level for r in got] == [0, 1] and got[1].bits_per_sample < 32


def test_rate_distortion_oracle_curves_equal_jax(mld1, mld2):
    xs1 = SignalGenerator(mld1, rates=4e-3).generate_signals(2, mld1.config.block_size, seed=77)
    curve = port_analysis.rate_distortion_curve(_port(mld1), xs1, [8, 32, 64])
    assert curve == jax_analysis.rate_distortion_curve(mld1, xs1, [8, 32, 64])
    assert [p[0] for p in curve] == sorted(p[0] for p in curve)
    assert [p[1] for p in curve] == sorted(p[1] for p in curve)
    xs2 = SignalGenerator(mld2, rates=[np.full(12, 4e-3), np.full(8, 1e-3)]).generate_signals(
        2, mld2.config.block_size, seed=88)
    hier = port_analysis.hierarchical_rate_distortion_curve(_port(mld2), xs2, [8, 24, 48])
    assert hier == jax_analysis.hierarchical_rate_distortion_curve(mld2, xs2, [8, 24, 48])


def test_rate_distortion_device_vs_jax_and_oracle(monkeypatch, mld1):
    """use_device=True on the CPU: without injection, rates equal the
    oracle's and SNR is within 0.15 dB of the tracked one (as the JAX test
    holds JAX); with JAX's init injected, JAX's rates exactly and its SNR
    to 1e-3 dB."""
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(2, mld1.config.block_size, seed=78)
    budgets = [8, 32, 64]
    port = _port(mld1)
    oracle = port_analysis.rate_distortion_curve(port, xs, budgets, use_device=False)
    device = port_analysis.rate_distortion_curve(port, xs, budgets, use_device=True, device="cpu")
    for (ro, so), (rd, sd) in zip(oracle, device):
        assert ro == rd and abs(so - sd) < 0.15

    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(hsc_torch.models.coder, "encode_init_batched", init)
    got = port_analysis.rate_distortion_curve(port, xs, budgets, use_device=True, device="cpu")
    want = jax_analysis.rate_distortion_curve(mld1, xs, budgets, use_device=True)
    for (rg, sg), (rw, sw) in zip(got, want):
        assert rg == rw and abs(sg - sw) < 1e-3, (sg, sw)


def test_decode_mode_fidelity_equal_jax(mld2, signal2):
    rows = port_analysis.decode_mode_fidelity(_port(mld2), signal2[None, :], rep_bits_list=(6, 12))
    assert rows == jax_analysis.decode_mode_fidelity(mld2, signal2[None, :], rep_bits_list=(6, 12))
    ints = [r for r in rows if r["mode"] == "integer"]
    assert rows[0]["mode"] == "ordered" and ints[1]["vs_ordered_db"] > ints[0]["vs_ordered_db"]
    assert abs(ints[1]["delta_db"]) < 0.01


@pytest.mark.parametrize("distributed", [False, True])
def test_level_diagnostics_equal_jax(mld2, signal2, distributed):
    """`level_energies` and `coefficient_distribution` on a per-level block
    and on a top-level-only block, both views."""
    cfg = mld2.config
    streams = hierarchical_encode(signal2, mld2)
    blocks = [[(lv, s) for lv, s in enumerate(streams)],
              [(cfg.num_levels - 1, to_top_level(cfg, list(enumerate(streams))))]]
    port = _port(mld2)
    got = port_analysis.level_energies(port, iter(blocks), distributed=distributed)
    assert got == jax_analysis.level_energies(mld2, blocks, distributed=distributed)
    assert abs(sum(v["fraction"] for v in got.values()) - 1.0) < 1e-9
    dist = port_analysis.coefficient_distribution(port.config, iter(blocks), distributed=distributed)
    assert dist == jax_analysis.coefficient_distribution(cfg, blocks, distributed=distributed)


def test_visualizations(tmp_path, mld2, signal2):
    port_analysis.visualize_rate_distortion({"flat": [(0.5, 5.0), (1.0, 10.0)]}, path=str(tmp_path / "rd.png"))
    streams = hierarchical_encode(signal2, mld2)
    port_analysis.visualize_level_diagnostics(
        _port(mld2), [[(lv, s) for lv, s in enumerate(streams)]], path=str(tmp_path / "diag.png"),
        distributed=True)
    assert (tmp_path / "rd.png").exists() and (tmp_path / "diag.png").exists()
