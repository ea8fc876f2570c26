"""The port's own copies of the JAX package's NumPy modules (`hsc_torch.config`,
`.dictionary`, `.signal`, `.oracle`, `.io`, `.utils`, `.analysis`) against
their `hsc_tpu` originals on the CPU, with exact equality: the same configs,
the same dictionary arrays, signals, synthesized audio and WAV files,
container bytes (both entropies, the native and the NumPy packer) and
oracle outputs on seeded inputs.  The verbatim copies (`signal`,
`io.journal`, `utils.metrics`, `analysis.diagnostics`, and
`analysis.rates` but for `rate_distortion_curve`) are also held to their
originals' code, statement for statement."""

import ast
import dataclasses
import inspect
import os

import numpy as np
import pytest

import hsc_tpu.analysis.diagnostics
import hsc_tpu.analysis.rates
import hsc_tpu.config
import hsc_tpu.dictionary
import hsc_tpu.signal
import hsc_tpu.utils
import hsc_tpu.utils.metrics
from hsc_tpu import oracle as tpu_oracle
from hsc_tpu.io import bitstream as tpu_bitstream
from hsc_tpu.io import journal as tpu_journal
from hsc_tpu.io import native as tpu_native
from hsc_tpu.oracle import mp as tpu_mp

import hsc_torch.analysis.diagnostics
import hsc_torch.analysis.rates
import hsc_torch.config
import hsc_torch.dictionary
import hsc_torch.signal
import hsc_torch.utils
import hsc_torch.utils.metrics
from hsc_torch import oracle as port_oracle
from hsc_torch.io import bitstream as port_bitstream
from hsc_torch.io import journal as port_journal
from hsc_torch.io import native as port_native
from hsc_torch.oracle import mp as port_mp
from hsc_torch.params import dictionary_from_arrays

CONFIGS = {
    "cfg1": dict(),
    "cfg2": dict(counts=(12, 8), scales=(16, 48), num_coefs=(96, 48), block_size=1024),
    "flagship": dict(counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,), num_select=8),
    "flagship_hier": dict(
        counts=(64, 32), scales=(32, 96), block_size=16384, num_coefs=(512, 192), num_select=8
    ),
    "three_level_rice": dict(
        counts=(10, 6, 4), scales=(12, 36, 90), num_coefs=(96, 48, 24), entropy="rice",
        decode_mode="ordered",
    ),
}


def _pair(overrides):
    return (hsc_tpu.config.make_test_config(**overrides),
            hsc_torch.config.make_test_config(**overrides))


def _mld_pair(overrides, seed):
    tpu_cfg, _ = _pair(overrides)
    tpu = hsc_tpu.dictionary.MultilevelDictionary.generate(tpu_cfg, seed=seed)
    return tpu, hsc_torch.dictionary.MultilevelDictionary.generate(
        hsc_torch.config.CodecConfig.from_json(tpu_cfg.to_json()), seed=seed
    )


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _streams_equal(a, b):
    return all(_same(getattr(a, f), getattr(b, f)) for f in ("positions", "atoms", "codes")) and (
        np.float32(a.scale) == np.float32(b.scale)
        and a.energy0 == b.energy0 and a.energy_res == b.energy_res
    )


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_json_round_trip(name):
    tpu, port = _pair(CONFIGS[name])
    assert port.to_json() == tpu.to_json()
    assert dataclasses.asdict(port) == dataclasses.asdict(tpu)
    assert hsc_torch.config.CodecConfig.from_json(tpu.to_json()) == port
    assert hsc_tpu.config.CodecConfig.from_json(port.to_json()) == tpu
    for level in range(tpu.num_levels):
        for fn in ("seq_len", "num_positions", "pos_bits", "atom_bits", "event_bits"):
            assert getattr(port, fn)(level) == getattr(tpu, fn)(level), fn
    for prop in ("window_sizes", "counts_with_singletons", "channels", "amp_maxcode"):
        assert getattr(port, prop) == getattr(tpu, prop), prop
    # a header written before hier_init existed parses as 'f32' in both
    old = tpu.to_json().replace(f',"hier_init":"{tpu.hier_init}"', "")
    assert hsc_torch.config.CodecConfig.from_json(old) == hsc_torch.config.CodecConfig(
        **{**dataclasses.asdict(tpu), "hier_init": "f32"}
    )


@pytest.mark.parametrize("bad", [dict(counts=(0,)), dict(scales=(16, 8), counts=(4, 4), num_coefs=(8, 8)),
                                 dict(amp_bits=17), dict(entropy="zip"), dict(rep_bits=13)])
def test_config_rejects_what_the_original_rejects(bad):
    with pytest.raises(ValueError) as tpu_err:
        hsc_tpu.config.make_test_config(**bad)
    with pytest.raises(ValueError) as port_err:
        hsc_torch.config.make_test_config(**bad)
    assert str(port_err.value) == str(tpu_err.value)


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_dictionary_arrays(seed):
    """Raw arrays, augmented banks, representations and Grams of a 3-level
    dictionary; `dictionary_from_arrays` rebuilds the same object."""
    tpu, port = _mld_pair(CONFIGS["three_level_rice"], seed)
    carried = dictionary_from_arrays(tpu.config.to_json(), tpu.dicts)
    for mld in (port, carried):
        assert mld.config == hsc_torch.config.CodecConfig.from_json(tpu.config.to_json())
        for level in range(tpu.config.num_levels):
            assert _same(mld.dicts[level], tpu.dicts[level])
            assert _same(mld.augmented(level), tpu.augmented(level))
            assert _same(mld.representations(level), tpu.representations(level))
            assert _same(mld.gram(level), tpu.gram(level))
            assert mld.num_atoms(level) == tpu.num_atoms(level)
            if level:
                for x, y in zip(mld.decompositions(level), tpu.decompositions(level)):
                    assert all(_same(u, v) for u, v in zip(x, y))
    assert carried.dicts[0] is not tpu.dicts[0]
    up = port.up_to_level(1)
    assert up.config.num_levels == 2 and _same(up.gram(1), tpu.up_to_level(1).gram(1))
    bank = np.random.default_rng(seed).standard_normal((5, 9, 3)).astype(np.float32)
    assert _same(hsc_torch.dictionary.bank_gram(bank), hsc_tpu.dictionary.bank_gram(bank))


def test_dictionary_save_load_across_packages(tmp_path):
    tpu, port = _mld_pair(CONFIGS["cfg2"], 3)
    tpu.save(str(tmp_path / "d.npz"))
    loaded = hsc_torch.dictionary.MultilevelDictionary.load(str(tmp_path / "d.npz"))
    assert loaded.config == port.config
    assert all(_same(a, b) for a, b in zip(loaded.dicts, port.dicts))


@pytest.mark.parametrize("rates", ["scalar", "per_level"])
def test_signal_generator(rates):
    tpu, port = _mld_pair(CONFIGS["cfg2"], 11)
    r = 4e-3 if rates == "scalar" else [np.full(12, 4e-3), np.full(8, 1e-3)]
    gt = hsc_tpu.signal.SignalGenerator(tpu, rates=r)
    gp = hsc_torch.signal.SignalGenerator(port, rates=r)
    assert _same(gp.generate_signals(3, 1024, seed=5), gt.generate_signals(3, 1024, seed=5))
    ev_t, ev_p = gt.generate_events(1024, seed=9), gp.generate_events(1024, seed=9)
    assert [dataclasses.astuple(e) for e in ev_p] == [dataclasses.astuple(e) for e in ev_t]
    assert _same(gp.generate_signal_from_events(ev_p, 1024), gt.generate_signal_from_events(ev_t, 1024))


def test_utils():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    for axis in (None, 0, 1):
        assert _same(hsc_torch.utils.normalize(x, axis=axis), hsc_tpu.utils.normalize(x, axis=axis))
    y = x + rng.standard_normal(x.shape).astype(np.float32) * 0.1
    for a, b in ((x, y), (x, x), (np.zeros(3), np.ones(3))):
        assert hsc_torch.utils.snr_db(a, b) == hsc_tpu.utils.snr_db(a, b)


def _corpus(entropy):
    """A few hierarchical blocks encoded by the oracle: top-only and
    distributed records, with an empty stream."""
    tpu, port = _mld_pair(dict(CONFIGS["cfg2"], entropy=entropy), 11)
    xs = hsc_tpu.signal.SignalGenerator(tpu, rates=4e-3).generate_signals(3, 1024, seed=5)
    xs[2] = 0.0
    blocks = []
    for x in xs:
        top = tpu_mp.hierarchical_encode(x, tpu)[-1]
        blocks.append([(1, top)])
        blocks.append(tpu_mp.to_distributed(tpu.config, top))
    blocks.append([])
    return tpu, port, blocks


@pytest.mark.parametrize("packer", ["native", "numpy"])
@pytest.mark.parametrize("entropy", ["fixed", "rice"])
def test_container_bytes(monkeypatch, entropy, packer):
    tpu, port, blocks = _corpus(entropy)
    if packer == "numpy":
        for mod in (tpu_native, port_native):
            monkeypatch.setattr(mod, "_tried", True)
            monkeypatch.setattr(mod, "_lib", None)
    else:
        assert port_native.available() and tpu_native.available()
    for index in (False, True):
        want = tpu_bitstream.pack_corpus(tpu.config, blocks, index=index)
        got = port_bitstream.pack_corpus(port.config, blocks, index=index)
        assert got == want
    cfg_t, dec_t = tpu_bitstream.unpack_corpus(want)
    cfg_p, dec_p = port_bitstream.unpack_corpus(want)
    assert cfg_p.to_json() == cfg_t.to_json()
    assert len(dec_p) == len(dec_t) == len(blocks)
    for bp, bt in zip(dec_p, dec_t):
        assert [lv for lv, _ in bp] == [lv for lv, _ in bt]
        assert all(_streams_equal(a, b) for (_, a), (_, b) in zip(bp, bt))
    assert _same(port_bitstream.read_index(want), tpu_bitstream.read_index(want))
    assert _same(port_bitstream.scan_block_offsets(want)[1], tpu_bitstream.scan_block_offsets(want)[1])
    assert port_bitstream.peek_corpus_header(want)[1] == len(blocks)
    assert [[lv for lv, _ in b] for b in port_bitstream.iter_blocks(want)] == [
        [lv for lv, _ in b] for b in tpu_bitstream.iter_blocks(want)
    ]


@pytest.mark.parametrize("ns,tol", [(1, None), (4, None), (3, 12.0)])
def test_oracle_encode_and_decodes(ns, tol):
    """`mp_encode` (own init and an injected one), `mp_decode`,
    `rep_quantize` / `mp_decode_integer` and the feature maps."""
    tpu, port = _mld_pair(dict(CONFIGS["cfg1"], num_select=ns, tolerance_snr=tol), 7)
    cfg = tpu.config
    x = hsc_tpu.signal.SignalGenerator(tpu, rates=4e-3).generate_signals(1, cfg.block_size, seed=3)[0]
    kw = dict(num_coefs=cfg.num_coefs[0], amp_bits=cfg.amp_bits, tolerance_snr=tol, num_select=ns)
    st_t = tpu_mp.mp_encode(x, tpu.augmented(0), tpu.gram(0), **kw)
    st_p = port_mp.mp_encode(x, port.augmented(0), port.gram(0), **kw)
    assert _streams_equal(st_p, st_t) and st_p.positions.shape[0] > 0
    s0 = np.random.default_rng(1).standard_normal((cfg.counts[0], cfg.num_positions(0))).astype(np.float32)
    inj = dict(kw, scores0=s0, energy0=123.0)
    assert _streams_equal(port_mp.mp_encode(x, port.augmented(0), port.gram(0), **inj),
                          tpu_mp.mp_encode(x, tpu.augmented(0), tpu.gram(0), **inj))
    assert _same(port_mp.correlate_bank(x[:, None], port.augmented(0)),
                 tpu_mp.correlate_bank(x[:, None], tpu.augmented(0)))
    assert _same(port_mp.mp_decode(st_p, port.augmented(0), cfg.block_size),
                 tpu_mp.mp_decode(st_t, tpu.augmented(0), cfg.block_size))
    rq_t, step_t = tpu_mp.rep_quantize(tpu.representations(0)[:, :, None], cfg.rep_bits)
    rq_p, step_p = port_mp.rep_quantize(port.representations(0)[:, :, None], cfg.rep_bits)
    assert _same(rq_p, rq_t) and _same(step_p, step_t)
    assert _same(port_mp.mp_decode_integer(st_p, rq_p, step_p, cfg.block_size),
                 tpu_mp.mp_decode_integer(st_t, rq_t, step_t, cfg.block_size))
    npos, k = cfg.num_positions(0), cfg.counts[0]
    assert _same(port_mp.feature_map_from_events(st_p, npos, k), tpu_mp.feature_map_from_events(st_t, npos, k))
    assert _same(port_mp.feature_map_int_from_events(st_p, npos, k),
                 tpu_mp.feature_map_int_from_events(st_t, npos, k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_int8_init(seed):
    """`bank_quantize_int16`, `balanced_digits` and `int8_init_scores`, with
    map cells out to the four-digit bound."""
    rng = np.random.default_rng(seed)
    n, c, n_raw, w = int(rng.integers(40, 200)), int(rng.integers(1, 9)), int(rng.integers(1, 7)), int(rng.integers(1, 20))
    m_int = rng.integers(-40000, 40000, size=(n, c)).astype(np.int32)
    m_int[rng.integers(0, n), rng.integers(0, c)] = tpu_mp.FMAP4_DIGIT_BOUND
    bank = rng.standard_normal((n_raw, w, c)).astype(np.float32)
    bq_t, st_t = tpu_mp.bank_quantize_int16(bank)
    bq_p, st_p = port_mp.bank_quantize_int16(bank)
    assert _same(bq_p, bq_t) and _same(st_p, st_t)
    assert _same(port_mp.balanced_digits(m_int, 4), tpu_mp.balanced_digits(m_int, 4))
    ps = np.float32(rng.uniform(1e-4, 1.0))
    assert _same(port_mp.int8_init_scores(m_int, bq_p, st_p, ps), tpu_mp.int8_init_scores(m_int, bq_t, st_t, ps))
    with pytest.raises(ValueError):
        port_mp.balanced_digits(np.array([1 << 20]), 2)


@pytest.mark.parametrize("levels", [2, 3])
def test_oracle_hierarchy(levels):
    """`hierarchical_encode`, `to_distributed`, `to_top_level` and
    `hierarchical_decode` at every level."""
    name = "cfg2" if levels == 2 else "three_level_rice"
    tpu, port = _mld_pair(CONFIGS[name], 11)
    cfg = tpu.config
    xs = hsc_tpu.signal.SignalGenerator(tpu, rates=4e-3).generate_signals(2, cfg.block_size, seed=9)
    for x in xs:
        got, want = port_mp.hierarchical_encode(x, port), tpu_mp.hierarchical_encode(x, tpu)
        assert all(_streams_equal(a, b) for a, b in zip(got, want))
        dist_p, dist_t = port_mp.to_distributed(port.config, got[-1]), tpu_mp.to_distributed(cfg, want[-1])
        assert [lv for lv, _ in dist_p] == [lv for lv, _ in dist_t]
        assert all(_streams_equal(a, b) for (_, a), (_, b) in zip(dist_p, dist_t))
        assert _streams_equal(port_mp.to_top_level(port.config, dist_p), tpu_mp.to_top_level(cfg, dist_t))
        for level in range(levels):
            assert _same(port_oracle.hierarchical_decode(got[level], port, level=level),
                         tpu_oracle.hierarchical_decode(want[level], tpu, level=level))


def _code_without_docstring(module, skip=()) -> str:
    """The module's statements after its docstring, but for the top-level
    functions named in `skip`, as an AST dump."""
    tree = ast.parse(inspect.getsource(module))
    body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) else tree.body
    body = [n for n in body if not (isinstance(n, ast.FunctionDef) and n.name in skip)]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("pair", ["journal", "metrics", "signal", "diagnostics"])
def test_verbatim_copies_hold_the_original_code(pair):
    tpu, port = {
        "journal": (tpu_journal, port_journal),
        "metrics": (hsc_tpu.utils.metrics, hsc_torch.utils.metrics),
        "signal": (hsc_tpu.signal, hsc_torch.signal),
        "diagnostics": (hsc_tpu.analysis.diagnostics, hsc_torch.analysis.diagnostics),
    }[pair]
    assert _code_without_docstring(port) == _code_without_docstring(tpu)


def test_rates_copy_holds_the_original_code_but_the_device_curve():
    """`analysis.rates` is the original statement for statement but for
    `rate_distortion_curve`, whose `use_device` branch runs the port's coder
    and decode; the function keeps the original's parameters and adds
    `device`."""
    tpu, port = hsc_tpu.analysis.rates, hsc_torch.analysis.rates
    skip = ("rate_distortion_curve",)
    assert _code_without_docstring(port, skip) == _code_without_docstring(tpu, skip)
    p = inspect.signature(port.rate_distortion_curve).parameters
    t = inspect.signature(tpu.rate_distortion_curve).parameters
    assert list(p) == [*t, "device"] and all(p[k].default == t[k].default for k in t)


def test_audio_synthesis_and_wav_files(tmp_path):
    """The synthesizers give the same samples, and a WAV written by either
    copy reads back the same in both."""
    for name in ("synthesize_music", "synthesize_speech"):
        for seed in (0, 3):
            assert _same(getattr(hsc_torch.signal, name)(6000, seed=seed),
                         getattr(hsc_tpu.signal, name)(6000, seed=seed)), (name, seed)
    x = hsc_tpu.signal.synthesize_music(3000, rate=8000, seed=1) * 1.7
    paths = [str(tmp_path / "port.wav"), str(tmp_path / "tpu.wav")]
    hsc_torch.signal.save_wav(paths[0], x, rate=8000)
    hsc_tpu.signal.save_wav(paths[1], x, rate=8000)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    for norm in (True, False):
        got = hsc_torch.signal.load_wav_blocks(paths[0], 1024, normalize_peak=norm)
        assert got.shape == (3, 1024)
        assert _same(got, hsc_tpu.signal.load_wav_blocks(paths[0], 1024, normalize_peak=norm))


def test_journal_files_cross_packages(tmp_path):
    """A journal written by the port's copy reads back in the original and
    the other way round: records, the config fingerprint, a torn final
    line, the read-only probe and CRC checks."""
    d = str(tmp_path)
    j = port_journal.EncodeJournal(d, name="corpus", config_json="fp")
    j.record(3, b"abc")
    j.record(0, b"defgh")
    j.record(3, b"ignored")  # re-recording is a no-op
    j.close()
    with open(os.path.join(d, "corpus.journal"), "ab") as f:
        f.write(b"9 0 1 5")  # torn: no newline
    t = tpu_journal.EncodeJournal(d, name="corpus", config_json="fp")
    assert t.done_blocks == {0, 3} and t.read(3) == b"abc" and t.assemble(1) == [b"defgh"]
    t.record(1, b"xy")
    t.close()
    p = port_journal.EncodeJournal(d, name="corpus", config_json="fp")
    assert p.assemble(2) == [b"defgh", b"xy"] and p.read(3) == b"abc"
    p.close()
    assert port_journal.EncodeJournal.peek_done_blocks(d) == tpu_journal.EncodeJournal.peek_done_blocks(d) == {0, 1, 3}
    for mod in (port_journal, tpu_journal):
        with pytest.raises(ValueError, match="different codec config"):
            mod.EncodeJournal(d, name="corpus", config_json="other")
    with open(os.path.join(d, "corpus.blocks"), "r+b") as f:
        f.write(b"Z")  # corrupts block 3's payload
    for mod in (port_journal, tpu_journal):
        jj = mod.EncodeJournal(d, name="corpus")
        with pytest.raises(IOError, match="corruption"):
            jj.read(3)
        jj.close()


def test_metrics_logger_lines(tmp_path, monkeypatch):
    """The same records give the same JSONL lines, and `read_metrics` reads
    either file."""
    monkeypatch.setattr(hsc_torch.utils.metrics.time, "time", lambda: 12.5)
    paths = [str(tmp_path / "port" / "m.jsonl"), str(tmp_path / "tpu" / "m.jsonl")]
    for mod, path in zip((hsc_torch.utils.metrics, hsc_tpu.utils.metrics), paths):
        log = mod.MetricsLogger(path)
        log.log({"kind": "encode_batch", "blocks": 2, "mean_snr_db": None})
        log.log({"kind": "decode", "ts": 1.0})
        log.close()
        mod.MetricsLogger(str(tmp_path / "p1" / "m.jsonl"), process_index=1).log({"kind": "x"})
    lines = [open(p).read() for p in paths]
    assert lines[0] == lines[1]
    assert hsc_torch.utils.metrics.read_metrics(paths[0]) == hsc_tpu.utils.metrics.read_metrics(paths[0])
    assert not os.path.exists(tmp_path / "p1" / "m.jsonl")
