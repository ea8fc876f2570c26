"""The batched block-record packer (`hsc_torch.record_pack`,
`csrc/record_pack.cpp`) on the CPU.

`CorpusEncoder._emit_batched` packs a batch's fixed-entropy top-form
records in one native call where every block would take `_emit_record`'s
plain top form, and block by block otherwise.  Containers and journals from
the batched path equal the per-block path's byte for byte (the per-block
path forced by disabling the loader); the runtime's counters show which
path each block took; the native packer equals `_emit_record` on random
streams at widths that end records mid-byte and mid-word, up to 64-bit
events, and refuses wider ones."""

import dataclasses
import os

import numpy as np
import pytest

from hsc_torch import record_pack, runtime
from hsc_torch.config import make_test_config
from hsc_torch.dictionary import MultilevelDictionary
from hsc_torch.io.bitstream import iter_blocks, unpack_corpus
from hsc_torch.oracle.mp import LevelStream
from hsc_torch.runtime import CorpusEncoder, _emit_record
from hsc_torch.signal import SignalGenerator

CONFIGS = {
    "flat": dict(),
    "two_level": dict(counts=(12, 8), scales=(16, 48), num_coefs=(96, 48)),
    "three_level": dict(counts=(10, 6, 4), scales=(12, 36, 90), num_coefs=(96, 48, 24)),
    "amp3": dict(amp_bits=3),
    "rice": dict(entropy="rice"),
}


def _mld(name, seed=7):
    return MultilevelDictionary.generate(make_test_config(**CONFIGS[name]), seed=seed)


def _corpus(mld, n, seed):
    return SignalGenerator(mld, rates=4e-3).generate_signals(n, mld.config.block_size, seed=seed)


@pytest.fixture
def per_block(monkeypatch):
    """Disable the record packer's loader: every batch packs block by block."""
    def force():
        monkeypatch.setattr(record_pack, "_tried", True)
        monkeypatch.setattr(record_pack, "_lib", None)

    return force


def _counted(encode):
    """(result of `encode()`, blocks packed batched, blocks packed singly)."""
    b0, s0 = runtime.BLOCKS_PACKED_BATCHED, runtime.BLOCKS_PACKED_SINGLY
    out = encode()
    return out, runtime.BLOCKS_PACKED_BATCHED - b0, runtime.BLOCKS_PACKED_SINGLY - s0


def _journal_bytes(jdir):
    return {f: open(os.path.join(jdir, f), "rb").read() for f in sorted(os.listdir(jdir))}


CASES = {
    # name: (config, blocks, batch_size, index, journal, zeroed blocks)
    "flat": ("flat", 6, 3, False, False, ()),
    "flat_index": ("flat", 6, 3, True, False, ()),
    "two_level_top_only": ("two_level", 4, 2, True, False, ()),
    "three_level_top_only": ("three_level", 3, 2, False, False, ()),
    "journal": ("flat", 5, 2, True, True, ()),
    "empty_blocks": ("flat", 5, 4, True, False, (0, 2, 4)),
    "codes_at_maxcode": ("amp3", 4, 4, False, False, ()),
    "short_batch": ("two_level", 5, 4, False, True, (1,)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_containers_equal_per_block(tmp_path, per_block, case):
    """Every case of the batched path (levels, index, journal, empty blocks,
    codes at +-amp_maxcode, a short last batch) gives the per-block path's
    container and journal bytes, and packs every block batched."""
    name, nb, bs, index, journal, zeroed = CASES[case]
    mld = _mld(name)
    cfg = mld.config
    xs = _corpus(mld, nb, seed=13)
    xs[list(zeroed)] = 0.0

    def encode(tag):
        jdir = str(tmp_path / tag) if journal else None
        enc = CorpusEncoder(mld, device="cpu", batch_size=bs, journal_dir=jdir)
        return enc.encode(xs, index=index), jdir

    (batched, jdir_b), n_batched, n_single = _counted(lambda: encode("batched"))
    assert (n_batched, n_single) == (nb, 0)
    per_block()
    (single, jdir_s), n_batched, n_single = _counted(lambda: encode("single"))
    assert (n_batched, n_single) == (0, nb)
    assert batched == single
    if journal:
        assert _journal_bytes(jdir_b) == _journal_bytes(jdir_s)

    _, blocks = unpack_corpus(batched)
    top = cfg.num_levels - 1
    assert all([lv for lv, _ in streams] == [top] for streams in blocks)
    counts = [streams[0][1].positions.shape[0] for streams in blocks]
    for b in zeroed:
        assert counts[b] == 0
    assert sum(counts) > 0
    if case == "codes_at_maxcode":
        codes = np.concatenate([streams[0][1].codes for streams in blocks])
        assert {cfg.amp_maxcode, -cfg.amp_maxcode} <= set(codes.tolist())


@pytest.mark.parametrize(
    "name, options, batched",
    [
        ("flat", dict(), True),
        ("two_level", dict(), True),
        ("flat", dict(distributed=True), True),
        ("rice", dict(), False),
        ("flat", dict(target_bps=1.5), False),
        ("flat", dict(target_bps=1.5, rate_mode="corpus"), False),
        ("two_level", dict(distributed=True), False),
    ],
)
def test_counters_name_the_packing_path(name, options, batched):
    """Fixed top-only encodes (a single level's `distributed` form is its top
    form) pack every block batched; Rice, both rate modes and the 2-level
    distributed form pack every block one by one."""
    mld = _mld(name)
    xs = _corpus(mld, 4, seed=3)
    enc = CorpusEncoder(mld, device="cpu", batch_size=3, **options)
    blob, n_batched, n_single = _counted(lambda: enc.encode(xs))
    assert (n_batched, n_single) == ((4, 0) if batched else (0, 4))
    assert len(list(iter_blocks(blob))) == 4


def _fail_build(monkeypatch, tmp_path):
    """Point the loader at a source g++ cannot compile."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(record_pack, "_SRC", str(bad))
    monkeypatch.setattr(record_pack, "_BUILD_DIR", str(tmp_path / "build"))


@pytest.mark.parametrize("how", ["no_native_env", "build_fails"])
def test_without_the_library_bytes_unchanged(tmp_path, monkeypatch, how):
    """With HSC_TPU_NO_NATIVE set, or a build that fails, the loader gives
    nothing, the encoder packs every block one by one, and the container is
    the batched path's."""
    mld = _mld("two_level")
    xs = _corpus(mld, 5, seed=29)
    batched, n_batched, _ = _counted(
        lambda: CorpusEncoder(mld, device="cpu", batch_size=2).encode(xs, index=True)
    )
    assert n_batched == 5
    monkeypatch.setattr(record_pack, "_tried", False)
    monkeypatch.setattr(record_pack, "_lib", None)
    if how == "no_native_env":
        monkeypatch.setenv("HSC_TPU_NO_NATIVE", "1")
    else:
        _fail_build(monkeypatch, tmp_path)
    single, n_batched, n_single = _counted(
        lambda: CorpusEncoder(mld, device="cpu", batch_size=2).encode(xs, index=True)
    )
    assert not record_pack.available()
    assert (n_batched, n_single) == (0, 5)
    assert single == batched


@dataclasses.dataclass(frozen=True)
class _Widths:
    """The parts of a `CodecConfig` that fixed-entropy packing reads, at any
    field widths."""

    pb: int
    ab: int
    amp_bits: int
    entropy: str = "fixed"
    num_levels: int = 1

    def pos_bits(self, level):
        return self.pb

    def atom_bits(self, level):
        return self.ab

    @property
    def amp_maxcode(self):
        return (1 << (self.amp_bits - 1)) - 1

    def event_bits(self, level):
        return self.pb + self.ab + self.amp_bits


def _random_streams(rng, w, counts, out_of_range):
    streams = []
    for n in counts:
        if out_of_range:
            # fields past their widths: masked as hsc_pack_events masks them
            pos = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
            atoms = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
            codes = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64) // 2
        else:
            pos = rng.integers(0, 1 << w.pb, n)
            atoms = rng.integers(0, 1 << w.ab, n)
            codes = rng.integers(-w.amp_maxcode, w.amp_maxcode + 1, n)
            codes[: n // 4] = w.amp_maxcode
            codes[n // 4 : n // 2] = -w.amp_maxcode
        streams.append(
            LevelStream(
                positions=pos.astype(np.int32),
                atoms=atoms.astype(np.int32),
                codes=codes.astype(np.int32),
                scale=np.float32(rng.standard_normal()),
                energy0=1.0,
                energy_res=0.5,
            )
        )
    return streams


@pytest.mark.parametrize(
    "widths",
    [(14, 6, 16), (13, 7, 17), (3, 1, 2), (11, 5, 9), (24, 23, 16), (31, 17, 16), (31, 16, 16)],
)
@pytest.mark.parametrize("out_of_range", [False, True])
def test_native_records_equal_emit_record(widths, out_of_range):
    """Records from one native call equal `_emit_record` per stream: events
    of 36, 37, 6, 25, 63 and 64 bits (records ending mid-byte and mid-word,
    with 0, 1, 7, 8 and more events), codes at +-amp_maxcode, and fields
    past their widths masked alike."""
    w = _Widths(*widths)
    rng = np.random.default_rng(sum(widths))
    counts = [0, 1, 7, 8, 9, 64, 0, 333, 513]
    streams = _random_streams(rng, w, counts, out_of_range)
    records = record_pack.pack_records(w, 0, streams)
    assert records == [_emit_record(w, s, False) for s in streams]


def test_native_packer_refuses_wide_events():
    """Events past 64 bits are not the native packer's: `event_bits_ok` says
    so and a call raises (the encoder then packs block by block)."""
    w = _Widths(32, 17, 16)
    assert not record_pack.event_bits_ok(w, 0)
    assert record_pack.event_bits_ok(_Widths(31, 17, 16), 0)
    with pytest.raises(ValueError, match="65-bit"):
        record_pack.pack_records(w, 0, _random_streams(np.random.default_rng(0), w, [3], False))
