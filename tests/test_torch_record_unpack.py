"""The batched block-record unpackers (`hsc_torch.record_pack.unpack_records`,
`csrc/record_pack.cpp::hsc_unpack_records`, and the per-level
`unpack_level_records`, `hsc_unpack_level_records`) on the CPU.

`CorpusEncoder._decode_chunks` unpacks a chunk of a fixed-entropy
container's records in one native call, straight into the decode's padded
arrays, where it is given the records' offsets (`CorpusReader`,
`decode_stream(indices)`, `decode_blocks`, and `decode` of a container with
a current footer), and block by block otherwise.  The native arrays equal
`unpack_block` then `pad_streams` bit for bit at the flagship widths and at
odd ones (events past 57 bits, empty streams, a record that ends the
buffer, a scattered selection); a faulty record sends its chunk to the
per-block path, which raises the per-block error.  A chunk of records of
several levels (the distributed form) unpacks in one per-level native call
into the units `unpack_block` then `CorpusEncoder._units` give, bit for bit
at 2 and 3 levels, and a faulty one gives up; distributed, mixed and
over-long chunks decode byte-identically to the per-block path, and such a
chunk's units come through `_units`; the runtime's counters name the path
each chunk took, also on a mesh."""

import dataclasses
import struct

import numpy as np
import pytest

from hsc_torch import record_pack, runtime
from hsc_torch.config import make_test_config
from hsc_torch.dictionary import MultilevelDictionary
from hsc_torch.io import bitstream
from hsc_torch.io.bitstream import pack_corpus, pack_stream, read_index, unpack_block
from hsc_torch.models.coder import pad_streams
from hsc_torch.oracle.mp import LevelStream
from hsc_torch.parallel import make_mesh
from hsc_torch.runtime import CorpusEncoder, CorpusReader
from hsc_torch.signal import SignalGenerator

FLAT_FLAGSHIP = dict(counts=(64,), scales=(32,), block_size=16384, num_coefs=(512,))
HIER_FLAGSHIP = dict(counts=(64, 32), scales=(32, 96), block_size=16384, num_coefs=(512, 192))

CONFIGS = {
    "flat": dict(counts=(12,)),
    "two_level": dict(counts=(12, 8), scales=(16, 48), num_coefs=(96, 48)),
    "rice": dict(counts=(12,), entropy="rice"),
    "three_level": dict(counts=(12, 8, 6), scales=(16, 48, 96), num_coefs=(96, 48, 24)),
}


def _mld(name, seed=7):
    return MultilevelDictionary.generate(make_test_config(**CONFIGS[name]), seed=seed)


def _corpus(mld, n, seed):
    return SignalGenerator(mld, rates=4e-3).generate_signals(n, mld.config.block_size, seed=seed)


@pytest.fixture
def per_block(monkeypatch):
    """Disable the record library's loader: every chunk unpacks block by
    block."""
    def force():
        monkeypatch.setattr(record_pack, "_tried", True)
        monkeypatch.setattr(record_pack, "_lib", None)

    return force


def _unpack_counts():
    return (runtime.BLOCKS_UNPACKED_BATCHED, runtime.BLOCKS_UNPACKED_BY_LEVEL,
            runtime.BLOCKS_UNPACKED_SINGLY)


def _counted(decode):
    """(result of `decode()`, (blocks unpacked batched, by level, singly))."""
    before = _unpack_counts()
    out = decode()
    return out, tuple(a - b for a, b in zip(_unpack_counts(), before))


def _read(path, mld, batch_size, lo, hi, mesh=None):
    with CorpusReader(str(path), mld, device="cpu", batch_size=batch_size, mesh=mesh) as reader:
        return reader[lo:hi]


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """The parts of a `CodecConfig` that fixed-entropy packing, unpacking and
    the range checks read, at any field widths and ranges."""

    pb: int
    ab: int
    amp_bits: int
    npos: int
    natoms: int
    entropy: str = "fixed"
    num_levels: int = 1

    def pos_bits(self, level):
        return self.pb

    def atom_bits(self, level):
        return self.ab

    def num_positions(self, level):
        return self.npos

    @property
    def counts_with_singletons(self):
        return (self.natoms,) * self.num_levels

    @property
    def amp_maxcode(self):
        return (1 << (self.amp_bits - 1)) - 1

    def event_bits(self, level):
        return self.pb + self.ab + self.amp_bits


def _geometry(cfg, level):
    return _Geometry(
        cfg.pos_bits(level), cfg.atom_bits(level), cfg.amp_bits,
        cfg.num_positions(level), cfg.counts_with_singletons[level],
        num_levels=level + 1,
    )


WIDTHS = {
    # name: (geometry, level): flagship widths, then odd ones
    "flat_flagship": (_geometry(make_test_config(**FLAT_FLAGSHIP), 0), 0),
    "hier_flagship_top": (_geometry(make_test_config(**HIER_FLAGSHIP), 1), 1),
    "narrow": (_Geometry(3, 1, 2, 5, 2), 0),
    "odd": (_Geometry(13, 7, 11, 8000, 100), 0),
    "57_bits": (_Geometry(24, 17, 16, (1 << 24) - 1, 100_000), 0),
    "63_bits": (_Geometry(24, 23, 16, (1 << 24) - 3, (1 << 23) - 1), 0),
    "78_bits": (_Geometry(31, 31, 16, (1 << 31) - 1, (1 << 31) - 5), 0),
}
# stream lengths: empty streams, records ending mid-byte and mid-word, and
# a last record that ends the buffer
COUNTS = [0, 1, 7, 8, 9, 64, 0, 333, 513, 3]


def _random_stream(rng, g, n):
    pos = rng.integers(0, g.npos, n)
    atoms = rng.integers(0, g.natoms, n)
    codes = rng.integers(-g.amp_maxcode, g.amp_maxcode + 1, n)
    if n >= 3:  # every range at both of its ends
        pos[:2], atoms[:2], codes[:2] = (0, g.npos - 1), (0, g.natoms - 1), (-g.amp_maxcode, g.amp_maxcode)
    return LevelStream(
        positions=pos.astype(np.int32),
        atoms=atoms.astype(np.int32),
        codes=codes.astype(np.int32),
        scale=np.float32(rng.standard_normal()),
        energy0=0.0,
        energy_res=0.0,
    )


def _records(g, level, streams, scale_bits=()):
    """Block records back to back, each ``u8 1`` then the stream, and their
    offsets; `scale_bits` {block: raw f32 bits} overwrites stored scales."""
    parts, offsets, off = [], [], 0
    for s in streams:
        rec = b"\x01" + pack_stream(g, level, s)
        parts.append(rec)
        offsets.append(off)
        off += len(rec)
    data = bytearray(b"".join(parts))
    for b, bits in dict(scale_bits).items():
        struct.pack_into("<I", data, offsets[b] + 6, bits)
    return bytes(data), np.asarray(offsets, np.int64)


def _assert_same_arrays(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("selection", ["all", "scattered"])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_unpack_records_equal_unpack_block_and_pad(name, selection):
    """One native call gives `unpack_block` then `pad_streams`, array for
    array and bit for bit: flagship widths, 6- to 78-bit events, empty
    streams, a record that ends the buffer, every range at both ends, NaN,
    signed-zero and infinite scales, and a scattered selection with a
    repeat."""
    g, level = WIDTHS[name]
    rng = np.random.default_rng(len(name))
    streams = [_random_stream(rng, g, n) for n in COUNTS]
    # a signalling NaN, a quiet NaN, -0.0, +inf and a subnormal
    scales = {1: 0x7F800001, 2: 0xFFC12345, 3: 0x80000000, 4: 0x7F800000, 5: 0x00000001}
    data, offsets = _records(g, level, streams, scales)
    if selection == "scattered":
        offsets = offsets[[9, 2, 7, 2, 0, 8]]
    cap = 600
    got = record_pack.unpack_records(g, level, data, offsets, cap)
    assert got is not None
    want = pad_streams([unpack_block(g, data, int(o))[0][0][1] for o in offsets], cap)
    _assert_same_arrays(got, want)


def _fault(data, off, g, what):
    """`data` with the record at `off` made faulty in one way."""
    data = bytearray(data)
    n = struct.unpack_from("<I", data, off + 2)[0]
    ebits = g.event_bits(0)

    def set_field(i, start, width, value):
        bit = i * ebits + start
        raw = int.from_bytes(data[off + 10 :], "big")
        total = 8 * (len(data) - off - 10)
        shift = total - bit - width
        raw = (raw & ~(((1 << width) - 1) << shift)) | (value << shift)
        data[off + 10 :] = raw.to_bytes(total // 8, "big")

    if what == "position":
        set_field(n - 1, 0, g.pb, g.npos)
    elif what == "atom":
        set_field(0, g.pb, g.ab, g.natoms)
    elif what == "code":
        set_field(1, g.pb + g.ab, g.amp_bits, (1 << g.amp_bits) - 1)
    elif what == "count":  # more events than the buffer holds
        struct.pack_into("<I", data, off + 2, n + 40)
    elif what == "streams":
        data[off] = 2
    elif what == "level":
        data[off + 1] = 1
    return bytes(data)


@pytest.mark.parametrize("what", ["position", "atom", "code", "count", "streams", "level"])
def test_unpack_records_gives_up_on_a_faulty_record(what):
    """A position, atom or code out of range, a count past the buffer, two
    streams, or a stream of another level: the native call gives up (the
    caller takes the chunk block by block)."""
    g = _Geometry(10, 4, 6, 1000, 12)
    rng = np.random.default_rng(5)
    data, offsets = _records(g, 0, [_random_stream(rng, g, n) for n in (5, 9, 4)])
    assert record_pack.unpack_records(g, 0, data, offsets, 16) is not None
    bad = _fault(data, int(offsets[2]), g, what)
    assert record_pack.unpack_records(g, 0, bad, offsets, 16) is None
    assert record_pack.unpack_records(g, 0, bad, offsets[:2], 16) is not None


def test_unpack_records_gives_up_past_cap_or_buffer():
    """More events than `cap`, a header past the buffer's end, an offset
    outside it, a field wider than 32 bits, a position past int32, or a
    Rice container."""
    g = _Geometry(10, 4, 6, 1000, 12)
    rng = np.random.default_rng(6)
    data, offsets = _records(g, 0, [_random_stream(rng, g, n) for n in (5, 9)])
    assert record_pack.unpack_records(g, 0, data, offsets, 9) is not None
    assert record_pack.unpack_records(g, 0, data, offsets, 8) is None
    assert record_pack.unpack_records(g, 0, data, [len(data) - 9], 9) is None
    assert record_pack.unpack_records(g, 0, data, [-1], 9) is None
    assert record_pack.unpack_records(g, 0, data, [len(data) + 10], 9) is None
    wide = _Geometry(33, 4, 6, 1 << 33, 12)
    assert record_pack.unpack_records(wide, 0, data, offsets[:1], 9) is None
    # a 32-bit position past int32, which the per-block path reads negative
    g32 = _Geometry(32, 4, 6, (1 << 32) - 5, 12)
    s = _random_stream(rng, _Geometry(31, 4, 6, 1 << 31, 12), 4)
    s.positions[2] = -(1 << 31) + 7
    big, at = _records(g32, 0, [s])
    with pytest.raises(ValueError, match="corrupt stream: position"):
        unpack_block(g32, big, 0)
    assert record_pack.unpack_records(g32, 0, big, at, 9) is None
    rice = dataclasses.replace(g, entropy="rice")
    assert record_pack.unpack_records(rice, 0, data, offsets, 9) is None


def _level_records(cfg, blocks):
    """Block records back to back, each ``u8 n_streams`` then its ``(level,
    stream)`` streams (`_emit_record`'s distributed form), and their
    offsets."""
    parts, offsets, off = [], [], 0
    for streams in blocks:
        rec = struct.pack("<B", len(streams)) + b"".join(pack_stream(cfg, lv, st) for lv, st in streams)
        parts.append(rec)
        offsets.append(off)
        off += len(rec)
    return b"".join(parts), np.asarray(offsets, np.int64)


def _caps(cfg):
    return [max(c, 1) for c in cfg.num_coefs]


def _units_per_block(codec, cfg, data, offsets):
    """`unpack_block` of each record then `CorpusEncoder._units`, with a
    top-only chunk's rows (named None there: all of them) named."""
    chunk = [unpack_block(cfg, data, int(o))[0] for o in offsets]
    units = codec._units(chunk, cfg.num_levels - 1, cfg.decode_mode)
    return [(list(range(len(chunk))) if ids is None else ids, lv, arrays) for ids, lv, arrays in units]


# which levels a block of the chunk holds: one level in every block, or
# every subset of the levels (none and all of them included) in turn
HOLDINGS = {
    "level_0": lambda levels, b: [0],
    "level_1": lambda levels, b: [1],
    "mixed": lambda levels, b: [lv for lv in range(levels) if (b + 1) >> lv & 1],
}


@pytest.mark.parametrize("selection", ["all", "scattered"])
@pytest.mark.parametrize("holding", list(HOLDINGS))
@pytest.mark.parametrize("name", ["two_level", "three_level"])
def test_unpack_level_records_equal_unpack_block_and_units(name, holding, selection):
    """One native call gives `unpack_block` then `_units`: the units in the
    same order, each level's block indices, row counts and arrays bit for
    bit, at 2 and 3 levels, with streams of 0 events and of a level's whole
    cap, a block holding no stream, and a scattered selection with a
    repeat."""
    mld = _mld(name)
    cfg = mld.config
    codec = CorpusEncoder(mld, device="cpu", batch_size=4)
    rng = np.random.default_rng(cfg.num_levels * 10 + len(holding))
    blocks = []
    for b in range(9):
        streams = []
        for lv in HOLDINGS[holding](cfg.num_levels, b):
            n = [0, 1, cfg.num_coefs[lv], int(rng.integers(0, cfg.num_coefs[lv]))][b % 4]
            streams.append((lv, _random_stream(rng, _geometry(cfg, lv), n)))
        blocks.append(streams)
    data, offsets = _level_records(cfg, blocks)
    if selection == "scattered":
        offsets = offsets[[8, 2, 5, 2, 0, 6]]
    got = record_pack.unpack_level_records(cfg, data, offsets, _caps(cfg))
    assert got is not None
    want = _units_per_block(codec, cfg, data, offsets)
    assert [(ids, lv) for ids, lv, _ in got] == [(ids, lv) for ids, lv, _ in want]
    assert all(type(i) is int for ids, _, _ in got for i in ids)
    for (ids, lv, arrays), (_, _, expected) in zip(got, want):
        assert arrays[0].shape == (len(ids), _caps(cfg)[lv])
        _assert_same_arrays(arrays, expected)


def _level_fault(cfg, rng, what):
    """The records of a chunk whose last record is faulty in one way, and
    what the per-block path does with that record: raise, or leave the
    chunk to `_units`, which gives None (levels out of order) or buckets
    a stream past its level's cap."""
    top = cfg.num_levels - 1

    def stream(lv, n=5, **bad):
        st = _random_stream(rng, _geometry(cfg, lv), n)
        for field, value in bad.items():
            getattr(st, field)[n - 1] = value
        return st

    good = [[(0, stream(0)), (top, stream(top))], [(top, stream(top))], [(0, stream(0))]]
    if what.startswith(("position", "atom", "code")):
        field, lv = what.split("_l")
        lv = int(lv)
        value = {"position": cfg.num_positions(lv), "atom": cfg.counts_with_singletons[lv],
                 "code": cfg.amp_maxcode + 1}[field]
        last = [(0, stream(0)), (top, stream(top))]
        last[lv if lv == 0 else 1] = (lv, stream(lv, **{field + "s": value}))
        fate = "raises"
    elif what == "repeated":
        last, fate = [(0, stream(0)), (0, stream(0))], "exotic"
    elif what == "descending":
        last, fate = [(top, stream(top)), (0, stream(0))], "exotic"
    elif what == "past_levels":
        last, fate = [(0, stream(0)), (top, stream(top))], "raises"
    elif what == "over_cap":
        last, fate = [(0, stream(0, cfg.num_coefs[0] + 1)), (top, stream(top))], "buckets"
    else:
        last, fate = [(0, stream(0)), (top, stream(top))], "raises"
    data, offsets = _level_records(cfg, good + [last])
    if what == "header":  # the second stream's header cut short
        data = data[: int(offsets[-1]) + 1 + len(pack_stream(cfg, 0, last[0][1])) + 4]
    elif what == "stream_missing":  # the buffer ends where the second stream would start
        data = data[: int(offsets[-1]) + 1 + len(pack_stream(cfg, 0, last[0][1]))]
    elif what == "payload":
        data = data[:-1]
    elif what == "past_levels":  # a level byte the packer cannot write
        at = int(offsets[-1]) + 1 + len(pack_stream(cfg, 0, last[0][1]))
        data = data[:at] + bytes([cfg.num_levels]) + data[at + 1 :]
    return data, offsets, fate


LEVEL_FAULTS = [
    "position_l0", "position_l1", "atom_l0", "atom_l1", "code_l0", "code_l1",
    "repeated", "descending", "past_levels", "over_cap", "header", "stream_missing", "payload",
]


@pytest.mark.parametrize("what", LEVEL_FAULTS)
def test_unpack_level_records_gives_up_on_a_faulty_record(what):
    """A position, atom or code out of range at either level, a level
    repeated, descending or past the level count, a stream past its level's
    cap, a header or a payload cut short, a declared stream missing at the
    buffer's end: the native call gives up, the
    good records before it still unpack, and the per-block path raises,
    leaves the chunk to the per-block decode, or buckets the stream."""
    mld = _mld("two_level")
    cfg = mld.config
    data, offsets, fate = _level_fault(cfg, np.random.default_rng(len(what)), what)
    caps = _caps(cfg)
    assert record_pack.unpack_level_records(cfg, data, offsets[:-1], caps) is not None
    assert record_pack.unpack_level_records(cfg, data, offsets, caps) is None
    assert record_pack.unpack_level_records(cfg, data, offsets[-1:], caps) is None
    if fate == "raises":
        with pytest.raises((ValueError, struct.error)):
            unpack_block(cfg, data, int(offsets[-1]))
        return
    codec = CorpusEncoder(mld, device="cpu")
    units = codec._units([unpack_block(cfg, data, int(offsets[-1]))[0]], cfg.num_levels - 1, cfg.decode_mode)
    if fate == "exotic":
        assert units is None
    else:
        assert units[0][2][0].shape[1] > caps[0]


def test_unpack_level_records_gives_up_on_rice_and_wide_fields():
    """A Rice container, or a field wider than 32 bits, gives None."""
    cfg = _mld("two_level").config
    data, offsets = _level_records(cfg, [[(0, _random_stream(np.random.default_rng(1), _geometry(cfg, 0), 3))]])
    assert record_pack.unpack_level_records(cfg, data, offsets, _caps(cfg)) is not None
    rice = dataclasses.replace(cfg, entropy="rice")
    assert record_pack.unpack_level_records(rice, data, offsets, _caps(cfg)) is None
    wide = _Geometry(33, 4, 6, 1 << 33, 12)
    assert record_pack.unpack_level_records(wide, data, offsets, [16]) is None


def _indexed(tmp_path, name, n_blocks, **options):
    mld = _mld(name)
    blob = CorpusEncoder(mld, device="cpu", batch_size=4, **options).encode(
        _corpus(mld, n_blocks, seed=17), index=True
    )
    path = tmp_path / "c.hsct"
    path.write_bytes(blob)
    return mld, blob, path


@pytest.mark.parametrize(
    "name, options, lo, hi, batch",
    [
        ("flat", dict(), 0, 7, 3),
        ("flat", dict(), 2, 7, 2),
        ("two_level", dict(), 1, 6, 2),
    ],
)
def test_reader_slices_batched_equal_per_block(tmp_path, per_block, name, options, lo, hi, batch):
    """`CorpusReader` slices of fixed top-only containers (flat, and a
    2-level top-only one) unpack every block batched and equal the
    per-block path's rows byte for byte."""
    mld, _, path = _indexed(tmp_path, name, 7, **options)
    rows, counts = _counted(lambda: _read(path, mld, batch, lo, hi))
    assert counts == (hi - lo, 0, 0)
    per_block()
    single, counts = _counted(lambda: _read(path, mld, batch, lo, hi))
    assert counts == (0, 0, hi - lo)
    assert rows.dtype == single.dtype and rows.tobytes() == single.tobytes()


FAULTS = ["position", "atom", "code", "count"]


@pytest.mark.parametrize("what", FAULTS)
def test_a_faulty_record_raises_the_per_block_error(tmp_path, per_block, what):
    """A corrupt record in a chunk: the reader raises the `ValueError` of
    `unpack_block`, with its text, with the library on and off."""
    mld, blob, path = _indexed(tmp_path, "flat", 6)
    cfg = mld.config
    offsets = read_index(blob)
    g = _geometry(cfg, 0)
    victim = 4 if what != "count" else 5
    bad = _fault(blob, int(offsets[victim]), g, what)
    with pytest.raises(ValueError) as direct:
        unpack_block(cfg, bad, int(offsets[victim]))
    path.write_bytes(bad)
    with pytest.raises(ValueError) as batched:
        _read(path, mld, 2, 0, 6)
    per_block()
    with pytest.raises(ValueError) as single:
        _read(path, mld, 2, 0, 6)
    assert str(batched.value) == str(single.value) == str(direct.value)
    assert str(direct.value).startswith("corrupt stream" if what != "count" else "stream claims")


def _mixed_container(tmp_path, mld):
    """An indexed 2-level container whose chunks of 2 are: top-only;
    distributed; top-only with one stream longer than the top level's
    `num_coefs`; top-only (a short last chunk)."""
    cfg = mld.config
    top = cfg.num_levels - 1
    enc = CorpusEncoder(mld, device="cpu", batch_size=4)
    streams = enc.coder.encode_batch(_corpus(mld, 7, seed=23))
    rng = np.random.default_rng(3)
    n_long = cfg.num_coefs[top] + 5
    long = LevelStream(
        positions=rng.integers(0, cfg.num_positions(top), n_long).astype(np.int32),
        atoms=rng.integers(0, cfg.counts_with_singletons[top], n_long).astype(np.int32),
        codes=rng.integers(-3, 4, n_long).astype(np.int32),
        scale=np.float32(0.25),
        energy0=0.0,
        energy_res=0.0,
    )
    blocks = [[(top, s[top])] for s in streams]
    blocks[2] = [(0, streams[2][0]), (top, streams[2][top])]
    blocks[5] = [(top, long)]
    blob = pack_corpus(cfg, blocks, index=True)
    path = tmp_path / "mixed.hsct"
    path.write_bytes(blob)
    return blob, path


def test_fallback_chunks_decode_identically(tmp_path, per_block):
    """Top-only chunks take the batched path, distributed and mixed ones the
    per-level one, over-long ones the per-block one, and every row equals
    the per-block path's: through `CorpusReader`, `decode_blocks` and
    `decode`."""
    mld = _mld("two_level")
    blob, path = _mixed_container(tmp_path, mld)
    codec = CorpusEncoder(mld, device="cpu", batch_size=2)
    order = [6, 0, 1, 5, 3, 2]
    rows, counts = _counted(lambda: _read(path, mld, 2, 0, 7))
    assert counts == (3, 2, 2)
    picked, counts = _counted(lambda: codec.decode_blocks(blob, order))
    assert counts == (2, 2, 2)  # chunks [6, 0], [1, 5], [3, 2]
    whole, counts = _counted(lambda: codec.decode(blob))
    assert counts == (3, 2, 2)
    per_block()
    assert rows.tobytes() == _read(path, mld, 2, 0, 7).tobytes()
    assert picked.tobytes() == codec.decode_blocks(blob, order).tobytes()
    assert whole.tobytes() == codec.decode(blob).tobytes() == rows.tobytes()


@pytest.mark.parametrize("name, options", [("rice", dict())])
def test_rice_and_distributed_containers_unpack_singly(tmp_path, name, options):
    """Rice containers never reach the native calls: every block counts as
    unpacked singly.  (Distributed containers unpack by level:
    `test_distributed_containers_unpack_by_level`.)"""
    mld, _, path = _indexed(tmp_path, name, 5, **options)
    _, counts = _counted(lambda: _read(path, mld, 2, 0, 5))
    assert counts == (0, 0, 5)


@pytest.mark.parametrize(
    "name, batch, lo, hi",
    [("two_level", 2, 0, 5), ("two_level", 3, 1, 5), ("three_level", 2, 0, 5), ("three_level", 4, 1, 4)],
)
def test_distributed_containers_unpack_by_level(tmp_path, per_block, name, batch, lo, hi):
    """A distributed container's chunks unpack in one per-level native call
    each: every block counts as unpacked by level, none singly, and the
    reader's slices equal the per-block path's byte for byte."""
    mld, blob, path = _indexed(tmp_path, name, 5, distributed=True)
    offsets = read_index(blob)
    held = [[lv for lv, _ in unpack_block(mld.config, blob, int(o))[0]] for o in offsets[:-1]]
    assert any(len(h) > 1 for h in held)
    rows, counts = _counted(lambda: _read(path, mld, batch, lo, hi))
    assert counts == (0, hi - lo, 0)
    per_block()
    single, counts = _counted(lambda: _read(path, mld, batch, lo, hi))
    assert counts == (0, 0, hi - lo)
    assert rows.dtype == single.dtype and rows.tobytes() == single.tobytes()


@pytest.mark.parametrize("name", ["two_level", "three_level"])
def test_records_unpacked_by_level_come_through_units(tmp_path, monkeypatch, name):
    """A chunk unpacked by level gets its decode units from `_units`, given
    the chunk's records: every chunk of a distributed slice passes through
    it, and a level left out there is left out of the rows."""
    mld, _, path = _indexed(tmp_path, name, 5, distributed=True)
    sound = _read(path, mld, 2, 0, 5)
    real = CorpusEncoder._units
    seen = []

    def units(self, chunk, top, mode):
        out = real(self, chunk, top, mode)
        seen.append((type(chunk).__name__, [u[1] for u in out]))
        return [u for u in out if u[1] != 0] if drop else out

    monkeypatch.setattr(CorpusEncoder, "_units", units)
    drop = False
    rows, counts = _counted(lambda: _read(path, mld, 2, 0, 5))
    assert counts == (0, 5, 0) and rows.tobytes() == sound.tobytes()
    assert [kind for kind, _ in seen] == ["_ChunkRecords"] * 3
    assert any(0 in levels for _, levels in seen)
    drop = True
    dropped = _read(path, mld, 2, 0, 5)
    assert dropped.tobytes() != sound.tobytes()


def test_decode_takes_the_footer_when_current(per_block):
    """`decode` and `decode_stream` of an indexed container unpack batched;
    of a plain one they walk the headers block by block; the rows agree."""
    mld = _mld("flat")
    codec = CorpusEncoder(mld, device="cpu", batch_size=3)
    xs = _corpus(mld, 5, seed=31)
    plain = codec.encode(xs)
    indexed = codec.encode(xs, index=True)
    a, counts = _counted(lambda: codec.decode(indexed))
    assert counts == (5, 0, 0)
    b, counts = _counted(lambda: codec.decode(plain))
    assert counts == (0, 0, 5)
    c, counts = _counted(lambda: np.stack(list(codec.decode_stream(indexed))))
    assert counts == (5, 0, 0)
    per_block()
    d = codec.decode(indexed)
    assert a.tobytes() == b.tobytes() == c.tobytes() == d.tobytes()


def _fail_build(monkeypatch, tmp_path):
    """Point the loader at a source g++ cannot compile."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(record_pack, "_SRC", str(bad))
    monkeypatch.setattr(record_pack, "_BUILD_DIR", str(tmp_path / "build"))


@pytest.mark.parametrize(
    "name, options, native", [("flat", dict(), (5, 0, 0)), ("two_level", dict(distributed=True), (0, 5, 0))]
)
@pytest.mark.parametrize("how", ["no_native_env", "build_fails"])
def test_without_the_library_reader_rows_unchanged(tmp_path, monkeypatch, how, name, options, native):
    """With HSC_TPU_NO_NATIVE set, or a build that fails, the loader gives
    nothing, every block unpacks singly, and the reader's slices are the
    native paths' (batched, or by level for a distributed container), byte
    for byte."""
    mld, _, path = _indexed(tmp_path, name, 6, **options)
    rows, counts = _counted(lambda: _read(path, mld, 4, 1, 6))
    assert counts == native
    monkeypatch.setattr(record_pack, "_tried", False)
    monkeypatch.setattr(record_pack, "_lib", None)
    if how == "no_native_env":
        monkeypatch.setenv("HSC_TPU_NO_NATIVE", "1")
    else:
        _fail_build(monkeypatch, tmp_path)
    single, counts = _counted(lambda: _read(path, mld, 4, 1, 6))
    assert not record_pack.available()
    assert counts == (0, 0, 5)
    assert single.tobytes() == rows.tobytes()


def test_decode_stream_reads_only_the_selected_records(monkeypatch):
    """`decode_stream(indices)` hands the native call the selected records'
    offsets alone, a chunk at a time: after the first row at most the
    pipeline's depth of chunks has been unpacked."""
    mld = _mld("flat")
    codec = CorpusEncoder(mld, device="cpu", batch_size=1)
    blob = codec.encode(_corpus(mld, 12, seed=37), index=True)
    offsets = read_index(blob)
    seen = []
    real = record_pack.unpack_records

    def counting(cfg, level, data, offs, cap):
        seen.extend(int(o) for o in offs)
        return real(cfg, level, data, offs, cap)

    monkeypatch.setattr(record_pack, "unpack_records", counting)
    monkeypatch.setattr(bitstream, "unpack_block", None)  # no per-block read
    indices = [9, 3, 4, 11, 0, 7, 8]
    it = codec.decode_stream(blob, indices=indices)
    next(it)
    assert 1 <= len(seen) <= 5
    list(it)
    assert seen == [int(offsets[i]) for i in indices]


def test_mesh_reader_rows_equal_one_device(tmp_path):
    """`CorpusReader(mesh=)` over a 2-shard CPU mesh: rows byte-identical
    to one device's, every block unpacked batched."""
    mld, _, path = _indexed(tmp_path, "flat", 7)
    one = _read(path, mld, 3, 0, 7)
    mesh = make_mesh({"data": 2}, devices=["cpu"] * 2)
    rows, counts = _counted(lambda: _read(path, mld, 3, 0, 7, mesh=mesh))
    assert counts == (7, 0, 0)
    assert rows.tobytes() == one.tobytes()
