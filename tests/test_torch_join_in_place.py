"""The in-place row join on the CPU: `CorpusReader[a:b]`,
`CorpusEncoder.decode_blocks` and `CorpusEncoder.decode` allocate their one
``[n, block_size]`` float32 output and drain each decode unit's rows
straight into it (`CorpusEncoder._join_rows`).  The joined rows equal, byte
for byte, the chunks that `rows()` / `decode_stream` yield, for flat,
top-only, distributed (a block lacking a level, a level's rows of -0.0),
exotic and footer-less containers, at whole, inner, short and empty
selections and at repeated, unsorted indices.  The output is C-contiguous
float32 memory of its own that no later call touches, and
`runtime.BLOCKS_JOINED_IN_PLACE` counts its rows (none for a stream)."""

import functools

import numpy as np
import pytest
import torch

from hsc_torch import runtime
from hsc_torch.config import make_test_config
from hsc_torch.dictionary import MultilevelDictionary
from hsc_torch.io.bitstream import pack_corpus
from hsc_torch.runtime import CorpusEncoder, CorpusReader
from hsc_torch.signal import SignalGenerator

N_BLOCKS = 7
BATCH = 3  # chunks of 3, 3 and 1 blocks
FLAT = dict(counts=(12,))
TWO_LEVEL = dict(counts=(12, 8), scales=(16, 48), num_coefs=(96, 48))
KINDS = ["flat", "hier_top", "hier_distributed", "exotic", "no_footer"]


@functools.lru_cache(maxsize=None)
def _container(kind):
    """(dictionary, container bytes) of `N_BLOCKS` blocks: encoded flat
    (`no_footer`: without the seek-index footer) or top-only; or packed from
    the hierarchy's streams, every block distributed over both levels but
    block 1 (level 0 only) and block 4 (level 1 only), or top-only but
    block 4, which holds its level-1 stream twice (exotic)."""
    geometry = TWO_LEVEL if kind.startswith("hier") or kind == "exotic" else FLAT
    mld = MultilevelDictionary.generate(make_test_config(**geometry), seed=7)
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(N_BLOCKS, mld.config.block_size, seed=23)
    enc = CorpusEncoder(mld, device="cpu", batch_size=BATCH)
    if kind in ("flat", "hier_top", "no_footer"):
        return mld, enc.encode(xs, index=kind != "no_footer")
    streams = enc.coder.encode_batch(xs)
    if kind == "hier_distributed":
        blocks = [[(0, s[0]), (1, s[1])] for s in streams]
        blocks[1] = [(0, streams[1][0])]
        blocks[4] = [(1, streams[4][1])]
    else:
        blocks = [[(1, s[1])] for s in streams]
        blocks[4] = [(1, streams[4][1]), (1, streams[4][1])]
    return mld, pack_corpus(mld.config, blocks, index=True)


def _prepare(kind, codec):
    """In a distributed container, make every level's decode read -0.0
    where its rows are zero: a summed row is zero, then += each level's
    rows, so it reads +0.0 there, which an assignment of the first level's
    rows would not."""
    if kind != "hier_distributed":
        return
    real = codec._decode_padded

    def decode(*args):
        rows = real(*args)
        return torch.where(rows == 0, torch.full_like(rows, -0.0), rows)

    codec._decode_padded = decode


def _joined(fn):
    """(fn()'s result, the rows `BLOCKS_JOINED_IN_PLACE` grew by)."""
    before = runtime.BLOCKS_JOINED_IN_PLACE
    out = fn()
    return out, runtime.BLOCKS_JOINED_IN_PLACE - before


def _assert_join(kind, rows, parts, block_size):
    """`rows` is the stacked `parts`, byte for byte, as C-contiguous
    float32 memory that no torch tensor owns."""
    want = np.stack(parts) if parts else np.zeros((0, block_size), np.float32)
    assert rows.dtype == np.float32 and rows.shape == want.shape
    assert rows.flags.c_contiguous
    assert rows.flags.owndata or not isinstance(rows.base, torch.Tensor)
    assert rows.tobytes() == want.tobytes()
    if kind == "hier_distributed" and rows.size:
        zeros = rows[rows == 0]
        assert zeros.size and not np.signbit(zeros).any()


def _assert_unaliased(rows, again):
    """Writing to a join's output changes no later join."""
    want = rows.copy()
    rows[...] = 7.0
    assert again().tobytes() == want.tobytes()


SLICES = {"whole": (0, N_BLOCKS), "inner": (1, N_BLOCKS - 1), "short": (2, 4), "empty": (3, 3)}


@pytest.mark.parametrize("where", sorted(SLICES))
@pytest.mark.parametrize("kind", KINDS)
def test_reader_slice_joins_in_place(tmp_path, kind, where):
    mld, blob = _container(kind)
    path = tmp_path / "c.hsct"
    path.write_bytes(blob)
    lo, hi = SLICES[where]
    with CorpusReader(str(path), mld, device="cpu", batch_size=BATCH) as reader:
        _prepare(kind, reader.codec)
        parts, joined = _joined(lambda: list(reader.rows(lo, hi)))
        assert joined == 0
        rows, joined = _joined(lambda: reader[lo:hi])
        assert joined == hi - lo
        _assert_join(kind, rows, parts, mld.config.block_size)
        _assert_unaliased(rows, lambda: reader[lo:hi])


PICKS = {"repeated_unsorted": [5, 0, 5, 2, 2, 6], "none": [], "all": None}


@pytest.mark.parametrize("picks", sorted(PICKS))
@pytest.mark.parametrize("kind", KINDS)
def test_decode_joins_in_place(kind, picks):
    """`decode_blocks` of `picks`, or `decode` for all."""
    mld, blob = _container(kind)
    codec = CorpusEncoder(mld, device="cpu", batch_size=BATCH)
    _prepare(kind, codec)
    indices = PICKS[picks]
    if indices is None:
        call, n = (lambda: codec.decode(blob)), N_BLOCKS
    else:
        call, n = (lambda: codec.decode_blocks(blob, indices)), len(indices)
    parts, joined = _joined(lambda: list(codec.decode_stream(blob, indices)))
    assert joined == 0
    rows, joined = _joined(call)
    assert joined == n
    _assert_join(kind, rows, parts, mld.config.block_size)
    _assert_unaliased(rows, call)
