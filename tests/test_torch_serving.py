"""The port's serving surfaces against the JAX package on the CPU: the
seek-index footer (`encode(index=True)`), random access
(`decode_stream(indices=...)`, `decode_blocks`), the memory-mapped
`CorpusReader`, the per-block decode of exotic chunks, and the coders'
single-block API (`encode` / `reconstruct`, level space at level 1 included,
and `encode_corpus` / `decode_corpus`).

Mirrors tests/test_index.py.  Containers are byte-identical to the JAX
package's with JAX's level-0 init injected (README "Determinism contract");
rows from every surface are bitwise JAX's on JAX's own containers."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsc_tpu import MultilevelDictionary as JaxMLD
from hsc_tpu import SignalGenerator
from hsc_tpu.models.coder import ConvolutionalSparseCoder as JaxLevelCoder
from hsc_tpu.models.coder import HierarchicalConvolutionalSparseCoder as JaxCoder
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.ops.encode import encode_init_jax
from hsc_tpu.ops.encode import feature_map_jax
from hsc_tpu.runtime import CorpusEncoder as JaxCorpusEncoder

import hsc_torch.io.bitstream as port_bs
import hsc_torch.models.coder
import hsc_torch.ops.pipeline
from hsc_torch import CorpusReader
from hsc_torch.io import append_index, pack_corpus, read_index
from hsc_torch.models import ConvolutionalSparseCoder, HierarchicalConvolutionalSparseCoder
from hsc_torch.params import dictionary_from_arrays
from hsc_torch.runtime import CorpusEncoder
from pinned import oracle_encode_pinned


def _port(mld):
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


def _with(mld, **cfg):
    return JaxMLD(dataclasses.replace(mld.config, **cfg), [d.copy() for d in mld.dicts])


def _inject(monkeypatch, *modules):
    """Make each module call JAX's init where it looks up `encode_init_batched`."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    for module in modules or (hsc_torch.ops.pipeline,):
        monkeypatch.setattr(module, "encode_init_batched", init)


def _jax_blob(mld, n_blocks, seed, **kw):
    xs = SignalGenerator(mld, rates=4e-3).generate_signals(n_blocks, mld.config.block_size, seed=seed)
    enc = JaxCorpusEncoder(mld, backend="jax", batch_size=2, **kw)
    return enc, xs, enc.encode(xs)


def _rows_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("entropy", ["fixed", "rice"])
def test_index_container_byte_identical_to_jax(monkeypatch, mld1, entropy):
    mld = _with(mld1, entropy=entropy)
    jenc, xs, blob = _jax_blob(mld, 5, 11)
    ref = jenc.encode(xs, index=True)
    _inject(monkeypatch)
    codec = CorpusEncoder(_port(mld), device="cpu", batch_size=2)
    got = codec.encode(xs, index=True)
    assert got == ref == append_index(codec.encode(xs))
    assert read_index(got) is not None and got[: len(blob)] == blob


@pytest.mark.parametrize("entropy", ["fixed", "rice"])
@pytest.mark.parametrize("decode_mode", ["ordered", "integer"])
def test_random_access_rows_match_jax(mld1, entropy, decode_mode):
    """`decode`, `decode_blocks` and `decode_stream(indices=...)` on a JAX
    container, with and without the footer, in a shuffled order: every row
    bitwise JAX's full decode."""
    mld = _with(mld1, entropy=entropy, decode_mode=decode_mode)
    jenc, _, blob = _jax_blob(mld, 7, 13)
    full = jenc.decode(blob)
    codec = CorpusEncoder(_port(mld), device="cpu", batch_size=2)
    assert _rows_equal(codec.decode(blob), full)
    order = [5, 1, 6, 0, 3]
    for blob_v in (blob, append_index(blob)):
        assert _rows_equal(codec.decode_blocks(blob_v, order), full[order])
        rows = list(codec.decode_stream(blob_v, indices=[6, 2, 3]))
        assert _rows_equal(np.stack(rows), full[[6, 2, 3]])


def test_corrupt_and_stale_footer_degrade_to_scan(mld1):
    jenc, _, blob = _jax_blob(mld1, 6, 5)
    full = jenc.decode(blob)
    codec = CorpusEncoder(_port(mld1), device="cpu", batch_size=2)
    bad_off = bytearray(append_index(blob))
    bad_off[-20] ^= 0xFF  # inside the offsets: the crc rejects the footer
    bad_crc = bytearray(append_index(blob))
    bad_crc[-10] ^= 0xFF  # the stored crc itself
    for bad in (bytes(bad_off), bytes(bad_crc)):
        assert read_index(bad) is None
        assert _rows_equal(codec.decode_blocks(bad, [2, 0]), full[[2, 0]])
    # a crc-valid footer of a 4-block container grafted onto the 6-block one
    _, _, blob4 = _jax_blob(mld1, 4, 5)
    stale = blob + append_index(blob4)[len(blob4):]
    assert read_index(stale) is not None
    assert _rows_equal(codec.decode_blocks(stale, [5, 1]), full[[5, 1]])


def test_decode_blocks_bounds_and_empty(mld1):
    _, _, blob = _jax_blob(mld1, 3, 5)
    codec = CorpusEncoder(_port(mld1), device="cpu")
    for bad in ([3], [-1]):
        with pytest.raises(IndexError):
            codec.decode_blocks(blob, bad)
    with pytest.raises(IndexError):
        next(codec.decode_stream(blob, indices=[7]))
    assert codec.decode_blocks(blob, []).shape == (0, mld1.config.block_size)


def test_decode_blocks_distributed_container(mld2):
    xs = SignalGenerator(mld2, rates=2e-2).generate_signals(5, mld2.config.block_size, seed=79)
    jenc = JaxCorpusEncoder(mld2, backend="jax", batch_size=2, distributed=True)
    blob = jenc.encode(xs, index=True)
    full = jenc.decode(blob)
    codec = CorpusEncoder(_port(mld2), device="cpu", batch_size=2, distributed=True)
    assert _rows_equal(codec.decode_blocks(blob, [4, 0, 2]), full[[4, 0, 2]])
    assert _rows_equal(codec.decode(blob), full)


def test_decode_stream_unpacks_lazily(mld1, monkeypatch):
    """After the first row, only ~pipeline-depth chunks are unpacked."""
    jenc, _, blob = _jax_blob(mld1, 12, 5)
    codec = CorpusEncoder(_port(mld1), device="cpu", batch_size=1)
    calls = {"n": 0}
    real = port_bs.unpack_block

    def counting(cfg, data, off):
        calls["n"] += 1
        return real(cfg, data, off)

    monkeypatch.setattr(port_bs, "unpack_block", counting)
    it = codec.decode_stream(blob)
    first = next(it)
    assert first.shape == (mld1.config.block_size,) and calls["n"] <= 6, calls["n"]
    rows = [first] + list(it)
    assert calls["n"] == 12
    assert _rows_equal(np.stack(rows), jenc.decode(blob))


@pytest.mark.parametrize(
    "indexed, entropy",
    [
        pytest.param(False, "fixed", id="False"),
        pytest.param(True, "fixed", id="True"),
        # the records unpack block by block and their streams are padded
        pytest.param(True, "rice", id="rice"),
    ],
)
def test_corpus_reader(tmp_path, mld1, indexed, entropy):
    """Rows, negative indices, slices (one across a chunk boundary, one
    empty) and ranges of a memory-mapped file, bitwise JAX's full decode,
    the port's and JAX's own reader."""
    from hsc_tpu.runtime import CorpusReader as JaxReader

    mld = _with(mld1, entropy=entropy)
    jenc, _, blob = _jax_blob(mld, 9, 7)
    full = jenc.decode(blob)
    assert _rows_equal(CorpusEncoder(_port(mld), device="cpu", batch_size=2).decode(blob), full)
    p = tmp_path / "c.hsct"
    p.write_bytes(append_index(blob) if indexed else blob)
    with CorpusReader(str(p), _port(mld), device="cpu", batch_size=2) as rd:
        assert len(rd) == 9
        assert _rows_equal(rd[3], full[3]) and _rows_equal(rd[-1], full[8])
        assert _rows_equal(rd[2:5], full[2:5])
        assert _rows_equal(rd[3:3], full[3:3])
        assert _rows_equal(np.stack(list(rd.rows())), full)
        assert _rows_equal(np.stack(list(rd.rows(4, 7))), full[4:7])
    with JaxReader(str(p), mld, backend="jax", batch_size=2) as jr:
        assert _rows_equal(jr[2:5], full[2:5])


def test_corpus_reader_refuses_other_geometry(tmp_path, mld1, mld2):
    _, _, blob = _jax_blob(mld1, 2, 7)
    p = tmp_path / "c.hsct"
    p.write_bytes(blob)
    with pytest.raises(ValueError, match="does not match"):
        CorpusReader(str(p), _port(mld2), device="cpu")


def test_exotic_chunk_decodes_like_jax(mld1):
    """A block holding two streams of one level (the shape no encoder
    writes) decodes block by block through the coder's single-block
    `reconstruct`: rows bitwise JAX's, beside ordinary blocks."""
    jenc, _, blob = _jax_blob(mld1, 3, 9)
    _, blocks = port_bs.unpack_corpus(blob)
    (lv, s0), = blocks[0]
    (_, s1), = blocks[1]
    mixed = pack_corpus(_port(mld1).config, [[(lv, s0), (lv, s1)], blocks[2], [(lv, s1), (lv, s0)]])
    want = jenc.decode(mixed)
    codec = CorpusEncoder(_port(mld1), device="cpu", batch_size=2)
    assert _rows_equal(codec.decode(mixed), want)
    assert _rows_equal(codec.decode_blocks(mixed, [2, 0]), want[[2, 0]])


def _streams_equal(a, b) -> bool:
    return all(getattr(a, f).tobytes() == getattr(b, f).tobytes() for f in ("positions", "atoms", "codes")) and (
        np.float32(a.scale) == np.float32(b.scale)
    )


def test_single_level_coder_matches_jax(monkeypatch, mld1):
    """`ConvolutionalSparseCoder.encode` / `reconstruct` of one block (JAX's
    init injected): the stream and the decoded ``[N, 1]`` bitwise JAX's."""
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(1, mld1.config.block_size, seed=31)[0]
    jc = JaxLevelCoder(mld1, 0, backend="jax")
    want = jc.encode(x)
    _inject(monkeypatch, hsc_torch.models.coder)
    pc = ConvolutionalSparseCoder(_port(mld1), 0, device="cpu")
    got = pc.encode(x)
    assert _streams_equal(got, want) and got.positions.shape[0] > 0
    assert _rows_equal(pc.reconstruct(got), jc.reconstruct(want))
    n = mld1.config.block_size + 77  # a longer output than the block
    assert _rows_equal(pc.reconstruct(got, n=n), jc.reconstruct(want, n=n))


@pytest.mark.parametrize("shape", ["[N]", "[N, 1]"])
def test_compute_coefficients_matches_jax(monkeypatch, mld1, shape):
    """`ConvolutionalMatchingPursuit.compute_coefficients` of one block
    against JAX's single-block `compute_coefficients` (`mp_encode_jax` on the
    'jax' backend, ``[N]`` promoted to ``[N, 1]``), JAX's single-block init
    `encode_init_jax` injected: the fixed-shape fields, the events up to
    `count`, count, scale and energy0 bitwise JAX's.  energy_res is held to
    the oracle on the same init, the spec: JAX's XLA loop is a few ulps off
    it (ROADMAP Queue 3)."""
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(1, mld1.config.block_size, seed=37)[0]
    x = x if shape == "[N]" else x[:, None]
    want = JaxLevelCoder(mld1, 0, backend="jax").mp.compute_coefficients(x)

    def init(xb, bank):
        (xb,) = xb.numpy()  # one block, as compute_coefficients gives it
        out = encode_init_jax(jnp.asarray(xb), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)[None]) for a in out)

    monkeypatch.setattr(hsc_torch.models.coder, "encode_init_batched", init)
    got = ConvolutionalSparseCoder(_port(mld1), 0, device="cpu").mp.compute_coefficients(x)
    got = {f: v.numpy() for f, v in got._asdict().items()}
    want = {f: np.asarray(v) for f, v in want._asdict().items()}
    n = int(want["count"])
    assert n > 0 and int(got["count"]) == n
    for f in ("positions", "atoms", "codes"):
        assert got[f].shape == want[f].shape == (mld1.config.num_coefs[0],)
        assert got[f].dtype == want[f].dtype and got[f][:n].tobytes() == want[f][:n].tobytes(), f
    for f in ("count", "scale", "energy0", "energy_res"):
        assert got[f].shape == want[f].shape == () and got[f].dtype == want[f].dtype, f
    for f in ("count", "scale", "energy0"):
        assert got[f].tobytes() == want[f].tobytes(), f
    ref = oracle_encode_pinned(np.asarray(x, np.float32).reshape(-1, 1), mld1)
    assert got["energy_res"] == np.float32(ref.energy_res) and ref.positions.shape[0] == n


@pytest.mark.parametrize("shape", ["[N]", "[N, 1]"])
def test_compute_coefficients_is_the_batch_at_row_0(mld1, shape):
    """`ConvolutionalMatchingPursuit.compute_coefficients` of one block is
    `compute_coefficients_batch` of that block alone, row 0, bitwise, with
    no batch axis."""
    x = SignalGenerator(mld1, rates=4e-3).generate_signals(1, mld1.config.block_size, seed=39)[0]
    x = x if shape == "[N]" else x[:, None]
    mp = ConvolutionalSparseCoder(_port(mld1), 0, device="cpu").mp
    got = mp.compute_coefficients(x)
    want = mp.compute_coefficients_batch(x[None])
    assert int(got.count) > 0 and got.positions.shape == (mld1.config.num_coefs[0],)
    for g, w in zip(got, want):
        assert g.shape == w.shape[1:] and torch.equal(g, w[0])


def test_level_space_coder_at_level_1_matches_jax(monkeypatch, mld2):
    """The level-1 coder on its own input, the ``[N1, C]`` float map of a
    level-0 stream (C = 12 level-0 atoms): `encode` (JAX's init injected)
    and the level-space `reconstruct` against the augmented bank
    ``[K, W, C]`` (the ordered decode at C > 1) bitwise JAX's."""
    cfg = mld2.config
    x = SignalGenerator(mld2, rates=4e-3).generate_signals(1, cfg.block_size, seed=33)[0]
    jcoder = JaxCoder(mld2, backend="jax")
    enc0 = jcoder._encode_device(jnp.asarray(x))[0]
    x1 = np.asarray(feature_map_jax(enc0, npos=cfg.num_positions(0), k=mld2.num_atoms(0)))
    assert x1.ndim == 2 and x1.shape[1] == mld2.num_atoms(0) > 1
    jc = jcoder.coders[1]
    want = jc.encode_batch(x1[None])[0]
    _inject(monkeypatch, hsc_torch.models.coder)
    pc = ConvolutionalSparseCoder(_port(mld2), 1, device="cpu")
    got = pc.encode(x1)
    assert _streams_equal(got, want) and got.positions.shape[0] > 0
    rec = pc.reconstruct(got)
    assert rec.shape == (cfg.seq_len(1), mld2.num_atoms(0))
    assert _rows_equal(rec, jc.reconstruct(want))


@pytest.mark.parametrize("mode", ["ordered", "integer"])
def test_hier_coder_single_block_matches_jax(monkeypatch, mld2, mode):
    """`HierarchicalConvolutionalSparseCoder.encode` of one block (JAX's
    level-0 init injected; level 1 through the int8 init) and `reconstruct`
    of its top stream, and of its level-0 stream at level 0, bitwise JAX's;
    each equals the batched form at B = 1."""
    mld = _with(mld2, decode_mode=mode)
    x = SignalGenerator(mld, rates=4e-3).generate_signals(1, mld.config.block_size, seed=35)[0]
    jc = JaxCoder(mld, backend="jax")
    want = jc.encode(x)
    _inject(monkeypatch, hsc_torch.models.coder)
    pc = HierarchicalConvolutionalSparseCoder(_port(mld), device="cpu")
    got = pc.encode(x)
    assert all(_streams_equal(a, b) for a, b in zip(got, want))
    for level in (None, 0):
        stream = got[-1] if level is None else got[0]
        rec = pc.reconstruct(stream, level=level)
        assert _rows_equal(rec, jc.reconstruct(stream, level=level))
        assert _rows_equal(rec, pc.reconstruct_batch([stream], level=level)[0])


def test_encode_corpus_decode_corpus_match_jax(monkeypatch, mld2):
    xs = SignalGenerator(mld2, rates=4e-3).generate_signals(3, mld2.config.block_size, seed=37)
    jc = JaxCoder(mld2, backend="jax")
    ref = jc.encode_corpus(xs)
    _inject(monkeypatch, hsc_torch.models.coder)
    pc = HierarchicalConvolutionalSparseCoder(_port(mld2), device="cpu")
    blob = pc.encode_corpus(xs)
    assert blob == ref
    assert _rows_equal(pc.decode_corpus(blob), jc.decode_corpus(blob))
    other = _with(mld2, num_select=3)
    with pytest.raises(ValueError, match="does not match"):
        HierarchicalConvolutionalSparseCoder(_port(other), device="cpu").decode_corpus(blob)
