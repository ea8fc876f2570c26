"""The port's constant-bitrate mode (`target_bps`, `rate_mode` 'block' and
'corpus') against the JAX package on the CPU, and the container-mutation
fuzz over the port's read surfaces.

Mirrors the rate-control cases of tests/test_runtime.py and
tests/test_fuzz_container.py.  With JAX's level-0 init injected, every
container is byte-identical to the JAX package's, in both entropies, top
form and distributed form; rows of CBR containers through every serving
surface are bitwise JAX's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsc_tpu import MultilevelDictionary as JaxMLD
from hsc_tpu import SignalGenerator
from hsc_tpu.ops.encode import encode_init_batched as jax_init
from hsc_tpu.runtime import CorpusEncoder as JaxCorpusEncoder
from hsc_tpu.runtime import allocate_corpus_prefixes as jax_allocate

import hsc_torch.ops.pipeline
from hsc_torch import CorpusReader
from hsc_torch.io import iter_blocks, scan_block_offsets, unpack_corpus
from hsc_torch.oracle.mp import LevelStream
from hsc_torch.params import dictionary_from_arrays
from hsc_torch.runtime import CorpusEncoder, allocate_corpus_prefixes


def _port(mld):
    return dictionary_from_arrays(mld.config.to_json(), mld.dicts)


def _with(mld, **cfg):
    return JaxMLD(dataclasses.replace(mld.config, **cfg), [d.copy() for d in mld.dicts])


@pytest.fixture
def inject(monkeypatch):
    """JAX's init where the port's pipeline looks up `encode_init_batched`."""
    def init(xb, bank):
        out = jax_init(jnp.asarray(xb.numpy()), jnp.asarray(bank.numpy()))
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(hsc_torch.ops.pipeline, "encode_init_batched", init)


def _hetero_corpus(mld, nb=6, seed=81):
    """Easy and hard blocks (event rates 10x apart): the corpus where
    per-block CBR strands budget on the easy blocks."""
    xs_e = SignalGenerator(mld, rates=8e-4).generate_signals(nb // 2, mld.config.block_size, seed=seed)
    xs_h = SignalGenerator(mld, rates=8e-3).generate_signals(nb - nb // 2, mld.config.block_size, seed=seed + 1)
    return np.concatenate([xs_e, xs_h])


def _both(mld, xs, **kw):
    """(JAX's container, the port's container) for one corpus and setting."""
    ref = JaxCorpusEncoder(mld, backend="jax", batch_size=2, **kw).encode(xs)
    return ref, CorpusEncoder(_port(mld), device="cpu", batch_size=2, **kw).encode(xs)


@pytest.mark.parametrize("entropy", ["fixed", "rice"])
@pytest.mark.parametrize("rate_mode", ["block", "corpus"])
def test_cbr_containers_byte_identical_to_jax(inject, mld1, entropy, rate_mode):
    """Below the unconstrained rate: the same bytes as JAX, events that are
    greedy prefixes of the full encode (in fixed entropy, which stores them
    in greedy order), the budget respected (per block or over the block
    region); a generous budget is a byte-level no-op."""
    mld = _with(mld1, entropy=entropy)
    xs = _hetero_corpus(mld, nb=4, seed=83)
    target = 0.4
    ref, blob = _both(mld, xs, target_bps=target, rate_mode=rate_mode)
    assert blob == ref
    full = CorpusEncoder(_port(mld), device="cpu", batch_size=2).encode(xs)
    assert len(blob) < len(full)
    cfg = mld.config
    _, offs = scan_block_offsets(blob)
    sizes = np.diff(offs)
    if rate_mode == "block":
        assert (sizes <= int(target * cfg.block_size / 8)).all()
    else:
        assert int(sizes.sum()) <= int(target * cfg.block_size * len(xs) / 8)
    for streams, full_streams in zip(iter_blocks(blob), iter_blocks(full)):
        (_, s), = streams
        (_, f), = full_streams
        k = s.positions.shape[0]
        if entropy == "fixed":  # rice stores events re-sorted by position
            assert s.codes.tobytes() == f.codes[:k].tobytes()
            assert s.positions.tobytes() == f.positions[:k].tobytes()
        assert k <= f.positions.shape[0]
    loose = CorpusEncoder(_port(mld), device="cpu", batch_size=2, target_bps=64.0, rate_mode=rate_mode)
    assert loose.encode(xs) == full


@pytest.mark.parametrize("entropy", ["fixed", "rice"])
@pytest.mark.parametrize("rate_mode", ["block", "corpus"])
def test_cbr_hierarchical_distributed_byte_identical_to_jax(inject, mld2, entropy, rate_mode):
    """CBR with the 2-level hierarchy (int8 level-1 init) in distributed
    form: the budget is charged against the emitted records, and the
    containers equal JAX's and decode to JAX's rows."""
    mld = _with(mld2, entropy=entropy)
    xs = SignalGenerator(mld, rates=[np.full(12, 4e-3), np.full(8, 1e-3)]).generate_signals(
        3, mld.config.block_size, seed=78)
    ref, blob = _both(mld, xs, distributed=True, target_bps=1.0, rate_mode=rate_mode)
    assert blob == ref
    assert any(len(streams) > 1 for streams in iter_blocks(blob))
    rows = CorpusEncoder(_port(mld), device="cpu", batch_size=2).decode(blob)
    assert rows.tobytes() == JaxCorpusEncoder(mld, backend="jax", batch_size=2).decode(blob).tobytes()


def test_cbr_floor_and_validation(mld1):
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(2, mld1.config.block_size, seed=85)
    for rate_mode in ("block", "corpus"):
        with pytest.raises(ValueError, match="floor"):
            CorpusEncoder(_port(mld1), device="cpu", target_bps=1e-4, rate_mode=rate_mode).encode(xs)
    with pytest.raises(ValueError, match="positive"):
        CorpusEncoder(_port(mld1), device="cpu", target_bps=0.0)
    with pytest.raises(ValueError, match="rate_mode"):
        CorpusEncoder(_port(mld1), device="cpu", rate_mode="frame")


def test_corpus_allocation_beats_block_cbr(inject, mld1):
    """At equal target_bps on a heterogeneous corpus, the corpus-wide
    allocation moves events from easy to hard blocks and explains more
    energy than per-block CBR — as in the JAX package."""
    xs = _hetero_corpus(mld1)
    codec_c = CorpusEncoder(_port(mld1), device="cpu", batch_size=2, target_bps=0.4, rate_mode="corpus")
    codec_b = CorpusEncoder(_port(mld1), device="cpu", batch_size=2, target_bps=0.4)
    blob_c, blob_b = codec_c.encode(xs), codec_b.encode(xs)
    ks = [s[0][1].positions.shape[0] for s in iter_blocks(blob_c)]
    assert np.mean(ks[:3]) < np.mean(ks[3:])

    def err(blob, codec):
        return float(np.sum((xs - codec.decode(blob)).astype(np.float64) ** 2))

    assert err(blob_c, codec_c) < err(blob_b, codec_b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocate_corpus_prefixes_matches_jax(seed):
    """The allocator alone on random streams (non-monotone gains, an empty
    stream) with a size model that wobbles like rice: the same payloads and
    prefix lengths as JAX's, inside the budget."""
    rng = np.random.default_rng(seed)
    streams = []
    for n in (0, *rng.integers(1, 60, size=5)):
        streams.append(LevelStream(
            positions=rng.integers(0, 900, n).astype(np.int32), atoms=rng.integers(0, 16, n).astype(np.int32),
            codes=rng.integers(-32767, 32768, n).astype(np.int32), scale=np.float32(rng.uniform(1e-5, 1e-3)),
            energy0=0.0, energy_res=0.0,
        ))

    def emit(s):
        n = int(s.positions.shape[0])
        return bytes(3 + 4 * n + int(np.abs(s.codes).sum()) % 3)

    budget = int(sum(len(emit(s)) for s in streams) * 0.6)
    got = allocate_corpus_prefixes(streams, budget, emit)
    assert got == jax_allocate(streams, budget, emit)
    assert sum(len(p) for p in got[0]) <= budget


def test_cbr_containers_serve_everywhere(tmp_path, mld1):
    """CBR containers written by JAX (both rate modes, indexed): the port's
    `decode`, `decode_stream`, `decode_blocks` and `CorpusReader` rows are
    bitwise JAX's."""
    xs = _hetero_corpus(mld1, nb=4, seed=95)
    codec = CorpusEncoder(_port(mld1), device="cpu", batch_size=2)
    for rate_mode in ("block", "corpus"):
        jenc = JaxCorpusEncoder(mld1, backend="jax", batch_size=2, target_bps=0.4, rate_mode=rate_mode)
        blob = jenc.encode(xs, index=True)
        full = jenc.decode(blob)
        assert codec.decode(blob).tobytes() == full.tobytes()
        assert np.stack(list(codec.decode_stream(blob))).tobytes() == full.tobytes()
        assert codec.decode_blocks(blob, [2, 0]).tobytes() == full[[2, 0]].tobytes()
        p = tmp_path / f"s_{rate_mode}.hsct"
        p.write_bytes(blob)
        with CorpusReader(str(p), _port(mld1), device="cpu", batch_size=2) as rd:
            assert rd[1].tobytes() == full[1].tobytes()
            assert np.stack(list(rd.rows(1, 3))).tobytes() == full[1:3].tobytes()


def _mutate(rng, blob: bytes, lo: int, hi: int) -> bytes:
    """Overwrite a random run of 2-64 bytes inside [lo, hi) with random bytes."""
    if hi - lo < 2:
        return blob
    n = int(rng.integers(2, min(64, hi - lo) + 1))
    at = int(rng.integers(lo, hi - n + 1))
    bad = bytearray(blob)
    bad[at : at + n] = bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
    return bytes(bad)


def _try_all_surfaces(codec, mld, blob: bytes, path):
    """One (possibly corrupted) container through every read surface of the
    port: each raises a clean Python exception or returns shape-bounded
    rows (surviving is the assertion: an out-of-bounds read would crash)."""
    bs = mld.config.block_size
    try:
        _, blocks = unpack_corpus(blob)
    except Exception:
        blocks = None
    if blocks is not None:
        try:
            out = codec.decode(blob)
            assert out.shape[1] == bs and out.shape[0] <= max(len(blocks), 2)
        except Exception:
            pass
    try:
        assert codec.decode_blocks(blob, [0]).shape == (1, bs)
    except Exception:
        pass
    path.write_bytes(blob)
    try:
        with CorpusReader(str(path), mld, device="cpu", batch_size=2) as rd:
            if len(rd):
                assert rd[0].shape == (bs,)
    except Exception:
        pass


@pytest.mark.parametrize("entropy", ["fixed", "rice"])
def test_mutation_fuzz_all_surfaces(tmp_path, mld1, entropy):
    """Seeded multi-byte mutations of the config JSON, the payloads and the
    seek-index footer, and truncations, of an ordinary and a corpus-CBR
    container (both written by the port), through every read surface."""
    import struct

    mld = _port(_with(mld1, entropy=entropy))
    xs = SignalGenerator(mld1, rates=4e-3).generate_signals(2, mld.config.block_size, seed=51)
    codec = CorpusEncoder(mld, device="cpu", batch_size=2)
    blobs = (codec.encode(xs, index=True),
             CorpusEncoder(mld, device="cpu", batch_size=2, target_bps=0.4, rate_mode="corpus").encode(xs, index=True))
    rng = np.random.default_rng(52)
    for blob in blobs:
        _, cfg_len = struct.unpack_from("<BI", blob, 4)
        c0 = 4 + struct.calcsize("<BI")
        c1 = c0 + cfg_len
        regions = [(c0, c1), (c1 + 4, len(blob) - 48), (max(len(blob) - 48, c1), len(blob)), (4, len(blob))]
        for mi in range(16):
            lo, hi = regions[mi % len(regions)]
            _try_all_surfaces(codec, mld, _mutate(rng, blob, lo, max(hi, lo + 2)), tmp_path / "m.hsct")
        for _ in range(6):
            _try_all_surfaces(codec, mld, blob[: int(rng.integers(0, len(blob)))], tmp_path / "t.hsct")
