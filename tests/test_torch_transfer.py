"""The port's asynchronous transfers (`hsc_torch.device.to_device`,
`copy_to_host_async`, `hsc_torch.utils.device_get_pipelined`) on the CPU:
`device_get_pipelined` against the JAX package's, the order of copy starts
and waits in it and in the runtime's decode, and the CPU path's plain
copies.  What they buy on a card (no stream synchronize inside the batch
loops) is checked by `chip_smoke.py` phase 19."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hsc_tpu.utils
from hsc_tpu.ops.encode import EncodedBlock as JaxEncodedBlock

import hsc_torch.ops.pipeline
import hsc_torch.runtime
import hsc_torch.utils
from hsc_torch import MultilevelDictionary, SignalGenerator, make_test_config
from hsc_torch.device import HostCopy, copy_to_host_async, to_device
from hsc_torch.ops.encode import EncodedBlock
from hsc_torch.ops.pipeline import encode_batches_pipelined
from hsc_torch.runtime import CorpusEncoder

# a flat and a 2-level geometry small enough for the CPU
FLAT = dict(counts=(12,), scales=(24,), block_size=1024, num_coefs=(48,), num_select=2)
HIER = dict(counts=(10, 6), scales=(12, 36), block_size=1024, num_coefs=(64, 24))


def _fields(rng, b: int = 3, m: int = 5) -> list[np.ndarray]:
    """The seven fields of a batched `EncodedBlock` of `b` blocks."""
    return [
        rng.integers(0, 900, (b, m)).astype(np.int32),
        rng.integers(0, 12, (b, m)).astype(np.int32),
        rng.integers(-32767, 32768, (b, m)).astype(np.int32),
        rng.integers(0, m + 1, (b,)).astype(np.int32),
        *(rng.random(b).astype(np.float32) for _ in range(3)),
    ]


@pytest.mark.parametrize("shape", ["one block", "a list"])
def test_device_get_pipelined_equals_jax(shape):
    """The port's `device_get_pipelined` gives what `hsc_tpu.utils
    .device_get_pipelined` gives on `jnp` arrays made from the same seeded
    data: the same structure, types, dtypes and bytes."""
    rng = np.random.default_rng(13)
    data = [_fields(rng) for _ in range(3)]
    if shape == "one block":
        port = [EncodedBlock(*map(torch.from_numpy, data[0]))]
        ref = [JaxEncodedBlock(*map(jnp.asarray, data[0]))]
    else:
        port = [[EncodedBlock(*map(torch.from_numpy, d)) for d in data]]
        ref = [[JaxEncodedBlock(*map(jnp.asarray, d)) for d in data]]
    got = hsc_torch.utils.device_get_pipelined(port)
    want = hsc_tpu.utils.device_get_pipelined(ref)
    assert len(got) == len(want) == 1
    got_blocks = got[0] if shape == "a list" else got
    want_blocks = want[0] if shape == "a list" else want
    assert type(got[0]) is (list if shape == "a list" else EncodedBlock)
    assert len(got_blocks) == len(want_blocks)
    for g, w in zip(got_blocks, want_blocks):
        assert type(g) is EncodedBlock and g._fields == w._fields
        for x, y in zip(g, w):
            y = np.asarray(y)
            assert isinstance(x, np.ndarray)
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def _record_copies(monkeypatch, module):
    """Log every copy `module` starts through `copy_to_host_async` and every
    wait on one of them: ``[("start", k), ..., ("wait", k), ...]``."""
    log = []
    started = []  # the handles, kept alive so that none is confused with another

    def start(t):
        started.append(copy_to_host_async(t))
        log.append(("start", len(started) - 1))
        return started[-1]

    real_numpy = HostCopy.numpy

    def wait(self):
        k = next((k for k, h in enumerate(started) if h is self), None)
        if k is not None:  # a copy that another module started is not logged
            log.append(("wait", k))
        return real_numpy(self)

    monkeypatch.setattr(module, "copy_to_host_async", start)
    monkeypatch.setattr(HostCopy, "numpy", wait)
    return log


def test_every_copy_starts_before_the_first_wait(monkeypatch):
    """`device_get_pipelined` starts the copy of every leaf of every tree
    before it waits on the first one, then waits on each once, in order."""
    log = _record_copies(monkeypatch, hsc_torch.utils)
    rng = np.random.default_rng(5)
    trees = [EncodedBlock(*map(torch.from_numpy, _fields(rng))) for _ in range(3)]
    hsc_torch.utils.device_get_pipelined(trees)
    n = 3 * 7
    assert log == [("start", k) for k in range(n)] + [("wait", k) for k in range(n)]


def test_corpus_encode_fetches_every_batch_at_once(monkeypatch):
    """`CorpusEncoder.encode` hands every batch's events to one
    `device_get_pipelined` call, as the JAX runtime does, and writes the
    container of an unobserved run."""
    cfg = make_test_config(**FLAT)
    mld = MultilevelDictionary.generate(cfg, seed=3)
    xs = SignalGenerator(mld, rates=2e-2).generate_signals(5, cfg.block_size, seed=4)
    want = CorpusEncoder(mld, device="cpu", batch_size=2).encode(xs)
    calls = []
    real = hsc_torch.runtime.device_get_pipelined

    def fetch(trees):
        calls.append(len(trees))
        return real(trees)

    monkeypatch.setattr(hsc_torch.runtime, "device_get_pipelined", fetch)
    assert CorpusEncoder(mld, device="cpu", batch_size=2).encode(xs) == want
    assert calls == [3]


@pytest.mark.parametrize("window", [2, None])
def test_pipeline_starts_each_peak_copy_at_its_init(monkeypatch, window):
    """`encode_batches_pipelined` starts a batch's peak copy right after
    dispatching its init, and waits on batch k's copy only once the inits
    of the window ahead of it are dispatched (all of them at window
    None)."""
    cfg = make_test_config(**FLAT)
    mld = MultilevelDictionary.generate(cfg, seed=3)
    xs = SignalGenerator(mld, rates=2e-2).generate_signals(8, cfg.block_size, seed=4)
    batches = [xs[i : i + 2][:, :, None] for i in range(0, 8, 2)]
    mp = CorpusEncoder(mld, device="cpu").coder.coders[0].mp
    log = _record_copies(monkeypatch, hsc_torch.ops.pipeline)
    real_init = hsc_torch.ops.pipeline.encode_init_batched

    def init(*args):
        log.append(("init", sum(e[0] == "init" for e in log)))
        return real_init(*args)

    monkeypatch.setattr(hsc_torch.ops.pipeline, "encode_init_batched", init)
    encode_batches_pipelined(batches, mp.params, device="cpu", backend=mp.backend, window=window,
                             **mp.settings)
    n, ahead = len(batches), len(batches) if window is None else window
    inits = [i for i, e in enumerate(log) if e[0] == "init"]
    assert [log[i + 1] for i in inits] == [("start", k) for k in range(n)]
    assert [e[1] for e in log if e[0] == "wait"] == list(range(n))
    for k in range(n):
        assert log.index(("wait", k)) > log.index(("start", min(k + ahead - 1, n - 1)))


def _hier_streams(n: int):
    """A 2-level codec and the per-block streams of `n` blocks."""
    cfg = make_test_config(**HIER)
    mld = MultilevelDictionary.generate(cfg, seed=21)
    xs = SignalGenerator(mld, rates=2e-2).generate_signals(n, cfg.block_size, seed=22)
    codec = CorpusEncoder(mld, device="cpu", batch_size=1)
    return codec, codec.coder.encode_batch(xs)


@pytest.mark.parametrize("shape", ["top-only", "distributed", "exotic"])
def test_decode_chunks_start_copies_at_submit(monkeypatch, shape):
    """`_decode_chunks` starts a decode's copy-back right after dispatching
    the decode, not when it drains it; it drains a unit only once 4 are in
    flight (or at the end); and it yields the rows of per-block
    `reconstruct` sums in container order for top-only, distributed
    (a stream per level) and exotic (two streams of one level) blocks."""
    codec, streams = _hier_streams(6)
    cfg = codec.cfg
    if shape == "top-only":
        blocks = [[(1, s[1])] for s in streams]
    elif shape == "distributed":
        blocks = [[(0, s[0]), (1, s[1])] for s in streams]
    else:
        blocks = [[(1, s[1]), (1, s[1])] for s in streams]
    want = np.zeros((6, cfg.block_size), np.float32)
    for b, block in enumerate(blocks):
        for level, st in block:
            want[b] += codec.coder.reconstruct(st, level=level, mode=cfg.decode_mode)
    log = _record_copies(monkeypatch, hsc_torch.runtime)
    real_decode = codec._decode_padded

    def decode(*args, **kwargs):
        log.append(("decode", sum(e[0] == "decode" for e in log)))
        return real_decode(*args, **kwargs)

    monkeypatch.setattr(codec, "_decode_padded", decode)
    rows = np.concatenate(list(codec._decode_chunks(cfg, iter(blocks), cfg.decode_mode, None)))
    assert rows.tobytes() == want.tobytes()
    if shape == "exotic":  # decoded block by block, not pipelined
        assert log == []
        return
    units = 6 if shape == "top-only" else 12
    decodes = [i for i, e in enumerate(log) if e[0] == "decode"]
    assert len(decodes) == units
    for k, i in enumerate(decodes):
        assert log[i + 1] == ("start", k)
    waits = [e[1] for e in log if e[0] == "wait"]
    assert waits == list(range(units))
    for k in range(units):
        # unit k is waited for only once unit min(k + 3, last) was started
        assert log.index(("wait", k)) > log.index(("start", min(k + 3, units - 1)))


def test_cpu_path_pins_nothing(monkeypatch):
    """On the CPU the transfers are plain: `to_device` and
    `copy_to_host_async` copy nothing and touch neither pinned memory nor
    CUDA, and a 2-level encode and decode run with both forbidden."""

    def forbidden(*args, **kwargs):
        raise AssertionError("the CPU path touched pinned memory or CUDA")

    real_empty = torch.empty

    def empty(*args, **kwargs):
        if kwargs.get("pin_memory"):
            forbidden()
        return real_empty(*args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "pin_memory", forbidden)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "current_stream", forbidden)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = to_device(a, "cpu")
    assert t.device.type == "cpu" and np.shares_memory(t.numpy(), a)
    assert np.shares_memory(copy_to_host_async(t).numpy(), a)
    codec, streams = _hier_streams(3)
    xs = SignalGenerator(codec.mld, rates=2e-2).generate_signals(3, codec.cfg.block_size, seed=22)
    rows = codec.decode(codec.encode(xs))
    assert rows.shape == (3, codec.cfg.block_size) and np.isfinite(rows).all()
