"""Restore of the distributed form on the CPU, held to the benchmark's plain
reference (`benchmark/reference/levels.py`) at a small hierarchy (2 levels,
block 2048).

- `CorpusReader` slices of a container written by the reference's frozen
  writer (`levels.records_distributed`) equal its per-level decode
  (`levels.decode_levels`) bit for bit, at batch 2 and 3, at starts and
  ends inside and on chunk boundaries, with blocks that hold level 0 only
  and blocks that hold level 1 only among the blocks that hold both;
- those slices unpack each chunk in one native call
  (`record_pack.unpack_level_records`), no block one by one;
- so does a container of the port's own ``CorpusEncoder(distributed=True)``
  encode;
- the writer's records are the port's `_emit_record` bytes, and the port's
  `unpack_block` reads them as `oracle.to_distributed` of the same top
  streams;
- the control that decodes every stream through the top level's
  representations differs from the reference.
"""

import functools
import io
import os
import sys

import numpy as np
import pytest

from hsc_torch import runtime
from hsc_torch.io.bitstream import unpack_block
from hsc_torch.oracle.mp import LevelStream, to_distributed
from hsc_torch.params import dictionary_from_arrays
from hsc_torch.runtime import CorpusEncoder, CorpusReader, _emit_record

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from hscbench import inputs  # noqa: E402
from hscbench.layers import load_file  # noqa: E402
from reference import container, levels  # noqa: E402
from reference.dictionary import MultilevelDictionary  # noqa: E402

N_BLOCKS = 11
SIGNALS = {"rates": 0.002, "amplitude_range": [0.25, 2.0]}
HIER = dict(counts=[8, 4], scales=[16, 48], block_size=2048, num_coefs=[48, 24], tolerance_snr=None,
            singleton_weight=0.9, amp_bits=16, num_select=4, entropy="fixed", decode_mode="integer",
            rep_bits=12, hier_init="int8")
LEVEL0_ONLY = (2, 7)  # every top event a singleton
LEVEL1_ONLY = (4,)  # no top event a singleton


@functools.lru_cache(maxsize=None)
def _dictionaries():
    """(the reference's config and dictionary, the port's dictionary)."""
    cfg = inputs.codec_config({"codec": HIER})
    ref = MultilevelDictionary.generate(cfg, seed=13)
    return cfg, ref, dictionary_from_arrays(cfg.to_json(), ref.dicts)


@functools.lru_cache(maxsize=None)
def _top_events():
    """Top-level events ``[N_BLOCKS, 24]`` from the benchmark's writer
    (`clients/restore_levels.py::top_events`), 1 to 23 of a block's events
    raw, equally often, so about half the atoms singletons, but the blocks
    of `LEVEL0_ONLY` (all singletons) and `LEVEL1_ONLY` (none)."""
    cfg, _, _ = _dictionaries()
    client = load_file(os.path.join(BENCH, "clients", "restore_levels.py"), "client_restore_levels")
    positions, atoms, codes, scales = client.top_events(
        cfg, N_BLOCKS, {"blocks_by_raw_events": [0] + [1] * (cfg.num_coefs[1] - 1)}, 5)
    raw = cfg.counts[1]
    atoms[list(LEVEL0_ONLY)] = raw + atoms[list(LEVEL0_ONLY)] % cfg.channels[1]
    atoms[list(LEVEL1_ONLY)] %= raw
    return positions, atoms, codes, scales


@functools.lru_cache(maxsize=None)
def _container() -> bytes:
    """The writer's container of `_top_events`, with the seek index."""
    cfg, _, _ = _dictionaries()
    buf = io.BytesIO()
    levels.write_records(cfg, levels.records_distributed(cfg, *_top_events()), buf)
    return buf.getvalue()


def _assert_rows_are_the_reference(data, rows, lo):
    cfg, ref, _ = _dictionaries()
    for i, row in enumerate(rows):
        want = levels.decode_levels(cfg, ref, data, lo + i)
        assert np.array_equal(want.view(np.uint32), row.view(np.uint32)), f"block {lo + i}"


def test_the_written_container_holds_blocks_of_one_level_and_of_both():
    cfg, _, _ = _dictionaries()
    data = _container()
    offsets = container.read_index(data)
    held = [[s.level for s in container.read_block(cfg, data, int(o))[0]] for o in offsets[:-1]]
    assert np.array_equal(offsets, container.block_offsets(data)[1])
    assert [held[b] for b in LEVEL0_ONLY] == [[0]] * len(LEVEL0_ONLY)
    assert [held[b] for b in LEVEL1_ONLY] == [[1]] * len(LEVEL1_ONLY)
    assert sum(h == [0, 1] for h in held) == N_BLOCKS - len(LEVEL0_ONLY) - len(LEVEL1_ONLY)


@pytest.mark.parametrize("batch", [2, 3])
@pytest.mark.parametrize("lo,hi", [(0, N_BLOCKS), (1, 5), (2, 8), (3, 4), (4, 11)])
def test_reader_slices_of_the_written_container_are_the_reference(batch, lo, hi, tmp_path):
    data = _container()
    path = tmp_path / "levels.hsct"
    path.write_bytes(data)
    _, _, port = _dictionaries()
    with CorpusReader(str(path), port, device="cpu", batch_size=batch) as reader:
        rows = reader[lo:hi]
    assert rows.shape == (hi - lo, HIER["block_size"]) and rows.dtype == np.float32
    _assert_rows_are_the_reference(data, rows, lo)


@pytest.mark.parametrize("batch", [2, 3])
def test_reader_slices_unpack_by_level_and_are_the_reference(batch, tmp_path):
    """Every block of the written container's slices unpacks in the native
    per-level call (`runtime.BLOCKS_UNPACKED_BY_LEVEL`), none singly, and
    the rows are the reference's."""
    data = _container()
    path = tmp_path / "levels.hsct"
    path.write_bytes(data)
    _, _, port = _dictionaries()
    before = (runtime.BLOCKS_UNPACKED_BATCHED, runtime.BLOCKS_UNPACKED_BY_LEVEL, runtime.BLOCKS_UNPACKED_SINGLY)
    with CorpusReader(str(path), port, device="cpu", batch_size=batch) as reader:
        rows = reader[1:N_BLOCKS]
    after = (runtime.BLOCKS_UNPACKED_BATCHED, runtime.BLOCKS_UNPACKED_BY_LEVEL, runtime.BLOCKS_UNPACKED_SINGLY)
    assert tuple(x - y for x, y in zip(after, before)) == (0, N_BLOCKS - 1, 0)
    _assert_rows_are_the_reference(data, rows, 1)


@pytest.mark.parametrize("batch", [2, 3])
def test_the_ports_distributed_encode_decodes_to_the_reference(batch, tmp_path):
    cfg, ref, port = _dictionaries()
    xs = inputs.signal_pool(ref, 6, SIGNALS, 29, "cpu")
    blob = CorpusEncoder(port, device="cpu", batch_size=batch, distributed=True).encode(xs, index=True)
    path = tmp_path / "enc.hsct"
    path.write_bytes(blob)
    offsets = container.read_index(blob)
    assert any(len(container.read_block(cfg, blob, int(o))[0]) > 1 for o in offsets[:-1])
    with CorpusReader(str(path), port, device="cpu", batch_size=batch) as reader:
        rows = reader[1:6]
    _assert_rows_are_the_reference(blob, rows, 1)


def test_the_writers_records_are_the_ports_distributed_records():
    cfg, _, port = _dictionaries()
    positions, atoms, codes, scales = _top_events()
    records = levels.records_distributed(cfg, positions, atoms, codes, scales)
    for b, record in enumerate(records):
        top = LevelStream(positions[b].astype(np.int32), atoms[b].astype(np.int32), codes[b].astype(np.int32),
                          np.float32(scales[b]), 0.0, 0.0)
        assert record == _emit_record(port.config, top, True), f"block {b}"
        streams, end = unpack_block(port.config, record, 0)
        assert end == len(record)
        want = to_distributed(port.config, top)
        assert [lv for lv, _ in streams] == [lv for lv, _ in want]
        for (_, got), (_, exp) in zip(streams, want):
            for field in ("positions", "atoms", "codes"):
                assert np.array_equal(getattr(got, field), getattr(exp, field)), (b, field)
            assert got.scale == exp.scale


def test_the_top_representations_control_differs_from_the_reference():
    cfg, ref, _ = _dictionaries()
    data = _container()
    for b in range(N_BLOCKS):
        want = levels.decode_levels(cfg, ref, data, b)
        ctrl = levels.decode_levels(cfg, ref, data, b, top_reps=True)
        # a block of level 1 alone decodes through the top's tables anyway
        assert np.array_equal(want, ctrl) == (b in LEVEL1_ONLY), f"block {b}"
