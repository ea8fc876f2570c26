"""Block-granular encode journal — idempotent restart (SURVEY.md §5
"Failure detection / elastic recovery").

The reference has no recovery story (a crash loses the run).  Here the unit
of work is one block's packed stream: each finished block appends its payload
to a data file and a line ``block_id offset length crc32`` to the journal.
On restart, finished blocks are skipped and their bytes reused; assembly
always emits original block order regardless of completion order
(multi-host: each process journals its own shard, process 0 assembles).

The port's own copy of `hsc_tpu/io/journal.py`, verbatim: a journal written
by either package resumes in the other, and tests/test_torch_copies.py holds
the copy equal to the original.
"""

from __future__ import annotations

import os
import zlib


class EncodeJournal:
    def __init__(
        self, directory: str, name: str = "corpus", config_json: str | None = None
    ):
        os.makedirs(directory, exist_ok=True)
        self._jpath = os.path.join(directory, f"{name}.journal")
        self._dpath = os.path.join(directory, f"{name}.blocks")
        self._cpath = os.path.join(directory, f"{name}.config")
        self._index: dict[int, tuple[int, int, int]] = {}  # id -> (off, len, crc)
        self._check_config(config_json)
        self._load()
        self._data = open(self._dpath, "ab")
        self._journal = open(self._jpath, "a")
        self._reader = open(self._dpath, "rb")

    def _check_config(self, config_json: str | None) -> None:
        """Journaled payloads are packed under one CodecConfig; resuming into
        the same directory under a different config would assemble a silently
        corrupt container (e.g. fixed-width payloads parsed as rice).  The
        config fingerprint is written on creation and enforced on resume."""
        if config_json is None:
            return
        if os.path.exists(self._cpath):
            with open(self._cpath) as f:
                stored = f.read()
            if stored != config_json:
                raise ValueError(
                    f"journal at {os.path.dirname(self._cpath)!r} was created "
                    "under a different codec config; use a fresh --journal-dir "
                    f"(journal: {stored!r} vs current: {config_json!r})"
                )
        else:
            with open(self._cpath, "w") as f:
                f.write(config_json)
                f.flush()
                os.fsync(f.fileno())

    def _load(self) -> None:
        if not (os.path.exists(self._jpath) and os.path.exists(self._dpath)):
            return
        size = os.path.getsize(self._dpath)
        with open(self._jpath, "rb") as f:
            data = f.read()
        lines = data.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()  # trailing newline — every line is complete
        elif lines:
            # No trailing newline: the final line was torn mid-write (a
            # truncated CRC can still parse as an int, which would mark the
            # block done with a wrong CRC and wedge resume).  Drop it AND
            # truncate it from the file so the append handle below does not
            # merge the next record into the torn bytes.
            torn = lines.pop()
            with open(self._jpath, "r+b") as tf:
                tf.truncate(len(data) - len(torn))
        for line in lines:
            parts = line.split()
            if len(parts) != 4:
                continue  # torn interior write at crash — ignore
            bid, off, length, crc = (int(p) for p in parts)
            if off + length <= size:
                self._index[bid] = (off, length, crc)

    @property
    def done_blocks(self) -> set[int]:
        return set(self._index)

    @staticmethod
    def peek_done_blocks(directory: str, name: str = "corpus") -> set[int]:
        """Read-only probe of journaled block ids.

        The constructor opens append handles, so probing with it CREATES a
        missing ``.blocks`` (and journal) companion in the directory — wrong
        for shared journal dirs that are only being inspected (CLI
        `assemble` block-count probe).  This parses the journal file
        directly with `_load`'s completeness filters (final line dropped
        when torn, offsets bounded by the data file) and repairs nothing."""
        jpath = os.path.join(directory, f"{name}.journal")
        dpath = os.path.join(directory, f"{name}.blocks")
        if not (os.path.exists(jpath) and os.path.exists(dpath)):
            return set()
        size = os.path.getsize(dpath)
        with open(jpath, "rb") as f:
            lines = f.read().split(b"\n")
        if lines and lines[-1] != b"":
            lines.pop()  # torn final line (no trailing newline)
        done: set[int] = set()
        for line in lines:
            parts = line.split()
            if len(parts) != 4:
                continue
            bid, off, length, _crc = (int(p) for p in parts)
            if off + length <= size:
                done.add(bid)
        return done

    def record(self, block_id: int, payload: bytes) -> None:
        """Append one finished block (idempotent: re-recording is a no-op)."""
        if block_id in self._index:
            return
        off = self._data.tell()
        self._data.write(payload)
        self._data.flush()
        os.fsync(self._data.fileno())
        crc = zlib.crc32(payload)
        self._journal.write(f"{block_id} {off} {len(payload)} {crc}\n")
        self._journal.flush()
        os.fsync(self._journal.fileno())
        self._index[block_id] = (off, len(payload), crc)

    def read(self, block_id: int) -> bytes:
        off, length, crc = self._index[block_id]
        self._reader.seek(off)
        data = self._reader.read(length)
        if zlib.crc32(data) != crc:
            raise IOError(f"journal corruption at block {block_id}")
        return data

    def assemble(self, n_blocks: int) -> list[bytes]:
        """Payloads for blocks [0, n_blocks) in original order."""
        missing = [b for b in range(n_blocks) if b not in self._index]
        if missing:
            raise ValueError(f"blocks not yet encoded: {missing[:8]}...")
        return [self.read(b) for b in range(n_blocks)]

    def close(self) -> None:
        self._data.close()
        self._journal.close()
        self._reader.close()
