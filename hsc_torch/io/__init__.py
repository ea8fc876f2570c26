"""Container bit-packing — the port's own copy of `hsc_tpu/io/__init__.py`
(the exports of `io.bitstream`)."""

from .bitstream import (
    append_index,
    iter_blocks,
    pack_stream,
    peek_corpus_header,
    pack_corpus,
    read_index,
    scan_block_offsets,
    stream_num_bytes,
    unpack_block,
    unpack_corpus,
    unpack_stream,
)

__all__ = [
    "append_index",
    "iter_blocks",
    "pack_stream",
    "unpack_stream",
    "pack_corpus",
    "peek_corpus_header",
    "read_index",
    "scan_block_offsets",
    "stream_num_bytes",
    "unpack_block",
    "unpack_corpus",
]
