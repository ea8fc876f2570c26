"""The parallel layer — counterpart of `hsc_tpu.parallel`: a device mesh of
one process (`mesh`), the data-parallel codec (`dp`), the sequence- and
tensor-parallel encode of one long block (`sp`, `tp`) and distributed
k-means (`learn`)."""

from .mesh import Mesh, initialize_distributed, make_mesh
from .dp import (
    DataParallelDecoder,
    DataParallelEncoder,
    HierarchicalDataParallelEncoder,
)
from .sp import sp_encode
from .tp import tp_encode
from .learn import distributed_kmeans, distributed_kmeans_step

__all__ = [
    "Mesh",
    "make_mesh",
    "initialize_distributed",
    "DataParallelDecoder",
    "DataParallelEncoder",
    "HierarchicalDataParallelEncoder",
    "sp_encode",
    "tp_encode",
    "distributed_kmeans_step",
    "distributed_kmeans",
]
