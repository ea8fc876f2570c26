"""Device mesh — counterpart of `hsc_tpu.parallel.mesh`.

A JAX `Mesh` is single-controller: one process owns all of its devices and
`shard_map` runs the shards with XLA collectives between them.  The port
keeps that model.  A `Mesh` here is named axes over an array of
`torch.device`s; one process runs every shard, each on its own device, and
the collectives are explicit reductions over the shard list, always in
shard order:

  pmax / pmin         elementwise max / min of the shards' values
  psum                a sum in shard order
  all_gather(tiled)   a concatenation in shard order
  ppermute            a copy to the neighbour's device

Devices may repeat: ``make_mesh({"data": 4}, devices=["cuda:0"] * 4)`` is
a 4-shard mesh on one card, ``devices=["cuda:0", "cuda:1"] * 2`` puts
shard i on card i mod 2, and ``make_mesh({"data": 8}, devices=["cpu"] *
8)`` is the counterpart of the JAX tests' 8 virtual CPU devices.  Kernel
launches are asynchronous, so shards on different cards overlap when every
shard's work is enqueued before the first host read.

Every path's output is byte-identical to the same work on one card
(`scripts/torch_multicard.py` on 2 and 4 H100s), and the profiler shows
each card running its shards' kernels.  How fast the mesh ingests is the
benchmark's cell `flat-ingest-mesh4` (`BENCHMARK.json`:
`CorpusEncoder(mesh=)` over 4 cards, `encode_mb_s`), and where each card
idles, the parallel layer's spans (`parallel/dp.py`, the cell's
`idle_mesh_*_pct.mesh`; PERF.md §5): a super-batch's upload, init, peaks,
loop and collect run one after another on the host, and the next
super-batch starts after the pack, so the cards idle most of a call.  SP
and TP, which move each coefficient's winner between cards, run slower on
several cards than on one (`scripts/torch_multicard.py`).

Why not a `torch.distributed` process group for the mesh: NCCL refuses two
ranks on one GPU, so on a one-card host such a mesh could only have size 1,
where every collective is the identity and the shard-boundary code of the
sequence- and tensor-parallel modes (halo, clamped windows, lag masks,
tie-breaks across shards) would never run on the card.  The repeated-device
mesh runs that code through the real kernels at any shard count.
`torch.distributed` keeps the multi-process role it has in the JAX package:
`initialize_distributed` (NCCL between cards, rank p on card p),
`DataParallelEncoder.encode_multihost` and
`runtime.CorpusEncoder.encode_multihost`, whose processes each journal
their share, so the journal's writes bound them.

Axis convention (as in the JAX package): 'data' — blocks; 'model' —
dictionary atoms; 'seq' — the time axis of one long block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import canonical_device


class Mesh:
    """Named axes over an array of `torch.device`s (`make_mesh` builds
    one)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices of the shards along `axis`, in shard order: where the
        mesh has other axes, the shards of `axis` at index 0 of each of them
        (a computation sharded over `axis` alone is replicated over the
        others, and one replica is enough in one process)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (axes {self.axis_names})")
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def device_type(self) -> str:
        """The one device type of the mesh ('cpu' or 'cuda')."""
        return self.devices.flat[0].type


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a Mesh; default = every visible GPU on the 'data' axis.

    Axis order follows dict order.  `devices` may repeat a device (several
    shards on one card or on the CPU); every device is resolved through
    `device.canonical_device`, so a CUDA device on a host without a card
    raises and ``'cuda'`` is the current card.  All devices must be of one
    type."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device visible (pass devices=)")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = [canonical_device(d) for d in devices]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"mesh devices must be of one type, got {sorted({d.type for d in devs})}")
    if axes is None:
        axes = {"data": len(devs)}
    shape = tuple(axes.values())
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"mesh {axes} needs {np.prod(shape)} devices, have {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axes.keys()))


def psum(dev: torch.device, parts: list[torch.Tensor]) -> torch.Tensor:
    """The shards' values summed in shard order on `dev` (the `psum` of a
    shard list): ``((p0 + p1) + p2) + ...``."""
    acc = parts[0].to(dev)
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


def check_mesh_device(mesh: Mesh, device, what: str) -> None:
    """Raise `ValueError` unless `device` (the caller's ``device=``) is of
    the mesh's device type: with a mesh the shards run on the mesh's
    devices, and a CPU caller with a CUDA mesh (or the reverse) is a
    mistake."""
    dev = torch.device(device)
    if dev.type != mesh.device_type():
        raise ValueError(
            f"{what}: device {str(device)!r} is not of the mesh's device type "
            f"{mesh.device_type()!r}"
        )


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-process bring-up: wraps `torch.distributed.init_process_group`
    (``tcp://`` + `coordinator_address`, ``host:port``), with gloo on a
    host without a card and NCCL on a card (one rank per GPU: rank p takes
    ``cuda:p % device_count``).  A no-op when `num_processes` is None or
    <= 1, so the same program runs in one process or many."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address and process_id")
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id))
