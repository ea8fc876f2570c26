"""Device selection, the spec's float32 numerics and the transfers between
host and card.

Every entry point of the port takes ``device=``.  JAX picks its backend
globally; the port has no global default and never drifts: asking for
``'cuda'`` on a host without a card raises instead of running on the CPU.

The init correlation feeds the quantizer directly, and the k-means and
online-learner products decide which atom a window joins and how the bank
moves, so each must run in full float32.  The JAX package pins precision at
each op (`Precision.HIGHEST`); the port does the same with `spec_numerics`,
entered around each of those ops (`ops.correlate.correlate_bank_torch`,
`learn.kmeans.kmeans_assign_update`, `learn.online._OverlapAdd.backward`).
Inside it cuDNN convolutions and CUDA matmuls run in IEEE float32 (cuDNN
defaults to TF32, about three decimal digits, which would flip codes),
oneDNN convolutions and matmuls on the CPU too (`set_float32_matmul_precision
('medium')` puts oneDNN matmuls on bf16), and cuDNN takes deterministic,
non-autotuned algorithms, so one input gives one init in every call.  On
exit every flag reads what the caller had set: the port changes no global
flag of the process.

Transfers are asynchronous, as JAX's are: an upload (`to_device`) is staged
in pinned memory and queued without a host wait, and a copy-back
(`copy_to_host_async`) is queued into pinned memory and waited for on its
own CUDA event when the host reads it.  Both run on the current stream, so
they are ordered with the kernels, and the only host waits of the encode
and decode paths are those named event waits.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# (object, attribute, the value the spec needs).  The precisions are set and
# restored through the `fp32_precision` attributes only: once a caller has
# used that API, reading the legacy `allow_tf32` flags raises.
_SPEC_FLAGS = (
    (torch.backends.cudnn.conv, "fp32_precision", "ieee"),
    (torch.backends.cuda.matmul, "fp32_precision", "ieee"),
    (torch.backends.mkldnn.conv, "fp32_precision", "ieee"),
    (torch.backends.mkldnn.matmul, "fp32_precision", "ieee"),
    (torch.backends.cudnn, "deterministic", True),
    (torch.backends.cudnn, "benchmark", False),
)


@contextlib.contextmanager
def spec_numerics():
    """Run the body under the spec's float32 numerics (module docstring),
    then give every flag back the value it had on entry."""
    saved = [getattr(obj, name) for obj, name, _ in _SPEC_FLAGS]
    try:
        for obj, name, value in _SPEC_FLAGS:
            setattr(obj, name, value)
        yield
    finally:
        for (obj, name, _), value in zip(_SPEC_FLAGS, saved):
            setattr(obj, name, value)


def resolve_device(device) -> torch.device:
    """``'cpu'`` / ``'cuda'`` / ``'cuda:N'`` / a `torch.device` -> the device.
    Raises if CUDA is asked for and absent, and for any other device type.
    It sets no flag: the numerics are pinned at each op (`spec_numerics`)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev


def canonical_device(device) -> torch.device:
    """`device` resolved (`resolve_device`), with a CUDA device's index made
    explicit: ``'cuda'`` becomes the card current at this call.  What an
    object that holds tensors stores as its device, so that it keeps its
    card when another card is current later (a thread that switched cards,
    a process that joined a group after building it), and so that equal
    devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU): the end of
    a timed region."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(device) -> str:
    """The card's name (`torch.cuda.get_device_name`), or 'cpu': what a
    measurement names as the device it ran on."""
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def to_device(array, device) -> torch.Tensor:
    """A host array (NumPy or a CPU tensor) on `device`, the counterpart of
    `jax.device_put`: on a card it is staged in pinned memory and copied
    with ``non_blocking=True`` on the current stream, so the host does not
    wait for the work queued before it (a pageable ``.to(device)`` runs
    `memcpy_and_sync`, a synchronize of the whole stream).  The staging
    block goes back to PyTorch's caching host allocator, which reuses it
    only once the copy has run.  On the CPU, and for a tensor already on
    another card, it is a plain ``.to(device)``."""
    t = torch.as_tensor(array)
    dev = torch.device(device)
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


class HostCopy:
    """A device-to-host copy in flight (`copy_to_host_async`).  `numpy()`
    and `numpy_into(dst)` wait for this copy's CUDA event only, not for
    the stream; `numpy()` returns the values in pageable memory of their
    own, `numpy_into` copies them into `dst`, a caller's pageable array of
    their shape (a reader slice's rows land straight in the array it
    returns).  So no caller holds a view of the pinned staging, which goes
    back to the caching host allocator (which never returns pinned pages
    to the system).  For a CPU tensor it is the tensor itself and
    `numpy()` its ``.numpy()``.  (`numpy()` keeps its own ``.copy()``:
    allocating then `np.copyto` costs a few microseconds more a copy,
    and the encode paths make hundreds a call.)"""

    def __init__(self, tensor: torch.Tensor):
        if tensor.device.type != "cuda":
            self._host, self._event = tensor, None
            return
        self._host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        self._host.copy_(tensor, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(tensor.device))

    def numpy_into(self, dst: np.ndarray) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        np.copyto(dst, self._host.numpy())
        return dst

    def numpy(self) -> np.ndarray:
        if self._event is None:
            return self._host.numpy()
        self._event.synchronize()
        return self._host.numpy().copy()


def copy_to_host_async(tensor: torch.Tensor) -> HostCopy:
    """Start the copy of `tensor` to the host on its device's current
    stream and return its `HostCopy`, the counterpart of JAX's
    ``copy_to_host_async`` followed later by ``device_get``.  The copy is
    ordered after the kernels queued before it on that stream."""
    return HostCopy(tensor)
