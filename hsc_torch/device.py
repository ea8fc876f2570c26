"""Device selection and the spec's float32 numerics.

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
"""

from __future__ import annotations

import contextlib

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
