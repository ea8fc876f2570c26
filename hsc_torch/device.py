"""Device selection: every entry point of the port takes ``device=``.

JAX picks its backend globally; the port has no global default and never
drifts: asking for ``'cuda'`` on a host without a card raises instead of
running on the CPU.

`resolve_device` also sets the float32 numerics the codec spec needs on the
card.  The init correlation feeds the quantizer directly, so it must run in
full float32: cuDNN convolutions default to TF32 (about three decimal
digits), which would flip codes.  cuDNN is also pinned to deterministic,
non-autotuned algorithms so one input gives one init in every call — the
container bytes of a repeated encode depend on it.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``'cpu'`` / ``'cuda'`` / ``'cuda:N'`` / a `torch.device` -> the device,
    after setting the spec's numerics.  Raises if CUDA is asked for and
    absent, and for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return dev

