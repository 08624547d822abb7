"""Device and precision policy of the port.

Every parity path runs in full float32: TF32 keeps about three decimal
digits, and a contraction whose operands carry integers above 256 must
be exact (the JAX package once lost every on-chip BCH decode to a
reduced-precision matmul, CLAUDE.md "TPU default matmul precision").
Both PyTorch switches are turned off when this module is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``device`` as a ``torch.device``,
    where None and "cuda" mean the current CUDA device, with its index,
    so that it compares equal to a tensor's device.  The CPU is used only
    when named.  A CUDA device asked for on a machine without one raises:
    the port never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_tensor(x, dtype=torch.float32, device=None) -> torch.Tensor:
    """Tensor of ``dtype`` on ``device`` (default: the input's own device
    for tensors, the CPU for numpy/array-likes)."""
    if device is None:
        dev = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    else:
        dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=dev)
