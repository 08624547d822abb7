"""Bit expansion/packing, the PyTorch port of ``amps_tpu.codec.bits``."""

from __future__ import annotations

import numpy as np
import torch


def expandbits_np(val: int, nbits: int) -> np.ndarray:
    """Host MSB-first expansion: int -> (nbits,) uint8."""
    shifts = np.arange(nbits - 1, -1, -1)
    return ((int(val) >> shifts) & 1).astype(np.uint8)


def expandbits(val, nbits: int):
    """MSB-first expansion: (...,) integer -> (..., nbits) uint8.

    expandbits(6, 3) == [1, 1, 0]."""
    val = torch.as_tensor(val).to(torch.int64)
    shifts = torch.arange(nbits - 1, -1, -1, device=val.device)
    return ((val[..., None] >> shifts) & 1).to(torch.uint8)


def packbits(bits, dtype=torch.int32):
    """MSB-first packing: (..., nbits) bits -> (...,) integer."""
    bits = torch.as_tensor(bits)
    nbits = bits.shape[-1]
    weights = torch.pow(2, torch.arange(nbits - 1, -1, -1,
                                        device=bits.device)).to(dtype)
    return torch.sum(bits.to(dtype) * weights, dim=-1, dtype=dtype)
