"""Real-pair IQ ("riq") helpers, the PyTorch port of ``amps_tpu.dsp.iq``:
float32 tensors with a trailing dimension of 2 (I = [..., 0],
Q = [..., 1]), the layout every stage of the port passes IQ in.
Complex arrays appear only at the host boundary (``from_complex``,
``to_complex``)."""

from __future__ import annotations

import numpy as np
import torch


def from_complex(z):
    """Complex (..., n) array or tensor -> riq float32 (..., n, 2)."""
    z = torch.as_tensor(z)
    im = z.imag if z.is_complex() else torch.zeros_like(z)
    return torch.stack([z.real, im], dim=-1).to(torch.float32)


def to_complex(riq):
    """riq (..., n, 2) -> complex (..., n) numpy array, on the host."""
    r = riq.detach().cpu().numpy() if isinstance(riq, torch.Tensor) \
        else np.asarray(riq)
    return r[..., 0] + 1j * r[..., 1]


def expj(phase):
    """riq of exp(j*phase): (...,) float -> (..., 2)."""
    phase = torch.as_tensor(phase).to(torch.float32)
    return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1)


def mul(a, b):
    """Complex multiply in riq: (..., 2) x (..., 2) -> (..., 2)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def mul_conj(a, b):
    """a * conj(b) in riq."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br + ai * bi, ai * br - ar * bi], dim=-1)


def conj(a):
    return torch.stack([a[..., 0], -a[..., 1]], dim=-1)


def angle(a):
    """arg(a): (..., 2) -> (...,) float32 in (-pi, pi]."""
    return torch.atan2(a[..., 1], a[..., 0]).to(torch.float32)


def abs2(a):
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]


def scale(a, s):
    return a * torch.as_tensor(s, dtype=torch.float32,
                               device=a.device)[..., None]
