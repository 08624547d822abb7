"""FM/FSK primitives on the real-pair (riq) IQ representation, the
PyTorch port of ``amps_tpu.dsp.fm``.

``fast_atan2`` keeps the JAX package's constants and operation order
exactly (the CUDA kernels in ``csrc/`` repeat them), so the
discriminator agrees to the last bit wherever its inputs do.
``fm_modulate`` accumulates the phase as a float32 cumsum, whose
summation order differs between backends: over a long block the phase
agrees with the JAX package's to a tolerance, not to the bit.
"""

from __future__ import annotations

import numpy as np
import torch

from amps_tpu_torch.device import as_tensor

_ATAN_A = np.float32(0.999866)
_ATAN_B = np.float32(-0.3302995)
_ATAN_C = np.float32(0.180141)
_ATAN_D = np.float32(-0.085133)
_HALF_PI = np.float32(np.pi / 2)
_PI = np.float32(np.pi)


def fast_atan2(y, x):
    """Polynomial atan2, |error| < 1e-4 rad: octant reduction + odd
    minimax polynomial in z on [0, 1] (Estrin), one divide.
    fast_atan2(0, 0) == 0."""
    y = as_tensor(y)
    x = as_tensor(x, device=y.device)
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / torch.clamp(hi, min=1e-30)
    z2 = z * z
    base = z * (float(_ATAN_A) + z2 * (float(_ATAN_B) + z2 * (
        float(_ATAN_C) + z2 * float(_ATAN_D))))
    base = torch.where(ay > ax, float(_HALF_PI) - base, base)
    base = torch.where(x < 0, float(_PI) - base, base)
    return torch.where(y < 0, -base, base)


def expj(phase):
    """riq of exp(j*phase): (...,) float -> (..., 2) float32."""
    phase = as_tensor(phase)
    return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1)


def fm_modulate_symbols(symbols, sensitivity: float, phase_accum0=0):
    """FSK-modulate an integer ±1 symbol stream (..., n):
    phase[n] = sens * cumsum(symbols), accumulated in int32 so long
    streams do not drift; ``phase_accum0`` an int, (...,) ints (an earlier
    call's accum_end) or a tensor that broadcasts against (..., n).
    Returns (iq riq (..., n, 2), accum_end (...,))."""
    s = torch.as_tensor(symbols)
    a0 = torch.as_tensor(phase_accum0, dtype=torch.int32, device=s.device)
    if a0.ndim and a0.ndim == s.ndim - 1:
        a0 = a0[..., None]          # one accumulator a stream, as returned
    accum = torch.cumsum(s.to(torch.int32), dim=-1, dtype=torch.int32) + a0
    phase = accum.to(torch.float32) * float(np.float32(sensitivity))
    return expj(phase), accum[..., -1]


def fm_modulate(x, sensitivity: float, phase0=0.0):
    """FM-modulate a float signal (..., n): phase = sens * cumsum(x) +
    phase0.  Returns (iq riq (..., n, 2), final unwrapped phase (...,));
    callers streaming long signals wrap phase0 mod 2π between blocks."""
    x = as_tensor(x)
    phase = torch.cumsum(x, dim=-1) * float(np.float32(sensitivity)) \
        + float(phase0)
    return expj(phase), phase[..., -1]


def fsk_manchester_baseband(bits, sps: int, sensitivity: float,
                            phase_accum0=0):
    """FSK baseband of a Manchester-coded bit stream as a two-template
    map.  Each bit's 2*sps ±1 samples sum to zero, so the integer phase
    accumulator returns to its start after every bit and a bit's
    waveform is one of two fixed (2*sps, 2) templates, evaluated with
    the ops of ``fm_modulate_symbols``: bit-exact against
    fm_modulate_symbols(manchester_encode_symbols(bits, sps)).

    bits: (..., n) 0/1; ``phase_accum0`` an int or (...,) ints.  Returns
    (iq (..., n*2*sps, 2) float32, accum_end (...,) int32, equal to
    phase_accum0)."""
    bits = torch.as_tensor(bits)
    dev = bits.device
    half = np.concatenate([np.arange(1, sps + 1), np.arange(sps - 1, -1, -1)])
    ramp = torch.as_tensor(np.stack([half, -half]).astype(np.int32),
                           device=dev)                      # (2, 2*sps)
    a0 = torch.as_tensor(phase_accum0, dtype=torch.int32, device=dev)
    accum = ramp + a0[..., None, None]                      # (..., 2, 2*sps)
    table = expj(accum.to(torch.float32) * float(np.float32(sensitivity)))
    sel = (bits != 0)[..., None, None]
    out = torch.where(sel, table[..., None, 1, :, :], table[..., None, 0, :, :])
    accum_end = a0.expand(bits.shape[:-1])
    return out.reshape(bits.shape[:-1] + (-1, 2)), accum_end


def quadrature_demod_planar(xr, xi, gain: float = 1.0, prev=None,
                            return_power=False):
    """quadrature_demod on planar I/Q planes: demod[n] =
    gain * arg(x[n] conj(x[n-1])), with x[-1] = ``prev`` (pr, pi) or 0.

    Returns (demod (..., n), (last_r, last_i)); with ``return_power``
    also the (...,) band power sqrt(mean(re²+im²)) of the same conjugate
    product, or with ``return_power="series"`` the per-sample
    re²+im² series aligned with demod."""
    xr = as_tensor(xr)
    xi = as_tensor(xi, device=xr.device)
    if prev is None:
        pr = torch.zeros_like(xr[..., :1])
        pi = torch.zeros_like(xi[..., :1])
    else:
        pr = as_tensor(prev[0], device=xr.device)[..., None]
        pi = as_tensor(prev[1], device=xr.device)[..., None]
    sr = torch.cat([pr, xr[..., :-1]], dim=-1)
    si = torch.cat([pi, xi[..., :-1]], dim=-1)
    re = xr * sr + xi * si
    im = xi * sr - xr * si
    demod = fast_atan2(im, re) * float(np.float32(gain))
    last = (xr[..., -1], xi[..., -1])
    if return_power == "series":
        return demod, last, re * re + im * im
    if return_power:
        return demod, last, torch.sqrt(torch.mean(re * re + im * im, dim=-1))
    return demod, last


def quadrature_demod(x, gain: float = 1.0, prev=None):
    """GR analog_quadrature_demod_cf on riq (..., n, 2):
    y[n] = gain * arg(x[n] conj(x[n-1])), with x[-1] = ``prev`` ((..., 2))
    or 0 (the first output is then 0).  Returns (demod (..., n) float32,
    last sample (..., 2))."""
    x = as_tensor(x)
    if prev is None:
        prev_s = torch.zeros_like(x[..., :1, :])
    else:
        prev_s = as_tensor(prev, device=x.device)[..., None, :]
    s = torch.cat([prev_s, x[..., :-1, :]], dim=-2)
    xr, xi, sr, si = x[..., 0], x[..., 1], s[..., 0], s[..., 1]
    re = xr * sr + xi * si
    im = xi * sr - xr * si
    return fast_atan2(im, re) * float(np.float32(gain)), x[..., -1, :]
