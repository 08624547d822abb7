"""FIR filtering as convolutions, the PyTorch port of ``amps_tpu.dsp.fir``:
the streaming FIR (real and riq), GR's freq_xlating_fir_filter_ccc and
the polyphase interpolator (gr pfb_interpolator_ccf: zero-stuff by
``interp`` and filter, as one transposed convolution).  IQ signals are
riq float32 (..., n, 2); the mixer's complex product is written out.

The streaming forms take the history tail of the previous block, so
blocks chain exactly.  Alignment is causal, as in GR streams: y[n] =
sum_k h[k] x[n-k], with x[<0] from the history (zeros at a cold start).
cuDNN's TF32 is off (``amps_tpu_torch.device``), so the filters run in
float32 on every device.  Every function runs on its input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from amps_tpu_torch.device import as_tensor


def polyphase_interpolate(x, taps, interp: int, history=None):
    """Real (..., n) signal -> (y (..., n*interp), new_history (..., hlen)),
    hlen = ceil((len(taps) - 1) / interp) input samples, on the input's
    device."""
    x = as_tensor(x)
    k = len(taps)
    hlen = -(-(k - 1) // interp)
    if history is None:
        pad = torch.zeros(x.shape[:-1] + (hlen,), device=x.device)
    else:
        pad = as_tensor(history, device=x.device)
    ext = torch.cat([pad, x], dim=-1)
    n_ext = ext.shape[-1]
    h = torch.as_tensor(np.asarray(taps, np.float32), device=x.device)
    # full convolution of the zero-stuffed input: full[j] =
    # sum_i ext[i] h[j - i*interp]; output sample 0 is the first one whose
    # taps reach no further back than the history
    full = torch.nn.functional.conv_transpose1d(
        ext.reshape(-1, 1, n_ext), h.view(1, 1, k), stride=interp)
    y = full[..., hlen * interp: hlen * interp + x.shape[-1] * interp]
    new_hist = ext[..., n_ext - hlen:]
    return y.reshape(x.shape[:-1] + (-1,)), new_hist


def polyphase_interpolate_iq(x, taps, interp: int, history=None):
    """Polyphase interpolation of riq (..., n, 2) signals; history
    (..., hlen, 2)."""
    x = as_tensor(x)
    ht = None if history is None else \
        as_tensor(history, device=x.device).transpose(-1, -2)
    y, h = polyphase_interpolate(x.transpose(-1, -2), taps, interp, ht)
    return y.transpose(-1, -2), h.transpose(-1, -2)


def fir_filter(x, taps, decim: int = 1, history=None):
    """Streaming real FIR: x (..., n), n a multiple of ``decim``; history
    (..., k-1) the previous tail, or None for zeros.  Returns
    (y (..., n // decim), new_history (..., k-1))."""
    x = as_tensor(x)
    k = len(taps)
    if history is None:
        pad = torch.zeros(x.shape[:-1] + (k - 1,), device=x.device)
    else:
        pad = as_tensor(history, device=x.device)
    ext = torch.cat([pad, x], dim=-1)
    n_ext = ext.shape[-1]
    # conv1d correlates, so the taps are flipped
    h = torch.as_tensor(np.asarray(taps, np.float32)[::-1].copy(),
                        device=x.device)
    y = torch.nn.functional.conv1d(ext.reshape(-1, 1, n_ext),
                                   h.view(1, 1, k), stride=decim)
    return (y.reshape(x.shape[:-1] + (-1,)),
            ext[..., n_ext - (k - 1):])


def fir_filter_iq(x, taps, decim: int = 1, history=None):
    """Streaming FIR on riq (..., n, 2) signals with real taps; history
    (..., k-1, 2)."""
    x = as_tensor(x)
    ht = None if history is None else \
        as_tensor(history, device=x.device).transpose(-1, -2)
    y, h = fir_filter(x.transpose(-1, -2), taps, decim, ht)
    return y.transpose(-1, -2), h.transpose(-1, -2)


def freq_xlating_fir(x, taps, center_freq: float, fs: float, decim: int,
                     history=None, phase_idx0: int = 0):
    """GR freq_xlating_fir_filter_ccc on riq (..., n, 2) input: mix down
    by ``center_freq`` (multiply by exp(-j 2π f n / fs)), low-pass with
    real taps, decimate.  ``phase_idx0``: the absolute sample index of
    x[0], which keeps the mixer's phase continuous across blocks.
    Returns (y, new_history (..., k-1, 2) after the mixer,
    next phase index)."""
    x = as_tensor(x)
    n = x.shape[-2]
    idx = (torch.arange(n, device=x.device) + int(phase_idx0)) \
        .to(torch.float32)
    ph = idx * float(np.float32(-2.0 * np.pi * center_freq / fs))
    lr, li = torch.cos(ph), torch.sin(ph)
    xr, xi = x[..., 0], x[..., 1]
    mixed = torch.stack([xr * lr - xi * li, xr * li + xi * lr], dim=-1)
    y, hist = fir_filter_iq(mixed, taps, decim=decim, history=history)
    return y, hist, int(phase_idx0) + n
