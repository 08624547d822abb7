"""Polyphase interpolation, the PyTorch port of
``amps_tpu.dsp.fir.polyphase_interpolate`` (gr pfb_interpolator_ccf):
zero-stuff by ``interp`` and filter, as one transposed convolution.

Alignment is causal, as in GR streams: y[n] = sum_k h[k] xs[n-k] over
the zero-stuffed input xs, with the input's history (zeros at a cold
start) before it.  cuDNN's TF32 is off (``amps_tpu_torch.device``), so
the filter runs in float32 on every device.
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
