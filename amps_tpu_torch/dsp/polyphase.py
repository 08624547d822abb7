"""Constant tables of the ratio-2 oversampled polyphase bank: the
prototype lowpass, the DFT matrices, the permutation-absorbed analysis
matrices, the derotation and the hop sign.  They are built in numpy
exactly as ``amps_tpu.dsp.channelizer`` builds them.

This module sits below both ``dsp.channelizer`` (the streaming analysis
and the plain synthesis) and ``kernels.analysis`` (the analysis kernel
and its plain version), so neither imports the other's internals.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from amps_tpu_torch.dsp.windows import _window


@functools.cache
def prototype_taps(M: int, T: int) -> np.ndarray:
    """Prototype lowpass: cutoff Δf/2, length exactly M*T, unity DC gain
    (windowed sinc, Blackman-Harris window)."""
    n = M * T
    mid = (n - 1) / 2
    t = np.arange(n) - mid
    fc = 0.5 / M
    x = 2 * np.pi * fc * t
    safe = np.where(t == 0, 1.0, x)
    sinc = np.where(t == 0, 2 * np.pi * fc, np.sin(safe) / safe * 2 * np.pi * fc) \
        / (2 * np.pi * fc)
    w = _window("blackman_harris", n)
    taps = sinc * w
    taps = taps / taps.sum()
    return taps.astype(np.float32)


@functools.cache
def _dft_mats(M: int) -> Tuple[np.ndarray, np.ndarray]:
    """E+[k,m] = exp(+j 2π k m / M) as (cos, sin) float32 matrices
    (symmetric, shared by analysis and synthesis)."""
    k = np.arange(M)
    km = np.outer(k, k) % M
    ang = 2.0 * np.pi * km / M
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.cache
def _dft_split_mats(M: int, M2: int):
    """Two-stage Cooley-Tukey factors of E+ for M = M1*M2 (r = m1 + M1*m2,
    k = k2 + M2*k1): E+[k,r] = E1+[k1,m1] * tw[k2,m1] * E2+[k2,m2].
    Returns (C2, S2, C1, S1, twc, tws) float32."""
    assert M % M2 == 0
    M1 = M // M2
    C2, S2 = _dft_mats(M2)
    C1, S1 = _dft_mats(M1)
    ang = 2.0 * np.pi * np.outer(np.arange(M2), np.arange(M1)) / M
    return (C2, S2, C1, S1,
            np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@functools.cache
def _dft_mats_folded(M: int):
    """Transform matrices with the polyphase permutation absorbed:
    y[k,n] = sum_q Eo[k,q] fo[n,q] + Ee[k,q] fe[n,q] with
    Eo[k,q] = E+[k, P-1-q], Ee[k,q] = E+[k, M-1-q].
    Returns (Co, So, Ce, Se), each (M, P) float32."""
    P = M // 2
    k = np.arange(M)[:, None]
    q = np.arange(P)[None, :]
    ang_o = 2.0 * np.pi * ((k * (P - 1 - q)) % M) / M
    ang_e = 2.0 * np.pi * ((k * (M - 1 - q)) % M) / M
    return (np.cos(ang_o).astype(np.float32),
            np.sin(ang_o).astype(np.float32),
            np.cos(ang_e).astype(np.float32),
            np.sin(ang_e).astype(np.float32))


@functools.cache
def _derotation(M: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of the constant derotation e^{+j 2π k / M}, float32:
    the hop-n window is evaluated at absolute time nP+L-1, and
    e^{-j2πk(L-1)/M} = e^{+j2πk/M} for L ≡ 0 (mod M)."""
    ang = 2.0 * np.pi * np.arange(M) / M
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.cache
def _analysis_consts(M: int, T: int, device):
    """Device copies of the bank path's tables: fold coefficients
    coef[t, q_w] = h[L-1-(tM+q_w)] (T, M), the folded transform matrices
    (Co, So, Ce, Se) and the derotation (rc, rs) as (M, 1) columns."""
    coef = np.ascontiguousarray(prototype_taps(M, T)[::-1]).reshape(T, M)
    mats = _dft_mats_folded(M)
    rc, rs = _derotation(M)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (coef, *mats, rc[:, None], rs[:, None]))


def _hop_sign(M: int, Nh: int, hop0_parity: int, device) -> torch.Tensor:
    """(M, Nh) matrix of (-1)^{k n} with n counted from ``hop0_parity``."""
    k_odd = torch.arange(M, device=device) % 2
    n_odd = (torch.arange(Nh, device=device) + int(hop0_parity)) % 2
    return (1.0 - 2.0 * (k_odd[:, None] * n_odd[None, :])).to(torch.float32)
