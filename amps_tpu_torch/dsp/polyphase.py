"""Constant tables of the ratio-2 oversampled polyphase bank: the
prototype lowpass, the DFT matrices, the permutation-absorbed analysis
matrices, the derotation and the hop sign.  They are built in numpy
exactly as ``amps_tpu.dsp.channelizer`` builds them.

This module sits below both ``dsp.channelizer`` (the streaming analysis
and the plain synthesis) and ``kernels.analysis`` (the analysis kernel
and its plain version), so neither imports the other's internals.

The dense tables take 8·M² bytes (8.6 GB at M = 32768, 34 GB at 65536),
so past ``DENSE_MAX_WIDTH`` the plain transforms are float64 FFTs of the
same sums instead (``fft_rows``), cast to f32 at the output.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from amps_tpu_torch.dsp.windows import _window


# the widest M whose plain transforms use the dense tables; past it they
# are float64 FFTs (``fft_rows``)
DENSE_MAX_WIDTH = 32768


def fft_rows(re: torch.Tensor, im: torch.Tensor, inverse: bool = False):
    """The M-point DFT of each row (the last axis) of re + j·im, in
    float64 on their device, cast to f32 at the output: forward,
    sum_m z[m] e^{-j2πkm/M}, or inverse, sum_k z[k] e^{+j2πkm/M}
    (unscaled).  Rows go in chunks of at most 2^26 values (1 GB of
    complex128).  Returns (re, im) float32 of the input's shape."""
    M, shape = re.shape[-1], re.shape
    re2, im2 = re.reshape(-1, M), im.reshape(-1, M)
    out_r = torch.empty(re2.shape, dtype=torch.float32, device=re.device)
    out_i = torch.empty_like(out_r)
    step = max(1, (1 << 26) // M)
    for a in range(0, re2.shape[0], step):
        z = torch.complex(re2[a:a + step].double(), im2[a:a + step].double())
        z = torch.fft.ifft(z, dim=-1, norm="forward") if inverse else \
            torch.fft.fft(z, dim=-1)
        out_r[a:a + step] = z.real
        out_i[a:a + step] = z.imag
        del z
    return out_r.reshape(shape), out_i.reshape(shape)


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


def _unit_circle(M: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of 2π e / M for e < M, float32: each angle in float64
    as the matrices' entries take it, so that a matrix gathered from
    these tables by e = (k·m) mod M holds the same numbers as one
    computed entry by entry."""
    ang = 2.0 * np.pi * np.arange(M) / M
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _gather_circle(M: int, device, e_of):
    """(cos, sin) tables of ``_unit_circle(M)`` gathered on ``device`` by
    the exponents ``e_of(k)`` of the integer row k = 0 .. M-1 (4-byte
    integers where the products k·m < M² fit)."""
    k = torch.arange(M, device=device,
                     dtype=torch.int32 if M * M < 2 ** 31 else torch.int64)
    c, s = (torch.as_tensor(a, device=device) for a in _unit_circle(M))
    return [t[e] for e in e_of(k) for t in (c, s)]


def _dft_mats_on(M: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """E+[k,m] = exp(+j 2π k m / M) as (cos, sin) float32 matrices on
    ``device`` (symmetric, shared by analysis and synthesis), gathered
    afresh at each call: the dense synthesis holds them for one block,
    as it held its host copies."""
    return tuple(_gather_circle(M, device,
                                lambda k: [k[:, None] * k[None, :] % M]))


@functools.cache
def _dft_mats(M: int) -> Tuple[np.ndarray, np.ndarray]:
    """``_dft_mats_on`` on the CPU, as numpy arrays."""
    return tuple(t.numpy() for t in _dft_mats_on(M, torch.device("cpu")))


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


def _folded_exponents(k, M: int):
    """The exponents of the folded matrices: e_o[k, q] = k·(P-1-q) mod M
    and e_e[k, q] = k·(M-1-q) mod M = e_o[k, q] + k·P (mod M)."""
    P = M // 2
    e_o = k[:, None] * (P - 1 - k[:P])[None, :] % M
    return e_o, (e_o + (k % 2 * P)[:, None]) % M


def _dft_mats_folded_on(M: int, device):
    """Transform matrices with the polyphase permutation absorbed, on
    ``device`` (``_analysis_consts`` holds them):
    y[k,n] = sum_q Eo[k,q] fo[n,q] + Ee[k,q] fe[n,q] with
    Eo[k,q] = E+[k, P-1-q], Ee[k,q] = E+[k, M-1-q].
    Returns (Co, So, Ce, Se), each (M, P) float32."""
    return tuple(_gather_circle(M, device,
                                lambda k: _folded_exponents(k, M)))


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
    (Co, So, Ce, Se), gathered on the device itself, and the derotation
    (rc, rs) as (M, 1) columns."""
    coef = np.ascontiguousarray(prototype_taps(M, T)[::-1]).reshape(T, M)
    rc, rs = _derotation(M)
    return (torch.as_tensor(coef, device=device),
            *_dft_mats_folded_on(M, device),
            *(torch.as_tensor(a[:, None], device=device) for a in (rc, rs)))


def _hop_sign(M: int, Nh: int, hop0_parity: int, device) -> torch.Tensor:
    """(M, Nh) matrix of (-1)^{k n} with n counted from ``hop0_parity``."""
    k_odd = torch.arange(M, device=device) % 2
    n_odd = (torch.arange(Nh, device=device) + int(hop0_parity)) % 2
    return (1.0 - 2.0 * (k_odd[:, None] * n_odd[None, :])).to(torch.float32)
