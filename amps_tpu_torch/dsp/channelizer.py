"""Ratio-2 oversampled polyphase channelizers (analysis + synthesis),
the PyTorch port of ``amps_tpu.dsp.channelizer``.

Math (weighted overlap-add form; h = prototype lowpass, L = M*T taps):
  analysis   y_k[n] = (-1)^{k n} * sum_r E+[k,r] v_n[r],
             v_n[r] = fold mod M of h[m] x[nP-m] over the hop-n window
  synthesis  x[s]   = sum_n g[s-nP] * u_n[(s-nP) mod M],
             u_n[m] = sum_k (-1)^{k n} Y_k[n] E+[k,m]
Channel k sits at center frequency +k*Δf (k mod M; k>M/2 => negative).

Only the production analysis fold, ``fold="bank"`` (the two parity
banks fed straight into permutation-absorbed transform matrices), is
ported; the JAX package's other folds match it up to f32 summation
order and raise ``NotImplementedError`` here.  The constant tables are
built in numpy exactly as the JAX package builds them.

This module is the PLAIN analysis and synthesis: on the receive path
the analysis runs fused with the discriminator in
``amps_tpu_torch.kernels.rx_phases`` and ``kernels.rx_front``, and the
transmitter's synthesis runs in ``kernels.synth``, whose plain version
is ``_synthesize_block``.  ``synthesize`` stays plain: it builds test
traffic independently of the kernels.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from amps_tpu_torch.device import as_tensor
from amps_tpu_torch.dsp.windows import _window


@dataclasses.dataclass(frozen=True)
class ChannelizerSpec:
    num_channels: int          # M (even)
    taps_per_phase: int = 8    # T
    spacing_hz: float = 30_000.0

    @property
    def hop(self) -> int:
        return self.num_channels // 2

    @property
    def ntaps(self) -> int:
        return self.num_channels * self.taps_per_phase


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


def default_split(M: int) -> int:
    """Auto split factor M2 of the synthesis transform: two-stage with a
    128-deep first stage for M >= 512, dense (0) otherwise."""
    return 128 if (M % 128 == 0 and M >= 512) else 0


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


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


def _transform_hopmajor(yr, yi, M: int, split: int):
    """u[n, m] = sum_k y[n, k] E+[k, m] on hop-major (..., Nh, M) planes.
    split=0: dense (M, M) matmul pair; split=M2: two-stage Cooley-Tukey."""
    if not split:
        C, S = (_const(a, yr) for a in _dft_mats(M))
        return yr @ C - yi @ S, yr @ S + yi @ C
    M2 = split
    M1 = M // M2
    C2, S2, C1, S1, twc, tws = (_const(a, yr) for a in _dft_split_mats(M, M2))
    shp = yr.shape[:-1]
    y2r = yr.reshape(shp + (M1, M2))                 # [k1, k2]
    y2i = yi.reshape(shp + (M1, M2))

    def dotk(A, y):   # einsum("ka,...kc->...ca", A, y)
        return y.transpose(-1, -2) @ A

    Ar = dotk(C1, y2r) - dotk(S1, y2i)               # (..., k2, m1)
    Ai = dotk(S1, y2r) + dotk(C1, y2i)
    Br = twc * Ar - tws * Ai
    Bi = tws * Ar + twc * Ai

    def dotm(A, B):   # einsum("km,...kq->...mq", A, B)
        return A.transpose(0, 1) @ B

    ur = dotm(C2, Br) - dotm(S2, Bi)                 # (..., m2, m1)
    ui = dotm(S2, Br) + dotm(C2, Bi)
    return ur.reshape(shp + (M,)), ui.reshape(shp + (M,))


@dataclasses.dataclass(frozen=True)
class AnalyzerState:
    history: torch.Tensor   # (..., L-P, 2) last input samples, or (..., 2, L-P)
    hop_idx: int = 0


@dataclasses.dataclass(frozen=True)
class SynthesizerState:
    carry: torch.Tensor     # (..., L-P, 2) overlap-add tail
    hop_idx: int = 0


def analyzer_init(spec: ChannelizerSpec, batch: Tuple[int, ...] = (),
                  planar_in: bool = False, device=None) -> AnalyzerState:
    L, P = spec.ntaps, spec.hop
    shape = batch + ((2, L - P) if planar_in else (L - P, 2))
    return AnalyzerState(torch.zeros(shape, dtype=torch.float32,
                                     device=device), 0)


def synthesizer_init(spec: ChannelizerSpec, batch: Tuple[int, ...] = (),
                     device=None) -> SynthesizerState:
    L, P = spec.ntaps, spec.hop
    return SynthesizerState(torch.zeros(batch + (L - P, 2),
                                        dtype=torch.float32, device=device), 0)


def _fold_banks(x_ext: torch.Tensor, M: int, T: int, planar_in: bool):
    """Polyphase fold of the bank path: (..., 2, Nh, P) even and odd
    parity banks as T shifted multiply-adds over P-sample blocks
    (sample nP + tM + q_w lives in block n + 2t (+1 if q_w >= P))."""
    P = M // 2
    n_ext = x_ext.shape[-1 if planar_in else -2]
    Nh = (n_ext - (M * T - P)) // P
    nblk = n_ext // P
    batch = x_ext.shape[:-2]
    if planar_in:
        xpl = x_ext[..., : nblk * P]
    else:
        xpl = x_ext[..., : nblk * P, :].transpose(-1, -2)
    bl = xpl.reshape(batch + (2, nblk, P)).to(torch.float32)
    coef = _analysis_consts(M, T, bl.device)[0]
    ke, ko = coef[:, :P], coef[:, P:]
    acc_e = ke[0] * bl[..., 0:Nh, :]
    acc_o = ko[0] * bl[..., 1:1 + Nh, :]
    for t in range(1, T):
        acc_e = acc_e + ke[t] * bl[..., 2 * t: 2 * t + Nh, :]
        acc_o = acc_o + ko[t] * bl[..., 2 * t + 1: 2 * t + 1 + Nh, :]
    return acc_e, acc_o, Nh


def _analyze_block_chmajor(x_ext, M: int, T: int, hop0_parity: int = 0,
                           fold: str = "bank", planar: bool = False,
                           planar_in: bool = False):
    """x_ext: (..., L-P+N, 2) riq with history prepended (N = Nh*P), or
    (..., 2, L-P+N) planar planes when ``planar_in``.  Returns Y
    (..., M, Nh, 2) channel-major, or (..., 2, M, Nh) when ``planar``.
    The transform runs in float32."""
    if fold != "bank":
        raise NotImplementedError(
            f"fold={fold!r}: only the production fold 'bank' is ported")
    acc_e, acc_o, Nh = _fold_banks(x_ext, M, T, planar_in)
    er, ei = acc_e[..., 0, :, :], acc_e[..., 1, :, :]
    or_, oi = acc_o[..., 0, :, :], acc_o[..., 1, :, :]
    _, Co, So, Ce, Se, rc, rs = _analysis_consts(M, T, acc_e.device)

    def dot(A, v):   # einsum("kq,...nq->...kn")
        return A @ v.transpose(-1, -2)

    yr = dot(Co, or_) - dot(So, oi) + dot(Ce, er) - dot(Se, ei)
    yi = dot(So, or_) + dot(Co, oi) + dot(Se, er) + dot(Ce, ei)
    yr2 = yr * rc - yi * rs
    yi2 = yr * rs + yi * rc
    sgn = _hop_sign(M, Nh, hop0_parity, acc_e.device)
    if planar:
        return torch.stack([yr2 * sgn, yi2 * sgn], dim=-3)
    return torch.stack([yr2 * sgn, yi2 * sgn], dim=-1)


def _synthesize_block(Y, M: int, T: int, hop0_parity: int, carry,
                      split: int = 0):
    """Y: (..., Nh, M, 2) channel basebands -> (..., Nh*P, 2) wideband +
    new overlap-add carry (..., L-P, 2).  Overlap-add in P-sample block
    coordinates: output block b sample p receives
    sum_j g[jP+p] * u_{b-j}[(j&1)P + p]."""
    L = M * T
    P = M // 2
    Nh = Y.shape[-3]
    sgn = _hop_sign(M, Nh, hop0_parity, Y.device).transpose(0, 1)  # (Nh, M)
    yr = Y[..., 0] * sgn
    yi = Y[..., 1] * sgn
    ur, ui = _transform_hopmajor(yr, yi, M, split)               # (..., Nh, M)
    gm = _const(prototype_taps(M, T), Y).reshape(T, M) * np.float32(P)
    LP = L // P
    batch = Y.shape[:-3]
    nb_out = Nh + LP - 1
    total = nb_out * P

    def overlap_add(uplane):
        upad = torch.nn.functional.pad(uplane, (0, 0, LP - 1, LP - 1))
        out = None
        for j in range(LP):
            gj = gm[j // 2, (j & 1) * P: (j & 1) * P + P]
            half = upad[..., LP - 1 - j: LP - 1 - j + nb_out,
                        (j & 1) * P: (j & 1) * P + P]
            term = gj * half
            out = term if out is None else out + term
        return out.reshape(batch + (total,))

    out = torch.stack([overlap_add(ur), overlap_add(ui)], dim=-1)
    out = torch.cat([out[..., : L - P, :] + carry, out[..., L - P:, :]],
                    dim=-2)
    return out[..., : Nh * P, :], out[..., Nh * P:, :]


def analyze(x, spec: ChannelizerSpec, state: AnalyzerState,
            fold: str = "bank", planar: bool = False,
            planar_in: bool = False):
    """Streaming channel-major analysis: x (..., N, 2), N a multiple of
    spec.hop — or planar planes (..., 2, N) when ``planar_in`` (state from
    analyzer_init(..., planar_in=True)).  Returns (Y, new state); Y is
    (..., M, N/P, 2), or (..., 2, M, N/P) when ``planar``.  A block with
    an odd hop count flips the parity of the next one."""
    P = spec.hop
    x = as_tensor(x, device=state.history.device)
    n = x.shape[-1] if planar_in else x.shape[-2]
    if n % P:
        raise ValueError(f"block length {n} not a multiple of hop {P}")
    cat_dim = -1 if planar_in else -2
    x_ext = torch.cat([state.history, x], dim=cat_dim)
    Y = _analyze_block_chmajor(x_ext, spec.num_channels, spec.taps_per_phase,
                               state.hop_idx % 2, fold, planar, planar_in)
    keep = spec.ntaps - P
    new_hist = x_ext[..., -keep:] if planar_in else x_ext[..., -keep:, :]
    return Y, AnalyzerState(new_hist, state.hop_idx + n // P)


def synthesize(Y, spec: ChannelizerSpec, state: SynthesizerState,
               split: int = -1):
    """Streaming synthesis: Y (..., Nh, M, 2) -> (x (..., Nh*P, 2), state).
    split=-1 auto-selects the two-stage transform for large M."""
    Y = as_tensor(Y, device=state.carry.device)
    Nh = Y.shape[-3]
    if split < 0:
        split = default_split(spec.num_channels)
    x, carry = _synthesize_block(Y, spec.num_channels, spec.taps_per_phase,
                                 state.hop_idx % 2, state.carry, split)
    return x, SynthesizerState(carry, state.hop_idx + Nh)
