"""Ratio-2 oversampled polyphase channelizers (analysis + synthesis),
the PyTorch port of ``amps_tpu.dsp.channelizer``.

Math (weighted overlap-add form; h = prototype lowpass, L = M*T taps):
  analysis   y_k[n] = (-1)^{k n} * sum_r E+[k,r] v_n[r],
             v_n[r] = fold mod M of h[m] x[nP-m] over the hop-n window
  synthesis  x[s]   = sum_n g[s-nP] * u_n[(s-nP) mod M],
             u_n[m] = sum_k (-1)^{k n} Y_k[n] E+[k,m]
Channel k sits at center frequency +k*Δf (k mod M; k>M/2 => negative).

One analysis fold is computed, the production ``fold="bank"`` (the two
parity banks fed straight into permutation-absorbed transform matrices).
The JAX package's other fold names (``FOLDS``) are accepted and give the
same bank fold: they are the same sum in another f32 order.  An unknown
name raises ``ValueError``.  The constant tables live in
``dsp.polyphase``.

``analyze`` runs the block analysis of ``kernels.analysis`` (the kernel
on a CUDA device, its plain version ``analyze_reference`` on the CPU);
on the receive path the analysis runs fused with the discriminator in
``kernels.rx_phases`` and ``kernels.rx_front``, and the transmitter's
synthesis runs in ``kernels.synth``, whose plain version is
``_synthesize_block`` here.  ``synthesize`` stays plain: it builds test
traffic independently of the kernels.  Past ``DENSE_MAX_WIDTH`` (32768)
the plain synthesis transform is a float64 inverse FFT
(``dsp.polyphase.fft_rows``) instead of the dense or two-stage matrices,
whose tables would take 8·M² bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from amps_tpu_torch.device import as_tensor, resolve_device
from amps_tpu_torch.dsp.polyphase import (DENSE_MAX_WIDTH, _dft_mats_on,
                                          _dft_split_mats, _hop_sign,
                                          fft_rows, prototype_taps)
from amps_tpu_torch.kernels.analysis import analyze_block


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

    @property
    def fs(self) -> float:
        """Wideband sample rate."""
        return self.num_channels * self.spacing_hz

    @property
    def channel_rate(self) -> float:
        """Per-channel output rate (2x oversampled)."""
        return 2 * self.spacing_hz


# the analysis fold names of the JAX package; all compute the bank fold
FOLDS = ("conv", "shift", "bank", "bank2", "bankp")


def check_fold(fold: str) -> None:
    """Raise ValueError unless ``fold`` is one of ``FOLDS``."""
    if fold not in FOLDS:
        raise ValueError(f"unknown fold {fold!r}: one of {FOLDS}")


def default_split(M: int) -> int:
    """Auto split factor M2 of the synthesis transform: two-stage with a
    128-deep first stage for M >= 512, dense (0) otherwise."""
    return 128 if (M % 128 == 0 and M >= 512) else 0


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def _transform_hopmajor(yr, yi, M: int, split: int):
    """u[n, m] = sum_k y[n, k] E+[k, m] on hop-major (..., Nh, M) planes.
    split=0: dense (M, M) matmul pair; split=M2: two-stage Cooley-Tukey;
    past DENSE_MAX_WIDTH, whatever split, a float64 inverse FFT."""
    if M > DENSE_MAX_WIDTH:
        return fft_rows(yr, yi, inverse=True)
    if not split:
        C, S = _dft_mats_on(M, yr.device)
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
    """Zero analyzer state on ``device`` (default the current CUDA
    device; the CPU only when named)."""
    L, P = spec.ntaps, spec.hop
    shape = batch + ((2, L - P) if planar_in else (L - P, 2))
    return AnalyzerState(torch.zeros(shape, dtype=torch.float32,
                                     device=resolve_device(device)), 0)


def synthesizer_init(spec: ChannelizerSpec, batch: Tuple[int, ...] = (),
                     device=None) -> SynthesizerState:
    """Zero synthesizer state on ``device`` (default the current CUDA
    device; the CPU only when named)."""
    L, P = spec.ntaps, spec.hop
    return SynthesizerState(torch.zeros(batch + (L - P, 2),
                                        dtype=torch.float32,
                                        device=resolve_device(device)), 0)


def _synthesize_block(Y, M: int, T: int, hop0_parity: int, carry,
                      split: int = 0, taps=None):
    """Y: (..., Nh, M, 2) channel basebands -> (..., Nh*P, 2) wideband +
    new overlap-add carry (..., L-P, 2).  Overlap-add in P-sample block
    coordinates: output block b sample p receives
    sum_j g[jP+p] * u_{b-j}[(j&1)P + p].  ``taps``: the M*T prototype
    taps g/P (default ``prototype_taps(M, T)``), e.g. rows of a longer
    filter's."""
    L = M * T
    P = M // 2
    Nh = Y.shape[-3]
    sgn = _hop_sign(M, Nh, hop0_parity, Y.device).transpose(0, 1)  # (Nh, M)
    yr = Y[..., 0] * sgn
    yi = Y[..., 1] * sgn
    ur, ui = _transform_hopmajor(yr, yi, M, split)               # (..., Nh, M)
    gm = _const(prototype_taps(M, T) if taps is None else taps,
                Y).reshape(T, M) * np.float32(P)
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
            chmajor: bool = False, bf16: bool = False, split: int = -1,
            fold: str = "conv", planar: bool = False,
            planar_in: bool = False, block=None):
    """Streaming analysis: x (..., N, 2), N a multiple of spec.hop — or
    planar planes (..., 2, N) when ``planar_in`` (channel-major only;
    state from analyzer_init(..., planar_in=True)).  Returns (Y, new
    state); Y is (..., N/P, M, 2) hop-major, (..., M, N/P, 2)
    channel-major when ``chmajor``, or (..., 2, M, N/P) planar
    channel-major when also ``planar``.  ``fold`` any name of ``FOLDS``
    (one fold is computed for all).  ``bf16`` and ``split`` are accepted
    and change nothing: the transform is f32 for every spec.  A block
    with an odd hop count flips the parity of the next one.  Runs on the
    state's device.

    ``block``: the block analysis, by default
    ``kernels.analysis.analyze_block`` (the kernel on a CUDA device, one
    launch a row of the leading dimensions; its plain version on the
    CPU); ``kernels.analysis.analyze_reference`` runs the plain version
    on any device (to compare the two)."""
    check_fold(fold)
    if planar and not chmajor:
        raise ValueError("planar output requires chmajor")
    if planar_in and not chmajor:
        raise ValueError("planar input requires chmajor")
    P = spec.hop
    x = as_tensor(x, device=state.history.device)
    n = x.shape[-1] if planar_in else x.shape[-2]
    if n % P:
        raise ValueError(f"block length {n} not a multiple of hop {P}")
    cat_dim = -1 if planar_in else -2
    x_ext = torch.cat([state.history, x], dim=cat_dim)
    Y = (block or analyze_block)(x_ext, spec.num_channels,
                                 spec.taps_per_phase, state.hop_idx % 2,
                                 planar, planar_in)
    if not chmajor:
        Y = Y.transpose(-3, -2).contiguous()
    keep = spec.ntaps - P
    new_hist = x_ext[..., -keep:] if planar_in else x_ext[..., -keep:, :]
    return Y, AnalyzerState(new_hist, state.hop_idx + n // P)


def synthesize(Y, spec: ChannelizerSpec, state: SynthesizerState,
               bf16: bool = False, split: int = -1):
    """Streaming synthesis: Y (..., Nh, M, 2) -> (x (..., Nh*P, 2), state).
    split=-1 auto-selects the two-stage transform for large M; ``bf16``
    is accepted and changes nothing (the transform is f32)."""
    Y = as_tensor(Y, device=state.carry.device)
    Nh = Y.shape[-3]
    if split < 0:
        split = default_split(spec.num_channels)
    x, carry = _synthesize_block(Y, spec.num_channels, spec.taps_per_phase,
                                 state.hop_idx % 2, state.carry, split)
    return x, SynthesizerState(carry, state.hop_idx + Nh)


def channel_index(offset_channels: int, M: int) -> int:
    """Signed channel offset (e.g. -3..+3 around the band center) to the
    k index used by the bank."""
    return offset_channels % M
