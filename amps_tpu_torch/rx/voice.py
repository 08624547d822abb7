"""Reverse-voice-channel (RVC) monitor, the PyTorch port of
``amps_tpu.rx.voice``: NBFM demod + deemphasis + SAT, and the framed
supervisory-tone measurement of the voice-supervision receive path.

The reference's ampsbs_rvc.grc variant taps a reverse voice channel
(second freq_xlating_fir at -100 kHz -> NBFM RX -> re-broadcast).  Here a
channelizer slot's riq baseband at 60 ksps demodulates to audio at 16 kHz
with the SAT tone measured.

The deemphasis is a sequential one-pole IIR, so it runs on the host
(``scipy.signal.lfilter``, float64 state), as ``tx.voice.preemphasis``
does; everything else runs on the input's device.
"""

from __future__ import annotations

import functools
from math import gcd
from typing import Optional

import numpy as np
import scipy.signal
import torch

from amps_tpu_torch.config import PipelineConfig, SystemConfig
from amps_tpu_torch.device import as_tensor
from amps_tpu_torch.dsp.fir import polyphase_interpolate
from amps_tpu_torch.dsp.fm import quadrature_demod
from amps_tpu_torch.dsp.windows import firdes_low_pass

SAT_TONES_HZ = {0: 5970.0, 1: 6000.0, 2: 6030.0}
SUPERVISION_TONES_HZ = (5970.0, 6000.0, 6030.0, 10_000.0)
ST_INDEX = 3     # 10 kHz signaling tone (TIA/EIA-553 §2.7.1.2)
GUARD_INDEX = 4  # noise-reference column (mean of the guard bins)
# Noise-reference guard bins: empty spectrum away from voice (<= 3 kHz),
# SAT (~6 kHz) and ST (10 kHz).  A real signaling tone dominates them by
# orders of magnitude; dead-carrier discriminator noise is spectrally
# white, so its ST-bin level matches the guard bins (the per-frame
# dominance gate, control/supervision.py st_guard_ratio).
GUARD_TONES_HZ = (8_200.0, 11_800.0)


def deemphasis(audio, fs: float, tau: float = 75e-6, state=0.0):
    """Single-pole FM deemphasis of a 1-D audio block: y[n] = a*x[n] +
    (1-a)*y[n-1], y[-1] = ``state``, with a rounded to float32 as the JAX
    package rounds it; the recursion itself runs in float64.  Returns
    (float32 tensor on the audio's device, final state)."""
    audio = as_tensor(audio)
    a = float(np.float32(1.0 - np.exp(-1.0 / (fs * tau))))
    b = float(np.float32(1.0) - np.float32(a))
    y, _ = scipy.signal.lfilter([a], [1.0, -b],
                                audio.cpu().numpy().astype(np.float64),
                                zi=[b * float(state)])
    out = torch.as_tensor(y.astype(np.float32), device=audio.device)
    return out, float(y[-1]) if len(y) else float(state)


def sat_levels(demod, fs: float, block: Optional[int] = None):
    """SAT detection: projection of the FM-demodulated signal (..., n)
    onto the three SAT frequencies.  Returns dict scc -> amplitude
    estimate (...,).  ``block`` is accepted as the JAX function accepts
    it, and unused there too: the projection spans the whole signal."""
    x = as_tensor(demod)
    n = x.shape[-1]
    t = torch.arange(n, device=x.device) / fs
    out = {}
    for scc, f in SAT_TONES_HZ.items():
        re = torch.sum(x * torch.cos(2.0 * np.pi * f * t), dim=-1) * (2.0 / n)
        im = torch.sum(x * torch.sin(2.0 * np.pi * f * t), dim=-1) * (2.0 / n)
        out[scc] = torch.sqrt(re * re + im * im)
    return out


def detect_scc(demod, fs: float):
    """The SAT color code with the largest projection: (scc, levels
    (..., 3))."""
    levels = sat_levels(demod, fs)
    arr = torch.stack([levels[0], levels[1], levels[2]], dim=-1)
    return torch.argmax(arr, dim=-1), arr


def nbfm_demod_audio(iq, system: Optional[SystemConfig] = None,
                     pipe: Optional[PipelineConfig] = None):
    """riq (n, 2) at chan_rate -> (audio (n*audio/chan,), sat dict):
    audio low-passed to 3 kHz, decimated to audio_rate and deemphasized;
    SAT measured before the audio low-pass."""
    system = system or SystemConfig()
    pipe = pipe or PipelineConfig()
    demod, _ = quadrature_demod(as_tensor(iq))
    sens = 2.0 * np.pi * pipe.deviation_hz / pipe.chan_rate
    demod = demod / float(np.float32(sens))   # the modulating signal
    sat = sat_levels(demod, pipe.chan_rate)
    g = gcd(pipe.chan_rate, pipe.audio_rate)
    down = pipe.chan_rate // g               # 15
    up = pipe.audio_rate // g                # 4
    taps = firdes_low_pass(1.0, pipe.chan_rate * up, 3000.0, 1000.0,
                           "hamming")
    y, _ = polyphase_interpolate(demod, taps * up, up)
    audio, _ = deemphasis(y[..., ::down], pipe.audio_rate)
    return audio, sat


@functools.cache
def _supervision_basis(frame_len: int, fs: float) -> np.ndarray:
    """(frame_len, 12) cos/sin basis for the 3 SAT tones + ST + 2 guard
    bins, scaled so the projection of a unit-amplitude tone is ~1."""
    t = np.arange(frame_len) / fs
    cols = []
    for f in SUPERVISION_TONES_HZ + GUARD_TONES_HZ:
        cols.append(np.cos(2.0 * np.pi * f * t))
        cols.append(np.sin(2.0 * np.pi * f * t))
    return (np.stack(cols, axis=1) * (2.0 / frame_len)).astype(np.float32)


@functools.cache
def _basis_on(frame_len: int, fs: float, device) -> torch.Tensor:
    return torch.as_tensor(_supervision_basis(frame_len, fs), device=device)


def _tone_amplitudes(frames, fs: float):
    """(..., F, n) frames -> (..., F, 6) amplitudes of the basis tones."""
    proj = frames @ _basis_on(frames.shape[-1], float(fs), frames.device)
    cs = proj.reshape(proj.shape[:-1] + (6, 2))
    return torch.sqrt(torch.sum(cs * cs, dim=-1))


def supervision_levels(demod, frame_len: int, fs: float, sat_agg: int = 12):
    """Framed supervisory-tone measurement on FM-demod streams.

    demod: (..., n) discriminator output; amplitudes come out in the
    units of the input tone amplitude.  ST and band power use frames of
    ``frame_len`` samples (600 = 10 ms at 60 ksps).  The three SAT tones
    are 30 Hz apart, far inside a 10 ms frame's 100 Hz bin, so SAT is
    measured over ``sat_agg`` consecutive frames and held back onto the
    fine frame grid (the last whole group's value over a ragged tail).

    Returns (levels (..., F, 5) amplitudes of [SAT0, SAT1, SAT2, ST,
    GUARD], GUARD the mean amplitude of the two guard bins; power
    (..., F) mean demod power per frame)."""
    x = as_tensor(demod)
    nf = x.shape[-1] // frame_len
    fr = x[..., : nf * frame_len].reshape(x.shape[:-1] + (nf, frame_len))
    amps = _tone_amplitudes(fr, fs)                      # (..., F, 6)
    guard = torch.mean(amps[..., 4:6], dim=-1, keepdim=True)
    levels = torch.cat([amps[..., :4], guard], dim=-1)
    power = torch.mean(fr * fr, dim=-1)
    clen = frame_len * sat_agg
    nc = x.shape[-1] // clen
    if nc >= 1:
        cfr = x[..., : nc * clen].reshape(x.shape[:-1] + (nc, clen))
        sat = torch.repeat_interleave(_tone_amplitudes(cfr, fs)[..., :3],
                                      sat_agg, dim=-2)
        pad = nf - nc * sat_agg
        if pad > 0:
            sat = torch.cat([sat, sat[..., -1:, :].expand(
                sat.shape[:-2] + (pad, 3))], dim=-2)
        levels = torch.cat([sat, levels[..., 3:]], dim=-1)
    return levels, power
