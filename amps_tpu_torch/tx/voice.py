"""Voice-channel synthesis: NBFM audio + SAT tone, the PyTorch port of
``amps_tpu.tx.voice``.

Reference path (grc/ampsbs.grc): WAV 16 kHz audio + 6 kHz SAT cosine
(amplitude 0.05, SCC-dependent 5970/6000/6030 Hz) -> analog_nbfm_tx
(preemphasis tau 75 µs, max deviation 8 kHz) -> resample to the channel
rate -> mixer.  The output is riq baseband at the channelizer
per-channel rate (60 ksps), ready for a synthesis-bank slot.

The preemphasis is a sequential one-pole IIR over ~13.3 k audio samples
per superframe, so it runs on the host (``scipy.signal.lfilter``, float64
state); its output moves to the device, where the resampler, the SAT
tone and the modulator run.
"""

from __future__ import annotations

from math import gcd
from typing import Optional

import numpy as np
import scipy.signal
import torch

from amps_tpu_torch.config import PipelineConfig, SystemConfig
from amps_tpu_torch.device import as_tensor, resolve_device
from amps_tpu_torch.dsp.fir import polyphase_interpolate
from amps_tpu_torch.dsp.fm import fm_modulate
from amps_tpu_torch.dsp.windows import firdes_low_pass


def preemphasis(audio, fs: float, tau: float = 75e-6, state=0.0):
    """FM preemphasis of a 1-D audio block: first-order high-shelf
    (bilinear transform of H(s) = 1 + s*tau with a pole at 0.925 fs/2,
    GR's convention), normalized to unity gain at DC.  Returns (filtered
    float32 tensor on the audio's device, final state: the last
    unnormalized output)."""
    audio = as_tensor(audio)
    k = 2.0 * fs * tau
    fh = 0.925 * fs / 2.0
    kh = np.tan(np.pi * fh / fs)
    b0 = (1.0 + k) / (1.0 + kh)
    b1 = (1.0 - k) / (1.0 + kh)
    a1 = (1.0 - kh) / (1.0 + kh)
    # y[n] = b0 x[n] + b1 x[n-1] + a1 y[n-1], x[-1] = 0, y[-1] = state
    y, _ = scipy.signal.lfilter([b0, b1], [1.0, -a1],
                                audio.cpu().numpy().astype(np.float64),
                                zi=[a1 * float(state)])
    dc = (b0 + b1) / (1.0 - a1)
    out = torch.as_tensor((y / dc).astype(np.float32), device=audio.device)
    return out, float(y[-1]) if len(y) else float(state)


def rational_resample(x, up: int, down: int, fs_in: float):
    """x at fs_in -> fs_in * up / down via polyphase interp + decimate."""
    cutoff = 0.45 * min(fs_in, fs_in * up / down)
    taps = firdes_low_pass(1.0, fs_in * up, cutoff, 0.1 * cutoff, "hamming")
    y, _ = polyphase_interpolate(x, taps * up, up)
    return y[..., ::down]


def voice_channel_baseband(audio, system: Optional[SystemConfig] = None,
                           pipe: Optional[PipelineConfig] = None,
                           sat: bool = True, phase0: float = 0.0,
                           t0: float = 0.0, device=None):
    """Audio (n,) at audio_rate -> riq baseband (n * chan_rate/audio_rate, 2)
    at the channelizer per-channel rate, NBFM modulated with SAT (summed
    into the modulating signal at ``pipe.sat_amplitude``).  Returns
    (iq, final phase) on ``device`` (default the current CUDA device; the
    CPU only when named)."""
    system = system or SystemConfig()
    pipe = pipe or PipelineConfig()
    emph, _ = preemphasis(audio, pipe.audio_rate)
    emph = emph.to(resolve_device(device))
    g = gcd(pipe.chan_rate, pipe.audio_rate)
    up, down = pipe.chan_rate // g, pipe.audio_rate // g
    m = rational_resample(emph, up, down, pipe.audio_rate)
    if sat:
        n = m.shape[-1]
        t = torch.arange(n, device=m.device) / pipe.chan_rate + t0
        m = m + pipe.sat_amplitude * torch.cos(
            2.0 * np.pi * system.sat_freq_hz * t)
    sens = 2.0 * np.pi * pipe.deviation_hz / pipe.chan_rate
    return fm_modulate(m, sens, phase0)
