"""Channel-slot baseband sources for the MultichannelTransmitter, the
PyTorch port of ``amps_tpu.runtime.sources`` (``VoiceFvcSlot`` and its
audio sources ``WavAudioSource`` and ``RvcRebroadcastSource``).

The reference's voice channels are an audio+SAT NBFM chain and an FVC
data chain feeding the same mixer through a pair of mute blocks toggled
by the control plane (blank-and-burst: grc/ampsbs.grc blocks_mute_xx
wired to recc_decode's audio_mute/fvc_mute ports).  VoiceFvcSlot is that
arrangement as a source object: per block it consults the station's mute
state and emits either FVC burst samples or voice+SAT baseband.  The
modulation runs on the slot's device (the transmitter's); the block
leaves as host numpy, which the transmitter copies into its channel
plane.
"""

from __future__ import annotations

import wave
from typing import Callable, Optional

import numpy as np
import torch

from amps_tpu_torch.config import PipelineConfig, SystemConfig
from amps_tpu_torch.control.station import BaseStation
from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.dsp.fm import fm_modulate_symbols, quadrature_demod
from amps_tpu_torch.rx.voice import nbfm_demod_audio, supervision_levels
from amps_tpu_torch.tx.voice import voice_channel_baseband


class VoiceFvcSlot:
    """Blank-and-burst voice channel source.

    audio_source(n) -> (n,) float32 audio at audio_rate, or None for
    silence.  The FVC data comes from the station's FvcStream; mutes are
    the station's fvc_mute/audio_mute state.  ``chan``: the AMPS voice
    channel this slot carries; with a ``per_channel_fvc`` station the
    slot reads that channel's FVC stream and mute pair, otherwise the
    station's shared stream and global mutes.  ``device``: where the
    slot modulates (default the current CUDA device; the CPU only when
    named).
    """

    def __init__(self, station: BaseStation,
                 audio_source: Optional[Callable[[int], np.ndarray]] = None,
                 system: Optional[SystemConfig] = None,
                 pipe: Optional[PipelineConfig] = None,
                 chan: Optional[int] = None, device=None):
        self.station = station
        self.device = resolve_device(device)
        self.system = system or station.system
        self.pipe = pipe or station.pipe
        self.audio_source = audio_source
        self.chan = chan
        self._sens = (2.0 * np.pi * self.pipe.deviation_hz
                      / self.pipe.chan_rate)
        self._fvc_accum = 0
        self._voice_phase = 0.0
        self._t = 0.0

    def __call__(self, n_hops: int) -> np.ndarray:
        """(n_hops, 2) riq baseband at chan_rate for the next block."""
        if not self.station.fvc_mute_for(self.chan):
            # FVC data active (blank-and-burst)
            syms = self.station.fvc_for(self.chan).next_block(n_hops)
            iq, accum = fm_modulate_symbols(
                torch.as_tensor(syms.astype(np.int8), device=self.device),
                self._sens, self._fvc_accum)
            self._fvc_accum = int(accum)
            self._t += n_hops / self.pipe.chan_rate
            return iq.cpu().numpy()
        # voice (+SAT) active
        n_audio = int(round(n_hops * self.pipe.audio_rate
                            / self.pipe.chan_rate))
        if (self.audio_source is not None
                and not self.station.audio_mute_for(self.chan)):
            audio = np.asarray(self.audio_source(n_audio), np.float32)
        else:
            audio = np.zeros(n_audio, np.float32)
        iq, phase = voice_channel_baseband(
            audio, self.system, self.pipe, sat=True,
            phase0=self._voice_phase, t0=self._t, device=self.device)
        self._voice_phase = float(phase) % (2.0 * np.pi)
        self._t += n_hops / self.pipe.chan_rate
        out = iq.cpu().numpy()
        if len(out) < n_hops:
            out = np.pad(out, ((0, n_hops - len(out)), (0, 0)))
        return out[:n_hops]


class WavAudioSource:
    """Looping audio file source (the reference's boot16k.wav player):
    source(n) -> the next n float32 samples in [-1, 1), mono (channels
    averaged), 8- or 16-bit PCM at ``rate``."""

    def __init__(self, path: str, rate: int = 16_000):
        with wave.open(path, "rb") as w:
            if w.getframerate() != rate:
                raise ValueError(f"{path} is at {w.getframerate()} Hz, "
                                 f"the source needs {rate}")
            raw = w.readframes(w.getnframes())
            width = w.getsampwidth()
            nch = w.getnchannels()
        if width == 2:
            data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 1:
            data = (np.frombuffer(raw, np.uint8).astype(np.float32)
                    - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported sample width {width}")
        if nch > 1:
            data = data.reshape(-1, nch).mean(axis=1)
        if not len(data):
            raise ValueError(f"{path} holds no samples")
        self.data = data
        self._off = 0

    def __call__(self, n: int) -> np.ndarray:
        out = np.empty(n, np.float32)
        filled = 0
        while filled < n:
            take = min(n - filled, len(self.data) - self._off)
            out[filled:filled + take] = self.data[self._off:self._off + take]
            self._off = (self._off + take) % len(self.data)
            filled += take
        return out


class RvcRebroadcastSource:
    """ampsbs_rvc.grc loop-back: audio demodulated from a reverse-voice
    channelizer slot, re-broadcast on a forward voice slot.

    ``rvc_baseband(n_hops) -> (n_hops, 2)`` riq of the monitored RVC
    slot at chan_rate.  Instances are ``audio_source`` callables for
    VoiceFvcSlot, so the re-broadcast rides the standard voice+SAT chain
    (fresh land-side SAT replaces the mobile's transponded one).  The
    most recent supervision measurement of the monitored slot is kept in
    ``last_levels``/``last_power`` (numpy) for the control plane.
    ``device``: where the demodulation runs (default the current CUDA
    device; the CPU only when named)."""

    def __init__(self, rvc_baseband: Callable[[int], np.ndarray],
                 system: Optional[SystemConfig] = None,
                 pipe: Optional[PipelineConfig] = None,
                 supervision_frame: int = 600, device=None):
        self.rvc_baseband = rvc_baseband
        self.device = resolve_device(device)
        self.system = system or SystemConfig()
        self.pipe = pipe or PipelineConfig()
        self.sup_frame = supervision_frame
        self.last_levels: Optional[np.ndarray] = None
        self.last_power: Optional[np.ndarray] = None

    def __call__(self, n_audio: int) -> np.ndarray:
        pipe = self.pipe
        n_hops = int(round(n_audio * pipe.chan_rate / pipe.audio_rate))
        iq = torch.as_tensor(np.asarray(self.rvc_baseband(n_hops),
                                        np.float32), device=self.device)
        audio = nbfm_demod_audio(iq, self.system, pipe)[0].cpu().numpy()
        # supervision measurement on the raw discriminator stream
        sens = 2.0 * np.pi * pipe.deviation_hz / pipe.chan_rate
        d = quadrature_demod(iq)[0] / sens
        if d.shape[-1] >= self.sup_frame:
            lv, pw = supervision_levels(d, self.sup_frame,
                                        float(pipe.chan_rate))
            self.last_levels = lv.cpu().numpy()
            self.last_power = pw.cpu().numpy()
        if len(audio) < n_audio:
            audio = np.pad(audio, (0, n_audio - len(audio)))
        return audio[:n_audio]
