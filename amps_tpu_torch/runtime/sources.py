"""Channel-slot baseband sources for the MultichannelTransmitter, the
PyTorch port of ``amps_tpu.runtime.sources.VoiceFvcSlot``.

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

from typing import Callable, Optional

import numpy as np
import torch

from amps_tpu_torch.config import PipelineConfig, SystemConfig
from amps_tpu_torch.control.station import BaseStation
from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.dsp.fm import fm_modulate_symbols
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
