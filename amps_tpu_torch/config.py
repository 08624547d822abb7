"""Typed configuration for the AMPS pipeline (a copy of amps_tpu.config).

The reference hardcodes system constants (``GLOBAL_SID``/``GLOBAL_DCC_SHORT``/
``GLOBAL_SCC`` at lib/amps_packet.h:12-14, channels 355/356 at
lib/recc_decode_impl.cc:205,252) and spreads pipeline parameters over GRC
variables (grc/ampsbs.grc).  Here everything lives in two frozen dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """AMPS system parameters (TIA/EIA-553-A).

    Defaults reproduce the reference base station exactly.
    """

    sid: int = 16              # system ID (lib/amps_packet.h:12)
    dcc: int = 0               # digital color code (lib/amps_packet.h:13)
    scc: int = 1               # SAT color code; 1 -> 6000 Hz (lib/amps_packet.h:14)
    focc_channel: int = 354    # forward control channel (grc/ampsbs.grc FCC)
    voice_channels: Tuple[int, ...] = (355, 356)  # lib/recc_decode_impl.cc:205,252
    aggressive_registration: bool = False  # focc ctor flag (include/amps/focc.h:41)
    regincr: int = 100         # registration-increment (lib/focc_impl.cc:428)
    fvc_alert_repeats: int = 35  # "timerhack" bursts before auto fvc-off
                                 # (lib/recc_decode_impl.cc:215)
    recc_max_bad_symbols: int = 90  # per-word Manchester bad-pair gate in
                                 # handle_burst: random data that aliases
                                 # through BCH averages ~120/240 bad pairs,
                                 # real bursts ~0 (tens at the detection
                                 # cliff); the reference prints the counts
                                 # (lib/recc_decode_impl.cc:98) but never
                                 # gates on them
    page_repeats: int = 2        # superframes a page is repeated over, so
                                 # a mobile deferring during a busy-marked
                                 # superframe still hears one (553 §3.1.1;
                                 # extension -- the reference never repeats)

    @property
    def sat_freq_hz(self) -> float:
        """SAT tone frequency for this SCC (5970/6000/6030 Hz)."""
        return {0: 5970.0, 1: 6000.0, 2: 6030.0}[self.scc]

    def forward_freq_hz(self, channel: int) -> float:
        """Forward (BS->MS) carrier for an AMPS channel number.

        AMPS: channels 1..799 -> 870.030 + 0.030*(ch-1) MHz; the reference's
        354 -> 880.590 MHz (grc/ampsbs.grc fcc_freq).
        """
        return (870.000 + 0.030 * channel) * 1e6

    def reverse_freq_hz(self, channel: int) -> float:
        """Reverse (MS->BS) carrier: forward minus 45 MHz (grc/ampsbs.grc:3069)."""
        return self.forward_freq_hz(channel) - 45e6


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Sample-rate / DSP / sharding parameters.

    The AMPS control-channel line rate is 10 kbit/s, Manchester encoded to
    20 kbaud.  ``sym_rate`` is the per-channel TX sample rate; the reference
    uses 100 ksps (grc/ampsbs.grc symrate) giving 5 samples per Manchester
    symbol.  The multichannel channelizer path runs channels at
    ``chan_rate`` = 60 ksps (3 samples/symbol) on a 30 kHz grid.
    """

    baud: int = 20_000            # Manchester symbols / s (2x 10 kbit/s)
    sym_rate: int = 100_000       # per-channel TX sample rate (ref: symrate)
    tx_rate: int = 400_000        # wideband TX IQ rate (grc samp_rate)
    rx_rate: int = 400_000        # wideband RX IQ rate (grc rx_samprate)
    rx_decim: int = 2             # RX freq-xlating decimation -> 200 ksps
    deviation_hz: float = 8000.0  # FSK peak deviation (grc 2*pi*8000/symrate)
    channel_spacing_hz: int = 30_000   # AMPS channel grid
    chan_rate: int = 60_000       # per-channel rate in channelizer path (2x os)
    audio_rate: int = 16_000      # voice source rate (audio/boot16k.wav)
    sat_amplitude: float = 0.05   # SAT tone amplitude (grc/ampsbs.grc:360)

    # Channelizer / sharding
    num_channels: int = 128       # channels in the polyphase channelizer
    chan_taps_per_phase: int = 8  # prototype filter taps per polyphase branch
    mesh_time: int = 1            # shards along the time axis
    mesh_channels: int = 1        # shards along the channel axis
    block_symbols: int = 8192     # Manchester symbols per streaming block

    @property
    def sps(self) -> int:
        """TX samples per Manchester symbol at sym_rate (ref: samples_per_sym,
        lib/focc_impl.cc:106)."""
        assert self.sym_rate % self.baud == 0
        return self.sym_rate // self.baud

    @property
    def chan_sps(self) -> int:
        """Samples per Manchester symbol at the channelizer per-channel rate."""
        assert self.chan_rate % self.baud == 0
        return self.chan_rate // self.baud

    @property
    def wideband_rate(self) -> int:
        """Aggregate rate of the channelizer wideband signal."""
        return self.num_channels * self.channel_spacing_hz


DEFAULT_SYSTEM = SystemConfig()
DEFAULT_PIPELINE = PipelineConfig()
