"""RECC RX front end of the single-channel chain, the PyTorch port of
``amps_tpu.rx.frontend``: freq-xlating FIR decimator + FM discriminator.

Reference chain (grc/ampsbs.grc:1815,775): USRP @400 ksps ->
freq_xlating_fir_filter_ccc(center rx_offset=-160 kHz, decim 2, taps
firdes.low_pass(3, 400e3, 10e3, 4.5e3, BLACKMAN)) -> quadrature_demod_cf
(gain 1) -> clock recovery (``rx.correlator``).  A streaming function,
batched over leading dimensions, with explicit carried state (FIR
history, mixer phase index, demod history), on its input's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from amps_tpu_torch.config import PipelineConfig
from amps_tpu_torch.dsp.fir import freq_xlating_fir
from amps_tpu_torch.dsp.fm import quadrature_demod
from amps_tpu_torch.dsp.windows import firdes_low_pass


@functools.cache
def rx_lpf_taps(rx_rate: int = 400_000) -> np.ndarray:
    """lpf_taps of grc/ampsbs.grc (gain 3, cutoff 10 kHz, transition
    4.5 kHz, Blackman)."""
    return firdes_low_pass(3.0, rx_rate, 10_000.0, 4_500.0, "blackman")


@dataclasses.dataclass
class RxFrontendState:
    fir_history: Optional[torch.Tensor] = None
    phase_idx: int = 0
    demod_prev: Optional[torch.Tensor] = None


def rx_frontend(iq, pipe: Optional[PipelineConfig] = None,
                center_freq: float = -160_000.0,
                state: Optional[RxFrontendState] = None):
    """(..., n, 2) riq at rx_rate -> ((..., n/decim) FM demod float32,
    state)."""
    pipe = pipe or PipelineConfig()
    state = state or RxFrontendState()
    bb, hist, nxt = freq_xlating_fir(
        iq, rx_lpf_taps(pipe.rx_rate), center_freq, pipe.rx_rate,
        pipe.rx_decim, history=state.fir_history,
        phase_idx0=state.phase_idx)
    demod, last = quadrature_demod(bb, 1.0, state.demod_prev)
    return demod, RxFrontendState(hist, nxt, last)
