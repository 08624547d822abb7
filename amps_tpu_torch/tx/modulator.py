"""TX modulator chain, the PyTorch port of ``amps_tpu.tx.modulator``:
±1 symbols -> FSK baseband -> interpolated IQ.

Reference chain (grc/ampsbs.grc): char_to_float -> frequency_modulator_fc
(sensitivity 2π·8000/100000) -> pfb_interpolator_ccf x4 with
firdes.low_pass(1, 400e3, 10e3, 5e3) taps -> per-channel mixer.  The
chain is batched over leading dimensions and runs on its input's device.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from amps_tpu_torch.config import PipelineConfig
from amps_tpu_torch.dsp.fir import polyphase_interpolate_iq
from amps_tpu_torch.dsp.fm import fm_modulate_symbols
from amps_tpu_torch.dsp.windows import firdes_low_pass


def fsk_baseband(symbols, pipe: Optional[PipelineConfig] = None,
                 phase_accum0=0):
    """±1 symbols at sym_rate -> FSK baseband riq at sym_rate.  Returns
    (iq (..., n, 2), accumulator) for streaming continuity."""
    pipe = pipe or PipelineConfig()
    sens = 2.0 * np.pi * pipe.deviation_hz / pipe.sym_rate
    return fm_modulate_symbols(symbols, sens, phase_accum0)


@functools.cache
def tx_interp_taps(tx_rate: int = 400_000) -> np.ndarray:
    """The reference's TX interpolation low-pass (grc/ampsbs.grc:2227)."""
    return firdes_low_pass(1.0, tx_rate, 10_000.0, 5_000.0, "hamming")


def fm_modulate(symbols, pipe: Optional[PipelineConfig] = None,
                phase_accum0=0, interp_history=None):
    """The TX chain of one block: symbols (..., n) int8 at sym_rate ->
    (iq riq (..., n*interp, 2) at tx_rate, state), state = (phase
    accumulator, interpolator history)."""
    pipe = pipe or PipelineConfig()
    if pipe.tx_rate % pipe.sym_rate:
        raise ValueError(f"tx_rate {pipe.tx_rate} is not a multiple of "
                         f"sym_rate {pipe.sym_rate}")
    interp = pipe.tx_rate // pipe.sym_rate
    iq, accum = fsk_baseband(symbols, pipe, phase_accum0)
    out, hist = polyphase_interpolate_iq(iq, tx_interp_taps(pipe.tx_rate),
                                         interp, interp_history)
    return out, (accum, hist)
