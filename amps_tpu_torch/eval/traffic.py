"""Planted-burst reverse-band traffic, the PyTorch port of
``amps_tpu.eval.traffic.synthesize_reverse_band``, and the unit-amplitude
band the analysis kernel is checked on.

Events carry raw 36-bit info words.  Each burst is
``tx.recc_ms.burst_symbols``: 30 dotting bits, the 11-bit word sync, the
coded DCC, each word's BCH(48,36) codeword x5, and dotting pad to 7 word
slots; it is Manchester coded, FSK modulated at the 60 ksps channel rate
and placed into the plain synthesis bank.
Deterministic given the events and the seed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.dsp.fm import fm_modulate_symbols
from amps_tpu_torch.tx.recc_ms import burst_symbols


@dataclasses.dataclass(frozen=True)
class BurstEvent:
    channel: int                 # bank slot (reverse channel)
    start_hop: int
    words: np.ndarray            # (n_words <= 7, 36) uint8 info words
    dcc: int = 0


def synthesize_reverse_band(events: Sequence[BurstEvent], spec,
                            total_hops: int, noise_sigma: float = 0.0,
                            seed: int = 1, device=None) -> torch.Tensor:
    """(total_hops * M/2, 2) float32 wideband riq with every event's
    burst placed; white Gaussian noise of ``noise_sigma`` from
    numpy ``default_rng(seed)``.  ``spec`` is a MultichannelSpec.  Made
    on ``device``: default the current CUDA device, the CPU only when
    named."""
    dev = resolve_device(device)
    Y = torch.zeros((total_hops, spec.num_channels, 2), dtype=torch.float32,
                    device=dev)
    for ev in events:
        syms = burst_symbols(ev.words, dcc=ev.dcc, sps=spec.chan_sps)
        bb, _ = fm_modulate_symbols(torch.as_tensor(syms, device=dev),
                                    spec.fm_sensitivity)
        n = min(bb.shape[0], total_hops - ev.start_hop)
        Y[ev.start_hop: ev.start_hop + n, ev.channel] = bb[:n]
    x, _ = chz.synthesize(Y, spec.chz_spec,
                          chz.synthesizer_init(spec.chz_spec, device=dev))
    if noise_sigma > 0:
        rng = np.random.default_rng(seed)
        noise = rng.normal(0, noise_sigma, tuple(x.shape)).astype(np.float32)
        x = x + torch.as_tensor(noise, device=dev)
    return x


def unit_channel_band(M: int, T: int, Nh: int, seed: int,
                      device=None) -> torch.Tensor:
    """History-prepended wideband ((Nh + 2T - 1) * M/2, 2) whose M
    channels carry unit-modulus basebands of random phase (numpy
    ``default_rng(seed)``), through the plain synthesis bank: the input
    on which an analysis is held to a tolerance in absolute terms.  Made
    on ``device``: default the current CUDA device, the CPU only when
    named."""
    dev = resolve_device(device)
    ph = np.random.default_rng(seed).uniform(-np.pi, np.pi, (Nh, M)).astype(
        np.float32)
    Y = torch.as_tensor(np.stack([np.cos(ph), np.sin(ph)], -1), device=dev)
    carry = torch.zeros((M * T - M // 2, 2), device=dev)
    x, _ = chz._synthesize_block(Y, M, T, 0, carry)
    return torch.cat([carry, x]).contiguous()
