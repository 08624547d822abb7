"""Planted-burst reverse-band traffic, the PyTorch port of
``amps_tpu.eval.traffic.synthesize_reverse_band``.

Events carry raw 36-bit info words.  Each burst follows
``amps_tpu.tx.recc_ms.burst_bits``: 30 dotting bits, the 11-bit word
sync, the coded DCC, each word's BCH(48,36) codeword x5, and dotting
pad to 7 word slots; it is Manchester coded, FSK modulated at the
60 ksps channel rate and placed into the plain synthesis bank.
Deterministic given the events and the seed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from amps_tpu_torch.codec.bch import recc_bch_encode
from amps_tpu_torch.codec.manchester import manchester_encode_symbols
from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.dsp.fm import fm_modulate_symbols

# 553 coded-DCC table (2.6.1.2): 2-bit DCC -> 7-bit coded DCC
CODED_DCC = {
    0: (0, 0, 0, 0, 0, 0, 0),
    1: (0, 0, 1, 1, 1, 0, 0),
    2: (1, 1, 0, 0, 0, 1, 1),
    3: (1, 1, 1, 1, 1, 1, 1),
}
WORD_SYNC = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], dtype=np.uint8)


@dataclasses.dataclass(frozen=True)
class BurstEvent:
    channel: int                 # bank slot (reverse channel)
    start_hop: int
    words: np.ndarray            # (n_words <= 7, 36) uint8 info words
    dcc: int = 0


def burst_bits(words36: Sequence[np.ndarray], dcc: int = 0) -> np.ndarray:
    """Full RECC seizure burst bit stream (uint8)."""
    if len(words36) > 7:
        raise ValueError("a RECC burst carries at most 7 words")
    parts = [np.tile(np.array([1, 0], np.uint8), 15), WORD_SYNC,
             np.array(CODED_DCC[dcc], dtype=np.uint8)]
    for w in words36:
        enc = recc_bch_encode(torch.as_tensor(np.asarray(w, np.uint8)))
        parts.append(np.tile(enc.numpy(), 5))
    pad = 7 - len(words36)
    if pad:
        parts.append(np.tile(np.array([1, 0], np.uint8), pad * 120))
    return np.concatenate(parts)


def burst_symbols(words36: Sequence[np.ndarray], dcc: int = 0,
                  sps: int = 1) -> np.ndarray:
    """±1 int8 symbol samples of the burst at sps samples per half-symbol."""
    return manchester_encode_symbols(
        torch.as_tensor(burst_bits(words36, dcc)), sps).numpy()


def synthesize_reverse_band(events: Sequence[BurstEvent], spec,
                            total_hops: int, noise_sigma: float = 0.0,
                            seed: int = 1, device=None) -> torch.Tensor:
    """(total_hops * M/2, 2) float32 wideband riq with every event's
    burst placed; white Gaussian noise of ``noise_sigma`` from
    numpy ``default_rng(seed)``.  ``spec`` is a MultichannelSpec."""
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
