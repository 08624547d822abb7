"""Multi-mobile reverse-band traffic, the PyTorch port of
``amps_tpu.eval.traffic`` (``MobileEvent``, ``random_events``,
``synthesize_reverse_band``), and the unit-amplitude band the analysis
kernel is checked on.

A ``MobileEvent`` is one mobile's access (origination, page response or
registration), whose words come from ``tx.recc_ms``; a ``BurstEvent``
carries raw 36-bit info words and a DCC.  Each burst is
``tx.recc_ms.burst_symbols``: 30 dotting bits, the 11-bit word sync, the
coded DCC, each word's BCH(48,36) codeword x5, and dotting pad to 7 word
slots; it is Manchester coded, FSK modulated at the 60 ksps channel rate
and placed into the plain synthesis bank.
Deterministic given the events and the seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.dsp.fm import fm_modulate_symbols
from amps_tpu_torch.tx import recc_ms
from amps_tpu_torch.tx.recc_ms import burst_symbols


@dataclasses.dataclass
class MobileEvent:
    kind: str          # origination | page_response | registration
    channel: int       # bank slot (reverse channel)
    start_hop: int
    min_str: str
    dialed: str = ""
    esn: Optional[int] = None

    @classmethod
    def parse(cls, text: str, channel: int = 0, start_hop: int = 0):
        """The event of a command-line form: ``origination:MIN:DIALED``,
        ``page_response:MIN`` or ``registration:MIN[:ESN]``; ValueError
        for another kind."""
        kind, min_str, *rest = text.split(":")
        if kind == "origination":
            return cls(kind, channel, start_hop, min_str, rest[0])
        if kind == "page_response":
            return cls(kind, channel, start_hop, min_str)
        if kind == "registration":
            esn = int(rest[0], 0) if rest else None
            return cls(kind, channel, start_hop, min_str, esn=esn)
        raise ValueError(f"unknown mobile event kind {kind!r}")

    def words(self):
        if self.kind == "origination":
            return recc_ms.origination_words(self.min_str, self.dialed,
                                             esn=self.esn)
        if self.kind == "page_response":
            return recc_ms.page_response_words(self.min_str)
        if self.kind == "registration":
            return recc_ms.registration_words(self.min_str, esn=self.esn)
        raise ValueError(self.kind)


@dataclasses.dataclass(frozen=True)
class BurstEvent:
    channel: int                 # bank slot (reverse channel)
    start_hop: int
    words: np.ndarray            # (n_words <= 7, 36) uint8 info words
    dcc: int = 0


def random_events(n_events: int, spec, total_hops: int, seed: int = 0,
                  channels=None) -> List[MobileEvent]:
    """Events with non-overlapping bursts per channel, drawn from numpy
    ``default_rng(seed)`` in the JAX package's order: one seed gives the
    same list in both packages.  ``spec`` is a MultichannelSpec."""
    rng = np.random.default_rng(seed)
    sps = spec.chan_sps
    burst_hops = (41 + 7 + 7 * 240) * 2 * sps + 64
    channels = list(channels if channels is not None
                    else range(spec.num_channels))
    next_free = {c: 200 for c in channels}
    kinds = ["origination", "page_response", "registration"]
    out: List[MobileEvent] = []
    for _ in range(n_events):
        c = channels[int(rng.integers(len(channels)))]
        start = next_free[c] + int(rng.integers(0, 2000))
        if start + burst_hops + 200 > total_hops:
            continue
        next_free[c] = start + burst_hops + int(rng.integers(500, 1500))
        kind = kinds[int(rng.integers(3))]
        min_str = "".join(str(int(d)) for d in rng.integers(1, 9, 10))
        dialed = "".join(str(int(d)) for d in rng.integers(1, 9, 10))
        esn = int(rng.integers(1, 1 << 31)) if rng.random() < 0.5 else None
        out.append(MobileEvent(kind, c, start, min_str, dialed, esn))
    return out


def synthesize_reverse_band(events: Sequence[Union[MobileEvent, BurstEvent]],
                            spec, total_hops: int, noise_sigma: float = 0.0,
                            seed: int = 1, device=None) -> torch.Tensor:
    """(total_hops * M/2, 2) float32 wideband riq with every event's
    burst placed (a MobileEvent's words at DCC 0, as the JAX package
    does; a BurstEvent's own words and DCC); white Gaussian noise of
    ``noise_sigma`` from numpy ``default_rng(seed)``.  ``spec`` is a
    MultichannelSpec.  Made on ``device``: default the current CUDA
    device, the CPU only when named."""
    dev = resolve_device(device)
    Y = torch.zeros((total_hops, spec.num_channels, 2), dtype=torch.float32,
                    device=dev)
    for ev in events:
        if isinstance(ev, MobileEvent):
            words, dcc = ev.words(), 0
        else:
            words, dcc = ev.words, ev.dcc
        syms = burst_symbols(words, dcc=dcc, sps=spec.chan_sps)
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
