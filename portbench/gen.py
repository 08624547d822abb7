"""The benchmark's traffic generator: every traffic mix is a JSON file of
parameters under ``traffic/`` that names one of the kinds below.

``rx_stream``: the reverse band a base station's receiver hears, as a
pool of ``pool_pushes`` pushes of ``push_hops`` hops each (hops of M/2
wideband samples), made on the device and cycled.  RECC bursts of 2-7
random 36-bit words at the mix's DCC are planted on the configuration's
control channels (``recc_channels``, AMPS channel n in bank slot
(n - ``center_channel``) mod M), ``bursts_per_channel`` on each in every
cycle of the pool at random hops: never two on one channel closer than
a burst and ``min_gap_hops``, none within ``edge_hops`` of the pool's
ends (so none straddles its wrap), each at unit amplitude in its channel
with a random carrier phase.  Every seed plants the same number of
bursts; only their hops, words and phases differ.  White Gaussian noise
sets each channel's SNR to ``snr_db``.  The bursts' channel basebands
(FSK at the channel rate, ``sps`` samples a half-symbol) are modulated
onto the band by the reference bank's synthesis.  Everything is drawn
from the seed: the burst list from numpy's ``default_rng``, the noise
from a ``torch.Generator`` on the device.

``duplex_loop``: the forward band of a full-duplex station, a pool of
``pool_calls`` sets of random FOCC word pairs, one pair a frame on every
channel, ``frames`` frames a block: (pool_calls, M, frames, 2, 28) bits
from ``default_rng(seed)``, on the host, where the loop takes them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from portbench.reference import bank, recc

BURST_BITS = 30 + 11 + 7 + recc.WORDS * recc.REPEATS * 48


@dataclasses.dataclass(frozen=True)
class Burst:
    channel: int
    hop: int                 # pool hop of the burst's first channel sample
    words: np.ndarray        # (n, 36) uint8 info words, 2 <= n <= 7
    dcc: int
    phase: float             # carrier phase at the first sample


@dataclasses.dataclass
class RxPool:
    x: torch.Tensor          # (pool_pushes * push_hops * M/2, 2) float32
    bursts: List[Burst]
    M: int
    T: int
    sps: int
    push_hops: int
    pool_pushes: int

    @property
    def pool_hops(self) -> int:
        return self.push_hops * self.pool_pushes

    def block(self, i: int) -> torch.Tensor:
        """The wideband samples of push i (a view of the pool)."""
        n = self.push_hops * self.M // 2
        k = i % self.pool_pushes
        return self.x[k * n:(k + 1) * n]

    def stream_blocks(self, cyclic: bool):
        """``blocks(b0, b1)`` of the pushed stream as complex128 hop
        blocks: pool blocks cycled; before the stream's start zeros, or
        with ``cyclic`` the pool's tail."""
        P = self.M // 2
        nb = self.pool_hops
        xc = self.x.reshape(nb, P, 2)

        def blocks(b0: int, b1: int) -> torch.Tensor:
            idx = torch.arange(b0, b1, device=self.x.device)
            v = xc[torch.remainder(idx, nb)].to(torch.float64)
            z = torch.complex(v[..., 0], v[..., 1])
            if not cyclic:
                z[idx < 0] = 0
            return z

        return blocks


def burst_hops(sps: int) -> int:
    return BURST_BITS * 2 * sps


def control_slots(cfg: dict) -> List[int]:
    """The bank slots of the configuration's control channels."""
    lo, hi = cfg["recc_channels"]
    return [(n - cfg["center_channel"]) % cfg["num_channels"]
            for n in range(lo, hi + 1)]


def place_bursts(cfg: dict, mix: dict, seed: int) -> List[Burst]:
    """The pool's bursts, drawn from ``default_rng(seed)``: on each
    control channel ``bursts_per_channel`` starts, spaced by a burst and
    ``min_gap_hops`` at least, the rest of the channel's span spread at
    random between them."""
    rng = np.random.default_rng(seed)
    pool = mix["push_hops"] * mix["pool_pushes"]
    bh = burst_hops(cfg["chan_sps"])
    k, edge = mix["bursts_per_channel"], mix["edge_hops"]
    space = bh + mix["min_gap_hops"]
    # starts in [edge, pool - bh - edge]
    slack = pool - bh - 2 * edge - (k - 1) * space
    if k < 1 or slack < 0:
        raise ValueError(f"a pool of {pool} hops holds no {k} bursts of "
                         f"{bh} hops a channel")
    out = []
    for c in control_slots(cfg):
        extra = np.sort(rng.integers(0, slack + 1, k))
        for i in range(k):
            nw = int(rng.integers(2, recc.WORDS + 1))
            words = rng.integers(0, 2, (nw, 36)).astype(np.uint8)
            out.append(Burst(c, edge + int(extra[i]) + i * space, words,
                             mix["dcc"], float(rng.uniform(0, 2 * np.pi))))
    return out


def rx_stream(cfg: dict, mix: dict, seed: int, device) -> RxPool:
    """The ``rx_stream`` pool of a configuration, on ``device``."""
    M, T, sps = cfg["num_channels"], cfg["taps_per_phase"], cfg["chan_sps"]
    P = M // 2
    bursts = place_bursts(cfg, mix, seed)
    H, npool = mix["push_hops"], mix["pool_pushes"]
    nh = H * npool
    h = bank.prototype(M, T)
    sigma = 1.0 / math.sqrt(2 * float(np.sum(h * h))
                            * 10 ** (mix["snr_db"] / 10))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((nh * P, 2), generator=gen, device=device)
    x *= sigma
    sens = 2 * np.pi * cfg["deviation_hz"] / cfg["chan_rate"]
    bb = []
    for b in bursts:
        ph = b.phase + sens * np.cumsum(recc.burst_symbols(b.words, b.dcc,
                                                           sps))
        bb.append(torch.as_tensor(P * np.exp(1j * ph), dtype=torch.complex64,
                                  device=device))
    # synthesis in chunks of an even number of hops, each with the 2T-1
    # hops of history the bank reads; no burst nears the pool's ends, so
    # the history of the first chunk is silent
    step = max(2, ((1 << 23) // M) & ~1)
    hist = 2 * T - 1
    for c0 in range(0, nh, step):
        c1 = min(nh, c0 + step)
        live = [(b, z) for b, z in zip(bursts, bb)
                if b.hop < c1 and b.hop + z.shape[0] > c0 - hist]
        if not live:
            continue
        Y = torch.zeros((c1 - c0 + hist, M), dtype=torch.complex64,
                        device=device)
        for b, z in live:
            a, e = max(b.hop, c0 - hist), min(b.hop + z.shape[0], c1)
            Y[a - (c0 - hist): e - (c0 - hist), b.channel] = \
                z[a - b.hop: e - b.hop]
        xs = bank.synthesize(Y, M, T)
        del Y
        seg = x[c0 * P: c1 * P]
        seg[:, 0] += xs.real
        seg[:, 1] += xs.imag
    return RxPool(x, bursts, M, T, sps, H, npool)


def duplex_pairs(M: int, mix: dict, seed: int) -> np.ndarray:
    """The ``duplex_loop`` pool of word pairs, uint8 bits."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (mix["pool_calls"], M, mix["frames"], 2, 28),
                        dtype=np.uint8)
