"""FVC blank-and-burst transmitter, the PyTorch port of
``amps_tpu.tx.fvc``.

Burst layout per fvc_words_message (lib/fvc_impl.cc:109-143): per 28-bit
word, 101-bit dotting, then 11 repeats of [11-bit word sync + 40-bit BCH
word] with 37-bit dotting between repeats = 1032 bits/word.  The burst
repeats forever until replaced; an optional repeat counter ("timerhack",
lib/fvc_impl.cc:163-171) fires a self-terminating "fvc off" command.

The burst is a direct index gather (``_BURST_SRC``) of the message
vector, like the FOCC frame; idle output is explicit zero-fill.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from amps_tpu_torch.codec.bch import focc_bch_encode
from amps_tpu_torch.codec.manchester import manchester_encode_symbols

BIGDOT = np.array(([1, 0] * 50) + [1], dtype=np.uint8)     # 101 bits
SMALLDOT = np.array(([1, 0] * 18) + [1], dtype=np.uint8)   # 37 bits
WORD_SYNC = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], dtype=np.uint8)
BURST_BITS = 101 + 11 * (11 + 40) + 10 * 37  # 1032


def _burst_gather_indices() -> np.ndarray:
    """(1032,) map into [bigdot(101)|ws(11)|smalldot(37)|word(40)]."""
    src: List[int] = []
    src.extend(range(0, 101))                      # bigdot
    for j in range(11):
        src.extend(range(101, 112))                # word sync
        src.extend(range(149, 189))                # coded word
        if j < 10:
            src.extend(range(112, 149))            # smalldot
    out = np.array(src, dtype=np.int64)
    assert out.shape == (BURST_BITS,)
    return out


_BURST_SRC = _burst_gather_indices()
_HEAD = np.concatenate([BIGDOT, WORD_SYNC, SMALLDOT])      # message[:149]


def fvc_burst_symbols(words28, sps: int):
    """(..., n, 28) words -> (..., n*1032*2*sps) ±1 int8 burst samples,
    on the input's device."""
    coded = focc_bch_encode(torch.as_tensor(words28).to(torch.uint8))
    head = torch.as_tensor(_HEAD, device=coded.device)
    msg = torch.cat([head.expand(coded.shape[:-1] + (149,)), coded],
                    dim=-1)                        # (..., n, 189)
    bits = msg[..., torch.as_tensor(_BURST_SRC, device=coded.device)]
    return manchester_encode_symbols(bits.reshape(bits.shape[:-2] + (-1,)),
                                     sps)


class FvcStream:
    """Host-side FVC burst state: current burst repeats until replaced.

    ``set_words`` mirrors fvc_words_message; ``next_block`` yields symbol
    blocks, decrementing the repeat timer at each burst boundary and firing
    ``on_command("fvc off")`` when it expires (the reference's timerhack
    self-timeout, measured in burst repetitions not seconds).
    """

    def __init__(self, sps: int = 5,
                 on_command: Optional[Callable[[str], None]] = None):
        self.sps = sps
        self.on_command = on_command or (lambda cmd: None)
        self._lock = threading.Lock()
        self._burst: Optional[np.ndarray] = None
        self._timer = 0
        self._off = 0

    def set_words(self, words28, timer: int = 0) -> None:
        words = np.asarray(words28, dtype=np.uint8)
        if words.ndim == 1:
            words = words[None]
        syms = fvc_burst_symbols(torch.as_tensor(words), self.sps).numpy()
        with self._lock:
            self._burst = syms
            self._timer = timer
            self._off = 0

    def clear(self) -> None:
        with self._lock:
            self._burst = None
            self._timer = 0
            self._off = 0

    def next_block(self, n: int) -> np.ndarray:
        """Next n ±1 samples of the repeating burst (0-fill when idle)."""
        out = np.zeros(n, dtype=np.int8)
        fire = False
        with self._lock:
            if self._burst is None:
                return out
            filled = 0
            while filled < n:
                take = min(n - filled, len(self._burst) - self._off)
                out[filled:filled + take] = \
                    self._burst[self._off:self._off + take]
                self._off += take
                filled += take
                if self._off == len(self._burst):
                    self._off = 0
                    if self._timer >= 1:
                        self._timer -= 1
                        if self._timer == 0:
                            fire = True
        # fire outside the lock: the command handler may call back into
        # set_words/clear (which take the lock)
        if fire:
            self.on_command("fvc off")
        return out
