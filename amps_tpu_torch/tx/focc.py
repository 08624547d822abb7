"""FOCC superframe synthesis, the PyTorch port of ``amps_tpu.tx.focc``.

A 463-bit FOCC frame interleaves a busy/idle bit before the dotting, the
word sync and every 10-bit chunk of the 5x repeated (A, B) coded word
pair.  The interleave is a precomputed gather pattern (``_FRAME_SRC``),
so a superframe -- or a batch of them across channels -- is one BCH
matmul and one index gather.  The JAX package computed the gather as a
one-hot bf16 matmul, because a TPU gather is a chain of scalar loads;
the bits are identical.

``FoccStream`` is the host-side word queue: queued message frames
replace filler slots of the next superframe's (F, 2, 28) word array.
"""

from __future__ import annotations

import collections
import functools
import threading
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from amps_tpu_torch.codec import words as W
from amps_tpu_torch.codec.bch import focc_bch_encode
from amps_tpu_torch.codec.manchester import manchester_encode_symbols
from amps_tpu_torch.config import SystemConfig
from amps_tpu_torch.utils.logging import log_warning

DOTTING = np.array([1, 0, 1, 0, 1, 0, 1, 0, 1, 0], dtype=np.uint8)
WORD_SYNC = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], dtype=np.uint8)
FRAME_BITS = 463
FRAMES_PER_SUPERFRAME = 18

# streams of a queued word
STREAM_A = 1
STREAM_B = 2
STREAM_BOTH = 3


def _frame_gather_indices() -> np.ndarray:
    """(463,) map: frame bit -> index into the 101-bit message vector
    [dotting(10) | word sync(11) | A(40) | B(40)], or -1 for a busy/idle
    bit."""
    src: List[int] = [-1, *range(0, 10), -1, *range(10, 21)]
    for _ in range(5):
        for base in (21, 61):           # word A, word B
            for c in range(4):
                src.append(-1)
                src.extend(range(base + c * 10, base + c * 10 + 10))
    out = np.array(src, dtype=np.int32)
    assert out.shape == (FRAME_BITS,)
    return out


_FRAME_SRC = _frame_gather_indices()


def focc_frame_bits(word_pairs, busy_idle: int = 1):
    """Frame bits before Manchester: (..., F, 2, 28) words ->
    (..., F*463) uint8, on the input's device."""
    wp = torch.as_tensor(word_pairs).to(torch.uint8)
    coded = focc_bch_encode(wp)                       # (..., F, 2, 40)
    batch = coded.shape[:-2]
    head = torch.as_tensor(np.concatenate([DOTTING, WORD_SYNC]),
                           device=coded.device)
    msg = torch.cat([head.expand(batch + (21,)), coded[..., 0, :],
                     coded[..., 1, :]], dim=-1)       # (..., F, 101)
    src = torch.as_tensor(_FRAME_SRC, device=coded.device).to(torch.int64)
    frame = torch.where(src >= 0, msg[..., src.clamp(min=0)],
                        torch.tensor(int(busy_idle), dtype=torch.uint8,
                                     device=coded.device))
    return frame.reshape(batch[:-1] + (-1,))


def focc_frames_symbols(word_pairs, sps: int, busy_idle: int = 1):
    """(..., F, 2, 28) word pairs -> (..., F*463*2*sps) ±1 int8 symbol
    samples of the FOCC frames."""
    return manchester_encode_symbols(focc_frame_bits(word_pairs, busy_idle),
                                     sps)


def _pairs(rows) -> np.ndarray:
    return np.stack([np.stack([r.numpy()] * 2) for r in rows])


def superframe_word_pairs(system: Optional[SystemConfig] = None) -> np.ndarray:
    """(18, 2, 28) word pairs of the steady-state superframe: OHW1, OHW2,
    access type, registration ID (end), 14 fillers.  A == B in every
    frame."""
    sc = system or SystemConfig()
    rows = [
        W.overhead_word_1(sc.dcc, sc.sid, True, False, False, 3),
        W.overhead_word_2(sc.dcc, 1, 1, 1, 1, 0, 23, 1, 1, 23, 0),
        W.access_type_parameters_global_action(sc.dcc, False),
        W.registration_id(sc.dcc, 0, True),
    ] + [W.control_filler_word()] * 14
    return _pairs(rows)


def registration_superframe_word_pairs(
        system: Optional[SystemConfig] = None) -> np.ndarray:
    """(38, 2, 28) aggressive-registration superframe."""
    sc = system or SystemConfig()

    def half(regid):
        return [
            W.overhead_word_1(sc.dcc, sc.sid, True, False, False, 4),
            W.overhead_word_2(sc.dcc, 1, 1, 1, 1, 0, 23, 1, 1, 23, 0),
            W.access_type_parameters_global_action(sc.dcc, False),
            W.registration_increment_global_action(sc.dcc, sc.regincr,
                                                   False),
            W.registration_id(sc.dcc, regid, True),
        ] + [W.control_filler_word()] * 14

    return _pairs(half(0) + half(500))


def symbols_from_bitfile(path: str, sps: int = 1) -> np.ndarray:
    """Read '0'/'1' characters (or raw 0/1 bytes) from ``path`` and
    return the Manchester-coded ±1 int8 symbol stream at ``sps`` samples
    per half-symbol.  Other bytes are skipped with a logged count."""
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(), dtype=np.uint8)
    bits = np.where((raw == 1) | (raw == ord("1")), 1,
                    np.where((raw == 0) | (raw == ord("0")), 0, -1))
    invalid = int(np.sum(bits < 0))
    if invalid:
        log_warning("symbols_from_bitfile: %d invalid bytes skipped",
                    invalid)
    bits = bits[bits >= 0].astype(np.uint8)
    return manchester_encode_symbols(torch.as_tensor(bits), sps).numpy()


@functools.cache
def _stream_template(system: SystemConfig) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """A stream's superframe template (read-only) and its filler slots,
    built once a system: a transmitter of M control channels makes M
    streams (about 1.5 ms each to build on the host)."""
    if system.aggressive_registration:
        template = registration_superframe_word_pairs(system)
    else:
        template = superframe_word_pairs(system)
    template.setflags(write=False)
    return template, tuple(
        i for i in range(template.shape[0])
        if np.array_equal(template[i, 0], W.CONTROL_FILLER))


class FoccStream:
    """Host-side FOCC word queue and superframe producer.

    Queued (stream, word28) messages become message frames that replace
    filler slots of the next superframe; ``repeats`` > 1 re-sends them
    once per later superframe.  Thread-safe.  ``debug_sink``: append the
    emitted ±1 symbol stream (int8 bytes) to this file, capped at
    ``debug_limit`` samples."""

    def __init__(self, system: Optional[SystemConfig] = None, sps: int = 5,
                 debug_sink: Optional[str] = None,
                 debug_limit: int = 500000):
        self.system = system or SystemConfig()
        self.sps = sps
        self._template, slots = _stream_template(self.system)
        self._filler_slots = list(slots)
        self._queue: collections.deque = collections.deque()
        # (remaining repeats, pair), re-queued one per later superframe
        self._deferred: List = []
        self._busy_superframes = 0
        self._lock = threading.Lock()
        self._debug = open(debug_sink, "ab") if debug_sink else None
        self._debug_left = debug_limit

    @property
    def frames_per_superframe(self) -> int:
        return self._template.shape[0]

    def push_words(self, stream: int, words28: Iterable,
                   repeats: int = 1) -> None:
        """Queue mobile-control words: each word becomes one frame,
        paired with filler on the unused stream."""
        filler = W.CONTROL_FILLER
        with self._lock:
            for word in words28:
                word = np.asarray(word, dtype=np.uint8)
                if word.shape != (28,):
                    raise ValueError(f"word of shape {word.shape}, not (28,)")
                if stream == STREAM_A:
                    pair = np.stack([word, filler])
                elif stream == STREAM_B:
                    pair = np.stack([filler, word])
                elif stream == STREAM_BOTH:
                    pair = np.stack([word, word])
                else:
                    raise ValueError(f"invalid stream {stream}")
                self._queue.append(pair)
                if repeats > 1:
                    self._deferred.append((repeats - 1, pair))

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def next_word_pairs(self) -> np.ndarray:
        """The (F, 2, 28) word array of the next superframe: the template
        with filler slots replaced by queued message frames, in order."""
        out = self._template.copy()
        with self._lock:
            for slot in self._filler_slots:
                if not self._queue:
                    break
                out[slot] = self._queue.popleft()
            nxt = []
            for n, pair in self._deferred:
                self._queue.append(pair)
                if n > 1:
                    nxt.append((n - 1, pair))
            self._deferred = nxt
        return out

    def mark_busy(self, superframes: int = 1) -> None:
        """Busy/idle bits read BUSY for the next N superframes."""
        with self._lock:
            self._busy_superframes = max(self._busy_superframes,
                                         int(superframes))

    def next_superframe_symbols(self) -> torch.Tensor:
        """±1 int8 symbol samples of the next superframe."""
        with self._lock:
            busy = self._busy_superframes > 0
            if busy:
                self._busy_superframes -= 1
        syms = focc_frames_symbols(self.next_word_pairs(), self.sps,
                                   busy_idle=0 if busy else 1)
        if self._debug is not None and self._debug_left > 0:
            chunk = syms.numpy().astype(np.int8)[: self._debug_left]
            self._debug.write(chunk.tobytes())
            self._debug.flush()
            self._debug_left -= chunk.size
        return syms

    def close(self) -> None:
        """Close the debug sink.  Idempotent."""
        if self._debug is not None:
            self._debug.close()
            self._debug = None
