"""The reference's FOCC frames (TIA/EIA-553-A §3.7.1, the forward control
channel), in numpy.

A 463-bit frame: a busy/idle bit, 10 dotting bits (1010...), a busy/idle
bit, the 11-bit word sync 11100010010, then word A and word B five times
each, alternating A B A B ..., every word its BCH(40, 28) codeword cut
into four chunks of ten bits, each chunk after a busy/idle bit.  The
code is the (63, 51) BCH code of ``recc.GEN`` shortened to 40 bits.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import recc

FRAME_BITS = 463


def bch40_encode(info) -> np.ndarray:
    """(..., 28) info bits -> (..., 40) codewords: info, then the
    remainder of info(x)·x^12 mod GEN (row i of the parity matrix the
    remainder of x^(39-i))."""
    info = np.asarray(info, np.uint8)
    rem = [recc._rem(1 << (39 - i), 40) for i in range(28)]
    P = np.array([[r >> (11 - j) & 1 for j in range(12)] for r in rem],
                 np.int64)
    par = (info.astype(np.int64) @ P) % 2
    return np.concatenate([info, par.astype(np.uint8)], axis=-1)


def frame_bits(word_pairs, busy_idle: int = 1) -> np.ndarray:
    """(..., F, 2, 28) word pairs -> (..., F·463) frame bits."""
    coded = bch40_encode(word_pairs)                     # (..., F, 2, 40)
    bi = np.full(coded.shape[:-2] + (1,), busy_idle, np.uint8)

    def const(bits):
        return np.broadcast_to(np.asarray(bits, np.uint8),
                               coded.shape[:-2] + (len(bits),))

    parts = [bi, const([1, 0] * 5), bi, const(recc.WORD_SYNC)]
    for _ in range(5):
        for w in range(2):
            for c in range(4):
                parts += [bi, coded[..., w, 10 * c: 10 * c + 10]]
    frames = np.concatenate(parts, axis=-1)              # (..., F, 463)
    return frames.reshape(frames.shape[:-2] + (-1,))


def baseband(word_pairs, sps: int, sensitivity: float,
             busy_idle: int = 1) -> np.ndarray:
    """(..., n) complex128 FSK baseband of the frames: phase =
    sensitivity · cumsum of the Manchester symbols, ``sps`` samples a
    half-symbol, from phase 0."""
    sym = np.repeat(recc.manchester(frame_bits(word_pairs, busy_idle)), sps,
                    axis=-1)
    return np.exp(1j * sensitivity * np.cumsum(sym, axis=-1))
