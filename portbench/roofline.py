"""Peaks of the card and the least time of the port's bank kernels.

Peaks are NVIDIA's published H100 SXM figures (dense, no sparsity), at
its full 700 W; a card held to a lower power limit reaches less, so the
run prints the limit beside every share.
"""

from __future__ import annotations

import math

F32_FLOPS = 67e12            # FP32 outside the tensor cores
HBM_BYTES_S = 3.35e12        # HBM3


def bank_bound_s(M: int, T: int, Nh: int, nbytes: int) -> float:
    """Least seconds of one bank pass over Nh hops moving ``nbytes``: an
    M-point FFT a hop (5·M·log2 M flops, the radix-2 count) plus the
    polyphase fold or overlap-add (2·T·M multiply-adds, 4·T·M flops), or
    the bytes at the HBM rate, whichever is longer."""
    flops = Nh * (5 * M * math.log2(M) + 4 * T * M)
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES_S)


def rx_front_bytes(M: int, T: int, Nh: int) -> int:
    """Bytes of ``kernels.rx_front.analyze_demod``'s interface, each
    read or written once: the history-prepended block ((Nh + 2T - 1)·M/2
    samples, 8 bytes each) and the previous sample in; the demod and
    power planes (M·Nh floats each) and the last sample out."""
    n_ext = (Nh + 2 * T - 1) * (M // 2)
    return 8 * n_ext + 8 * M + 2 * 4 * M * Nh + 8 * M


def synth_bytes(M: int, T: int, Nh: int) -> int:
    """Bytes of ``kernels.synth.synthesize_block``'s interface, each read
    or written once: the channel basebands (Nh·M samples, 8 bytes each)
    and the overlap-add carry ((T·M - M/2) samples) in; the wideband
    block (Nh·M/2 samples) and the new carry out."""
    carry = (T * M - M // 2) * 8
    return 8 * Nh * M + carry + 8 * Nh * (M // 2) + carry


def search_work(M: int, sps: int, nsym: int, K: int):
    """(instructions, bytes) the trigger search (K5) needs over M rows of
    ``sps`` phase streams of ``nsym`` bfloat16 symbols with K picks: with
    each pair of neighbouring symbols added as one sum or difference
    (and their squares as one sum), each (row, phase, lag) takes 37 adds
    for the 74-symbol correlation and 37 for the window energy, and each
    symbol 4 more (its square and its pair's sum, difference and sum of
    squares); the phases read once and the K picks (start, valid,
    quality: 9 bytes) written once."""
    ops = M * sps * ((nsym - 73) * 74 + nsym * 4)
    return ops, M * sps * nsym * 2 + M * K * 9


def search_bound_s(M: int, sps: int, nsym: int, K: int) -> float:
    """Least seconds of one trigger search (``search_work``): its adds at
    one instruction each, half the f32 flop rate, or its bytes at the HBM
    rate, whichever is longer."""
    ops, nbytes = search_work(M, sps, nsym, K)
    return max(ops / (F32_FLOPS / 2), nbytes / HBM_BYTES_S)
