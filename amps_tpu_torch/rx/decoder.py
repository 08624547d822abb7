"""RECC burst decoding: Manchester + 5-repeat BCH word decode, batched —
the PyTorch port of ``amps_tpu.rx.decoder.decode_bursts``.

A 3374-symbol capture is DCC (7 bits Manchester = 14 symbols) + 7 words
x 5 repeats x 48 coded bits (x2 symbols).  All 35 repeat syndromes come
from one (480, 60) matmul per word (bit b = 1 - s[2b], syndromes are
linear), index the packed syndrome LUT directly, and one repeat per
word is selected by policy:

* ``first_ok``  — first repeat whose decode succeeds (reference order);
* ``majority``  — bit-wise vote across repeats before BCH, falling back
  to first_ok when the voted word fails BCH.

``repeat_gate`` marks a repeat with more than that many Manchester
violations (of 48 pairs) as an erasure: it is excluded from selection
and from the vote.  With the gate, vote ties among an even number of
eligible repeats break toward earlier repeats through the weights
1 + 2^-(r+3), which are exact in bfloat16.  All counts are small
integers, exact in f32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from amps_tpu_torch.codec.bch import (apply_error_pattern, lut_lookup,
                                      recc_bch_decode, recc_syndrome_matrix)
from amps_tpu_torch.codec.bits import packbits

NUM_WORDS = 7
NUM_REPEATS = 5
WORD_CODED_BITS = 48
DCC_BITS = 7
WORD_SYMBOLS = 2 * NUM_REPEATS * WORD_CODED_BITS      # 480
CAPTURE_SYMBOLS = 2 * DCC_BITS + NUM_WORDS * WORD_SYMBOLS  # 3374


class DecodedBurst(NamedTuple):
    dcc_bits: torch.Tensor      # (..., 7) uint8
    words: torch.Tensor         # (..., 7, 36) uint8 corrected info bits
    word_ok: torch.Tensor       # (..., 7) bool — any repeat decodable
    repeat_used: torch.Tensor   # (..., 7) int32 — repeat selected, -1 = vote
    bad_symbols: torch.Tensor   # (..., 8) int32 Manchester bad counts
                                # (DCC + 7 words)


@functools.cache
def _word_syndrome_op():
    """(480, 60) W and (60,) c: per-word symbols -> all 5 repeats'
    12-bit syndromes as (c - s_word @ W) mod 2."""
    H = recc_syndrome_matrix().astype(np.float32)     # (48, 12)
    W = np.zeros((WORD_SYMBOLS, NUM_REPEATS * 12), np.float32)
    for r in range(NUM_REPEATS):
        for i in range(WORD_CODED_BITS):
            W[2 * (WORD_CODED_BITS * r + i), 12 * r: 12 * (r + 1)] = H[i]
    c = np.tile(H.sum(axis=0), NUM_REPEATS)           # (60,)
    return W, c


@functools.cache
def _decode_ops(device):
    """Device copies of the syndrome operator W, its offset c and the
    majority tie-break weights 1 + 2^-(r+3)."""
    W, c = _word_syndrome_op()
    tie = (1.0 + 0.125 / 2.0 ** np.arange(NUM_REPEATS)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (W, c, tie))


def _pair_bad(sym_f, n_sym: int):
    """Count Manchester pairs whose halves agree over the last axis
    (..., n_sym) of 0/1 f32 symbols."""
    pairs = sym_f[..., :n_sym].reshape(sym_f.shape[:-1] + (n_sym // 2, 2))
    return torch.sum(pairs[..., 0] == pairs[..., 1], dim=-1,
                     dtype=torch.int32)


def decode_bursts(symbols, policy: str = "first_ok",
                  repeat_gate: int | None = None) -> DecodedBurst:
    """Decode (..., 3374) sliced 0/1 RECC captures (any dtype)."""
    s = torch.as_tensor(symbols).to(torch.float32)
    dev = s.device
    batch = s.shape[:-1]
    sw = s[..., 2 * DCC_BITS:].reshape(batch + (NUM_WORDS, WORD_SYMBOLS))

    W, c, tie = _decode_ops(dev)
    raw = sw @ W                                              # (..., 7, 60)
    syn = torch.remainder(c - raw, 2.0)
    syn = syn.reshape(batch + (NUM_WORDS, NUM_REPEATS, 12)).to(torch.int32)
    g = lut_lookup(packbits(syn), 48)                         # (..., 7, 5)

    swr = sw.reshape(batch + (NUM_WORDS, NUM_REPEATS, 2 * WORD_CODED_BITS))
    rep_bad = _pair_bad(swr, 2 * WORD_CODED_BITS)             # (..., 7, 5)
    elig = None if repeat_gate is None else rep_bad <= int(repeat_gate)

    ok = (g & (1 << 16)) != 0
    if elig is not None:
        ok = ok & elig
    first_idx = torch.argmax(ok.to(torch.int32), dim=-1)      # first True
    any_ok = torch.any(ok, dim=-1)
    g_sel = torch.gather(g, -1, first_idx[..., None])[..., 0]
    rep_sym = torch.gather(
        swr, -2, first_idx[..., None, None].expand(
            batch + (NUM_WORDS, 1, 2 * WORD_CODED_BITS)))[..., 0, :]
    rep_bits = (1.0 - rep_sym[..., 0::2]).to(torch.uint8)     # (..., 7, 48)
    first_words = apply_error_pattern(rep_bits, g_sel, 36)
    first_idx = first_idx.to(torch.int32)

    if policy == "first_ok":
        words, used, wok = first_words, first_idx, any_ok
    elif policy == "majority":
        if elig is None:
            ssum = torch.sum(swr, dim=-2)                     # (..., 7, 96)
            votes = NUM_REPEATS - ssum[..., 0::2]
            nvote = float(NUM_REPEATS)
        else:
            w_el = elig.to(torch.float32) * tie               # (..., 7, 5)
            ssum = torch.sum(w_el[..., None] * swr, dim=-2)
            n_el = torch.sum(elig, dim=-1)
            wsum = torch.sum(w_el, dim=-1)[..., None]
            votes = (wsum - ssum)[..., 0::2]
            nvote = wsum
        maj = (votes * 2 > nvote).to(torch.uint8)
        mdec, mok = recc_bch_decode(maj)
        if elig is not None:
            mok = mok & (n_el > 0)
        words = torch.where(mok[..., None], mdec, first_words)
        used = torch.where(mok, torch.full_like(first_idx, -1), first_idx)
        wok = mok | any_ok
    else:
        raise ValueError(f"unknown repeat policy {policy!r}")

    dcc_bits = (1.0 - s[..., 0: 2 * DCC_BITS: 2]).to(torch.uint8)
    dcc_bad = _pair_bad(s[..., : 2 * DCC_BITS], 2 * DCC_BITS)
    word_bad = torch.sum(rep_bad, dim=-1, dtype=torch.int32)
    bad = torch.cat([dcc_bad[..., None], word_bad], dim=-1)
    return DecodedBurst(dcc_bits, words, wok, used, bad)


def decode_burst(symbols, policy: str = "first_ok",
                 repeat_gate: int | None = None) -> DecodedBurst:
    """Single-capture form of ``decode_bursts``."""
    return decode_bursts(symbols, policy, repeat_gate)
