"""The reference's RECC burst format and receiver back end, in float64
and numpy (TIA/EIA-553-A §2.7.1, the reverse control channel).

A burst is 30 dotting bits (1010...), the 11-bit word sync 11100010010,
the 7-bit coded DCC, then each word's BCH(48, 36) codeword sent five
times, unused word slots of the seven filled with dotting.  Bits go out
Manchester coded (0 -> +1 -1, 1 -> -1 +1), each half-symbol ``sps``
channel samples, and FSK modulated.

Receiving a channel's discriminator output d (samples):

* trigger search: the 74-symbol trigger (26 dotting bits and the word
  sync) against the integrate-and-dump symbols s_u[i] = mean(d[u + 3i :
  u + 3i + 3]) at every sample offset u; the quality is the smaller of
  the normalised correlations of the whole trigger and of its word-sync
  tail, and the capture starts 74 symbols after the best u;
* capture: 3374 symbols from the start, sliced against the mean of the
  first 494 (DCC and the first word, DC-free);
* gates: quality at least the receiver's threshold, at most 6 of the 74
  trigger symbols mis-sliced (against their own mean), band power over
  the capture at least ``min_rssi``, the first word decoded;
* decode: each word's five repeats, a repeat with more than 6 Manchester
  violations an erasure; a bitwise vote of the eligible repeats (weights
  1 + 2^-(r+3), ties to the earlier), BCH-decoded, else the first
  eligible repeat that decodes; the DCC the nearest coded DCC.

The BCH code is the (63, 51) code of generator x^12 + x^10 + x^8 + x^5
+ x^4 + x^3 + 1, shortened: a word is decoded as the 63-bit word with 15
leading zeros, corrected when its syndrome is that of one or two bit
errors anywhere in the 63 (errors in the zero prefix flip nothing).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

GEN = 0b1010100111001               # x^12+x^10+x^8+x^5+x^4+x^3+1
WORD_SYNC = (1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0)
CODED_DCC = ((0, 0, 0, 0, 0, 0, 0), (0, 0, 1, 1, 1, 0, 0),
             (1, 1, 0, 0, 0, 1, 1), (1, 1, 1, 1, 1, 1, 1))
TRIGGER_BITS = (1, 0) * 13 + WORD_SYNC
TRIGGER = 74                        # symbols
WS_OFF = 52                         # the word-sync tail's first symbol
CAPTURE = 3374                      # symbols: DCC 7 bits + 7 x 5 x 48
DC_SYMBOLS = 494
MAX_TRIGGER_ERRORS = 6
REPEAT_GATE = 6
WORDS, REPEATS = 7, 5


def manchester(bits) -> np.ndarray:
    """±1 symbols of 0/1 bits, one a half-symbol."""
    b = np.asarray(bits, np.int64)
    first = np.where(b == 0, 1, -1)
    return np.stack([first, -first], axis=-1).reshape(*b.shape[:-1], -1)


TEMPLATE = manchester(TRIGGER_BITS).astype(np.float64)


def _rem(value: int, nbits: int) -> int:
    """Remainder mod GEN of a polynomial given as an nbits-bit integer."""
    for i in range(nbits - 1, 11, -1):
        if value >> i & 1:
            value ^= GEN << (i - 12)
    return value


def bch_encode(info) -> np.ndarray:
    """(36,) info bits -> (48,) codeword: info, then the remainder of
    info(x)·x^12 mod GEN."""
    v = int("".join(str(int(b)) for b in info), 2)
    par = _rem(v << 12, 48)
    return np.array(list(info) + [par >> (11 - i) & 1 for i in range(12)],
                    np.uint8)


@functools.cache
def _error_table():
    """{syndrome: error positions} of every pattern of one or two bit
    errors in a 63-bit word (position 0 the highest power)."""
    single = [_rem(1 << (62 - p), 63) for p in range(63)]
    tab = {0: ()}
    for p in range(63):
        tab[single[p]] = (p,)
    for p in range(63):
        for q in range(p + 1, 63):
            tab[single[p] ^ single[q]] = (p, q)
    return tab


def bch_decode(rx48):
    """(info36 uint8, ok) of 48 received bits."""
    rx = np.asarray(rx48, np.uint8).copy()
    v = int("".join(str(int(b)) for b in rx), 2)
    err = _error_table().get(_rem(v, 63))
    if err is None:
        return rx[:36], False
    for p in err:
        if p >= 15:
            rx[p - 15] ^= 1
    return rx[:36], True


def burst_bits(words, dcc: int = 0) -> np.ndarray:
    """The burst's bit stream: dotting, word sync, coded DCC, each
    word's codeword five times, dotting for the unused slots."""
    if len(words) > WORDS:
        raise ValueError("a RECC burst carries at most 7 words")
    parts = [np.tile([1, 0], 15), WORD_SYNC, CODED_DCC[dcc]]
    parts += [np.tile(bch_encode(w), REPEATS) for w in words]
    parts.append(np.tile([1, 0], 120 * (WORDS - len(words))))
    return np.concatenate([np.asarray(p, np.uint8) for p in parts])


def burst_symbols(words, dcc: int, sps: int) -> np.ndarray:
    """±1 channel samples of the burst, ``sps`` a half-symbol."""
    return np.repeat(manchester(burst_bits(words, dcc)), sps)


def symbols_at(d: torch.Tensor, start: int, n: int, sps: int):
    """n integrate-and-dump symbols of d from sample ``start``."""
    return d[start: start + n * sps].reshape(n, sps).mean(dim=-1)


def trigger_quality(d: torch.Tensor, sps: int):
    """Quality of the trigger at every sample offset u of d (n - 74·sps
    + 1 values, float64)."""
    n = d.shape[-1] - TRIGGER * sps + 1
    # sym[u, i] = mean(d[u + i·sps : u + (i+1)·sps])
    c = torch.cat([d.new_zeros(1), torch.cumsum(d, 0)])
    mean = (c[sps:] - c[:-sps]) / sps                     # mean from u
    idx = torch.arange(n, device=d.device)[:, None] + \
        sps * torch.arange(TRIGGER, device=d.device)[None, :]
    s = mean[idx]                                         # (n, 74)
    tm = torch.as_tensor(TEMPLATE, device=d.device)

    def q(a, b):
        part = s[:, a:b]
        den = torch.sqrt(torch.clamp((part * part).sum(-1), min=1e-9)) * \
            float(np.sqrt((TEMPLATE[a:b] ** 2).sum()))
        return (part * tm[a:b]).sum(-1) / den

    return torch.minimum(q(0, TRIGGER), q(WS_OFF, TRIGGER))


def decode_capture(soft: np.ndarray, lead: np.ndarray):
    """Report fields of one capture: (words (7, 36) uint8, word_ok (7,)
    bool, dcc int, trigger errors int)."""
    hard = (soft >= soft[:DC_SYMBOLS].mean()).astype(np.int64)
    lead_hard = lead >= lead.mean()
    trig_err = int(np.sum(lead_hard != (TEMPLATE > 0)))
    dcc_bits = 1 - hard[0:14:2]
    dist = [int(np.sum(np.abs(np.array(c) - dcc_bits))) for c in CODED_DCC]
    dcc = int(np.argmin(dist))
    words = np.zeros((WORDS, 36), np.uint8)
    ok = np.zeros(WORDS, bool)
    tie = 1.0 + 0.125 / 2.0 ** np.arange(REPEATS)
    for w in range(WORDS):
        reps = hard[14 + 480 * w: 14 + 480 * (w + 1)].reshape(REPEATS, 96)
        bad = np.sum(reps[:, 0::2] == reps[:, 1::2], axis=1)
        elig = bad <= REPEAT_GATE
        bits = 1 - reps[:, 0::2]                          # (5, 48)
        dec = [bch_decode(b) for b in bits]
        good = [dec[r][1] and elig[r] for r in range(REPEATS)]
        first = good.index(True) if any(good) else 0
        first_word = dec[first][0]
        wt = elig * tie
        vote = (wt[:, None] * bits).sum(0)
        maj = (2 * vote > wt.sum()).astype(np.uint8)
        mdec, mok = bch_decode(maj)
        mok = mok and bool(elig.any())
        words[w] = mdec if mok else first_word
        ok[w] = mok or any(good)
    return words, ok, dcc, trig_err


def receive(d: torch.Tensor, pw: torch.Tensor, lo: int, hi: int, sps: int,
            threshold: float, min_rssi: float):
    """The burst whose trigger starts in d[lo:hi], by the best trigger
    quality there: a dict with start (the first capture sample), quality,
    words, word_ok, dcc, trigger errors, rssi and ``reported`` (every
    gate passed).  d and pw must run 3374·sps samples past hi + 222."""
    q = trigger_quality(d[lo: hi + TRIGGER * sps - 1], sps)
    u = lo + int(torch.argmax(q))
    start = u + TRIGGER * sps
    soft = symbols_at(d, start, CAPTURE, sps).cpu().numpy()
    lead = symbols_at(d, u, TRIGGER, sps).cpu().numpy()
    words, ok, dcc, trig_err = decode_capture(soft, lead)
    rssi = float(torch.sqrt(pw[start: start + CAPTURE * sps].mean()))
    quality = float(q.max())
    reported = (quality >= threshold and trig_err <= MAX_TRIGGER_ERRORS
                and rssi >= min_rssi and bool(ok[0]))
    return dict(start=start, quality=quality, words=words, word_ok=ok,
                dcc=dcc, trigger_errors=trig_err, rssi=rssi,
                reported=reported)
