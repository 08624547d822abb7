"""Mobile-side FVC decoder: blank-and-burst voice-channel data, the port
of ``amps_tpu.ms.fvc_rx`` (host NumPy; the BCH decode is the port's).

Burst layout (tx/fvc.py, bit-exact with fvc_words_message,
lib/fvc_impl.cc:109-143): per word, dotting(101) + 11 repeats of
[wsync(11) + word(40)] separated by dotting(37), Manchester encoded.
The mobile majority-votes the 11 repeats bit-wise before BCH (553 §2.4's
repeat discipline), so a single decode survives deep per-repeat
corruption.

Word-sync hits recur every 88 bits inside one word's burst and jump 152
bits across word (or wrap) boundaries, so hits are clustered by gap and
each cluster votes separately — a multi-word burst never merges two
codewords into one chimera vote.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from amps_tpu_torch.codec.bch import focc_bch_decode
from amps_tpu_torch.ms.focc_rx import _dump
from amps_tpu_torch.tx.focc import WORD_SYNC

_REPEATS = 11
_WORD_BITS = 40
_HIT_PERIOD = 11 + _WORD_BITS + 37        # 88: ws->ws inside one word
_CLUSTER_GAP = 120                        # between 88 and the 152-bit
                                          # word/wrap boundary jump


def _vote_cluster(words: List[np.ndarray]) -> Optional[np.ndarray]:
    stack = np.stack(words)
    maj = (stack.sum(0) * 2 >= len(stack)).astype(np.uint8)
    dec, ok = focc_bch_decode(torch.as_tensor(maj[None]))
    return dec[0].numpy() if bool(ok[0]) else None


def decode_fvc_words(symbols, sps: int = 1,
                     min_repeats: int = 5) -> List[np.ndarray]:
    """±1 FVC samples -> list of (28,) decoded words, burst order.

    Scans every symbol phase AND both Manchester pair parities (a block
    cut at an odd symbol boundary must still decode); picks the
    alignment that yields the most decoded words (ties: most sync
    hits).  min_repeats guards against voting a truncated burst tail.
    """
    best: Optional[tuple] = None
    for ph in range(sps):
        s_ph = _dump(np.asarray(symbols, np.float32)[ph:], sps)
        for par in (0, 1):
            s = s_ph[par:]
            if len(s) < 2 * (len(WORD_SYNC) + _WORD_BITS):
                continue
            bits = (s[0::2] < 0).astype(np.uint8)
            b = 1.0 - 2.0 * bits.astype(np.float32)
            t = 1.0 - 2.0 * WORD_SYNC.astype(np.float32)
            c = np.correlate(b, t, "valid")
            hits = np.where(c >= len(WORD_SYNC) - 0.5)[0]  # exact matches
            hits = [h for h in hits
                    if h + len(WORD_SYNC) + _WORD_BITS <= len(bits)]
            if len(hits) < min_repeats:
                continue
            # cluster hits by gap: each cluster is one word's repeats.
            # A missed sync inside a burst leaves a gap of k*88; keep
            # such same-phase hits in one cluster (a flat gap threshold
            # would split the word's repeats into two under-voted
            # halves).  Cross-word/wrap jumps are 152+k*88 ≡ 64 (mod 88)
            # so they can never be misclassified as same-word periods.
            clusters: List[List[int]] = [[hits[0]]]
            for h in hits[1:]:
                gap = h - clusters[-1][-1]
                same_word = (gap <= _CLUSTER_GAP
                             or (gap % _HIT_PERIOD == 0
                                 and gap <= (_REPEATS - 1) * _HIT_PERIOD))
                if not same_word:
                    clusters.append([])
                clusters[-1].append(h)
            words = []
            for cl in clusters:
                if len(cl) < min_repeats:
                    continue
                reps = [bits[h + len(WORD_SYNC):
                             h + len(WORD_SYNC) + _WORD_BITS] for h in cl]
                w = _vote_cluster(reps)
                if w is not None:
                    words.append(w)
            cand = (len(words), len(hits), words)
            if best is None or cand[:2] > best[:2]:
                best = cand
    return [] if best is None else best[2]


def decode_fvc_stream(symbols, sps: int = 1,
                      min_repeats: int = 5) -> Optional[np.ndarray]:
    """First decoded word in the block, or None (single-word callers)."""
    words = decode_fvc_words(symbols, sps, min_repeats)
    return words[0] if words else None
