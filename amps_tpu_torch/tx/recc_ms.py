"""Mobile-station RECC transmitter (simulator), the PyTorch port of
``amps_tpu.tx.recc_ms`` (host NumPy word builders; the BCH encode and
Manchester coding are the port's).

The reference has no MS side (real phones supply it); the receiver's
expectations define the format: seizure precursor (30 dotting bits +
11-bit word sync, whose tail is the trigger searched at
lib/recc_impl.cc:76-79), 7-bit coded DCC, then up to 7 words, each sent
as 5 repeats of its 48-bit BCH encoding (lib/recc_decode_impl.cc:89-107).
Word field layouts invert the parsers of lib/amps_packet.h:145-274.

Used by the receiver tests, the end-to-end loopback BER benches, and the
multichannel traffic simulator.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from amps_tpu_torch.codec.bch import recc_bch_encode
from amps_tpu_torch.codec.bits import expandbits_np
from amps_tpu_torch.codec.manchester import manchester_encode_symbols
from amps_tpu_torch.control.fields import encode_called_digits, parse_min

# 553 coded-DCC table (2.6.1.2): 2-bit DCC -> 7-bit coded DCC.
CODED_DCC = {
    0: (0, 0, 0, 0, 0, 0, 0),
    1: (0, 0, 1, 1, 1, 0, 0),
    2: (1, 1, 0, 0, 0, 1, 1),
    3: (1, 1, 1, 1, 1, 1, 1),
}

WORD_SYNC = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], dtype=np.uint8)


def ms_word_a(nawc: int, t: bool, s: bool, e: bool, er: bool, scm: int,
              min1: int) -> np.ndarray:
    w = np.zeros(36, dtype=np.uint8)
    w[0] = 1  # F: first word of the message
    w[1:4] = expandbits_np(nawc, 3)
    w[4] = int(t)
    w[5] = int(s)
    w[6] = int(e)
    w[7] = int(er)
    w[8:12] = expandbits_np(scm, 4)
    w[12:36] = expandbits_np(min1, 24)
    return w


def ms_word_b(nawc: int, msg_type: int, ordq: int, order: int, lt: bool,
              ep: bool, scm4: int, mpci: int, sdcc1: int, sdcc2: int,
              min2: int) -> np.ndarray:
    w = np.zeros(36, dtype=np.uint8)
    w[0] = 0
    w[1:4] = expandbits_np(nawc, 3)
    w[4:9] = expandbits_np(msg_type, 5)
    w[9:12] = expandbits_np(ordq, 3)
    w[12:17] = expandbits_np(order, 5)
    w[17] = int(lt)
    w[18] = int(ep)
    w[19] = scm4 & 1
    w[20:22] = expandbits_np(mpci, 2)
    w[22:24] = expandbits_np(sdcc1, 2)
    w[24:26] = expandbits_np(sdcc2, 2)
    w[26:36] = expandbits_np(min2, 10)
    return w


def ms_word_c_serial(nawc: int, serial: int) -> np.ndarray:
    w = np.zeros(36, dtype=np.uint8)
    w[0] = 0
    w[1:4] = expandbits_np(nawc, 3)
    w[4:36] = expandbits_np(serial, 32)
    return w


def ms_word_called(nawc: int, digits: str) -> np.ndarray:
    w = np.zeros(36, dtype=np.uint8)
    w[0] = 0
    w[1:4] = expandbits_np(nawc, 3)
    w[4:36] = expandbits_np(encode_called_digits(digits), 32)
    return w


def page_response_words(min_str: str, scm: int = 0) -> List[np.ndarray]:
    """T=0 response (page response): words A+B (handled at
    lib/recc_decode_impl.cc:121,195)."""
    min1, min2 = parse_min(min_str)
    return [
        ms_word_a(nawc=1, t=False, s=False, e=True, er=False, scm=scm,
                  min1=min1),
        ms_word_b(nawc=0, msg_type=0, ordq=0, order=0, lt=False, ep=False,
                  scm4=0, mpci=0, sdcc1=0, sdcc2=0, min2=min2),
    ]


def registration_words(min_str: str, esn: Optional[int] = None,
                       scm: int = 0) -> List[np.ndarray]:
    """T=1 registration order (ORDER=0xd), optionally with serial word C
    (lib/recc_decode_impl.cc:123-138)."""
    min1, min2 = parse_min(min_str)
    s = esn is not None
    nawc = 3 if s else 1
    out = [
        ms_word_a(nawc=nawc, t=True, s=s, e=True, er=False, scm=scm,
                  min1=min1),
        ms_word_b(nawc=nawc - 1, msg_type=0, ordq=0, order=0xD, lt=False,
                  ep=False, scm4=0, mpci=0, sdcc1=0, sdcc2=0, min2=min2),
    ]
    if s:
        out.append(ms_word_c_serial(nawc=nawc - 2, serial=esn))
    return out


def origination_words(min_str: str, dialed: str, esn: Optional[int] = None,
                      scm: int = 0) -> List[np.ndarray]:
    """T=1 origination with called-address words
    (lib/recc_decode_impl.cc:139-165)."""
    min1, min2 = parse_min(min_str)
    s = esn is not None
    ncalled = max(1, -(-len(dialed) // 8))
    assert ncalled <= 4
    # The reference's origination loop (lib/recc_decode_impl.cc:141-164)
    # reads worda.NAWC called words when S=0 and NAWC-2 when S=1 (word B
    # is not counted against NAWC in its arithmetic); encode to match.
    nawc = ncalled + (2 if s else 0)
    out = [
        ms_word_a(nawc=nawc, t=True, s=s, e=True, er=False, scm=scm,
                  min1=min1),
        ms_word_b(nawc=nawc - 1, msg_type=0, ordq=0, order=0, lt=False,
                  ep=False, scm4=0, mpci=0, sdcc1=0, sdcc2=0, min2=min2),
    ]
    remaining = nawc - 1
    if s:
        remaining -= 1
        out.append(ms_word_c_serial(nawc=remaining, serial=esn))
    for i in range(ncalled):
        remaining -= 1
        out.append(ms_word_called(nawc=remaining, digits=dialed[8 * i: 8 * i + 8]))
    return out


def burst_bits(words36: Sequence[np.ndarray], dcc: int = 0) -> np.ndarray:
    """Full RECC seizure burst bit stream: dotting(30) + wsync(11) +
    coded DCC(7) + 5 repeats per word; unused word slots padded with
    dotting so the receiver's fixed 3374-symbol capture is well-defined."""
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
    """±1 symbol samples of the burst at sps samples per half-symbol."""
    return manchester_encode_symbols(
        torch.as_tensor(burst_bits(words36, dcc)), sps).numpy()
