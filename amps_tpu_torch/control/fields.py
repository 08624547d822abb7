"""Host-side (pure NumPy) RECC word field extraction + MIN/digit codecs,
the port's copy of ``amps_tpu.control.fields``.

These run in the control plane on decoded 36-bit words coming off the
device (no jnp dispatch on the host hot path).  Layouts per
lib/amps_packet.h:145-274; MIN codec per :277-363 (553 §2.3.1.1).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _val(bits, start: int, n: int) -> int:
    out = 0
    for b in bits[start:start + n]:
        out = (out << 1) | int(b & 1)
    return out


@dataclasses.dataclass(frozen=True)
class RxWordA:
    F: bool
    NAWC: int
    T: bool
    S: bool
    E: bool
    ER: bool
    SCM: int
    MIN1: int

    @classmethod
    def parse(cls, bits) -> "RxWordA":
        b = np.asarray(bits)
        return cls(bool(b[0] & 1), _val(b, 1, 3), bool(b[4] & 1),
                   bool(b[5] & 1), bool(b[6] & 1), bool(b[7] & 1),
                   _val(b, 8, 4), _val(b, 12, 24))


@dataclasses.dataclass(frozen=True)
class RxWordB:
    F: bool
    NAWC: int
    MSG_TYPE: int
    ORDQ: int
    ORDER: int
    LT: bool
    EP: bool
    SCM4: int
    MPCI: int
    SDCC1: int
    SDCC2: int
    MIN2: int

    @classmethod
    def parse(cls, bits) -> "RxWordB":
        b = np.asarray(bits)
        return cls(bool(b[0] & 1), _val(b, 1, 3), _val(b, 4, 5),
                   _val(b, 9, 3), _val(b, 12, 5), bool(b[17] & 1),
                   bool(b[18] & 1), int(b[19] & 1), _val(b, 20, 2),
                   _val(b, 22, 2), _val(b, 24, 2), _val(b, 26, 10))


@dataclasses.dataclass(frozen=True)
class RxWordC:
    F: bool
    NAWC: int
    SERIAL: int

    @classmethod
    def parse(cls, bits) -> "RxWordC":
        b = np.asarray(bits)
        return cls(bool(b[0] & 1), _val(b, 1, 3), _val(b, 4, 32))


_DIGITS = {1: "1", 2: "2", 3: "3", 4: "4", 5: "5", 6: "6", 7: "7",
           8: "8", 9: "9", 10: "0", 11: "*", 12: "#"}


@dataclasses.dataclass(frozen=True)
class RxWordCalled:
    F: bool
    NAWC: int
    DIGITS: int

    @classmethod
    def parse(cls, bits) -> "RxWordCalled":
        b = np.asarray(bits)
        return cls(bool(b[0] & 1), _val(b, 1, 3), _val(b, 4, 32))

    def digits(self) -> str:
        """Table 2.7.1-2 decode; 0 ends, 13-15 truncate
        (lib/amps_packet.h:211-273)."""
        out = []
        v = self.DIGITS
        for _ in range(8):
            nib = (v >> 28) & 0xF
            if nib == 0 or nib >= 13:
                break
            out.append(_DIGITS[nib])
            v = (v << 4) & 0xFFFFFFFF
        return "".join(out)


def encode_called_digits(s: str) -> int:
    """Inverse of ``RxWordCalled.digits`` — Table 2.7.1-2 encode of up to
    8 dialed digits into the 32-bit DIGITS field (mobile side; the BS
    parser is lib/amps_packet.h:211-273)."""
    inv = {c: v for v, c in _DIGITS.items()}
    assert len(s) <= 8
    v = 0
    for i, c in enumerate(s):
        v |= inv[c] << (28 - 4 * i)
    return v


# -- MIN codec (host) -------------------------------------------------------

def _min3(d1: str, d2: str, d3: str) -> int:
    a = (ord(d1) - 0x30) or 10
    b = (ord(d2) - 0x30) or 10
    c = (ord(d3) - 0x30) or 10
    return 100 * a + 10 * b + c - 111


def _inv_min3(val: int) -> str:
    m2 = val + 111
    dig = m2 % 10
    s = chr(0x30 + dig)
    m2 -= 10 if dig == 0 else dig
    dig = (m2 % 100) // 10
    s = chr(0x30 + dig) + s
    m2 -= 100 if dig == 0 else m2 % 100
    dig = m2 // 100
    if dig > 9:
        dig = 0
    return chr(0x30 + dig) + s


def parse_min(min_str: str):
    """10-digit MIN -> (MIN1, MIN2) or None (lib/amps_packet.h:328).

    Fix vs reference: it accepts length 1..10 then reads min[0..9]
    unconditionally (out-of-range std::string reads for short inputs);
    we require exactly 10 digits.
    """
    # isascii() matters: str.isdigit() accepts non-ASCII Unicode digits
    # (e.g. fullwidth '１'), and the ord()-0x30 arithmetic below would
    # silently encode a garbage MIN instead of rejecting — the
    # reference's explicit '0'..'9' range check (amps_packet.h) rejects
    if len(min_str) != 10 or not (min_str.isascii()
                                  and min_str.isdigit()):
        return None
    min2 = _min3(min_str[0], min_str[1], min_str[2])
    om1 = (_min3(min_str[3], min_str[4], min_str[5]) & 0x3FF) << 14
    thous = (ord(min_str[6]) - 0x30) or 10
    om1 |= (thous & 0xF) << 10
    om1 |= _min3(min_str[7], min_str[8], min_str[9]) & 0x3FF
    return om1, min2


def calc_min(min1: int, min2: int) -> str:
    """(MIN1, MIN2) -> 10-digit MIN (lib/amps_packet.h:354)."""
    thous = (min1 >> 10) & 0xF
    if thous > 9:
        thous = 0
    return (_inv_min3(min2) + _inv_min3((min1 >> 14) & 0x3FF)
            + chr(0x30 + thous) + _inv_min3(min1 & 0x3FF))


@dataclasses.dataclass(frozen=True)
class FvcVoiceChannel:
    """FVC Word 1 VMAC/CHAN handoff designation (the extension word
    built by codec.words.fvc_word1_voice_channel; SCC != 3 distinguishes
    it from the order variant's constant SCC=11 header)."""

    SCC: int
    PSCC: int
    VMAC: int
    CHAN: int

    @classmethod
    def parse(cls, bits):
        return cls(SCC=_val(bits, 2, 2), PSCC=_val(bits, 4, 2),
                   VMAC=_val(bits, 14, 3), CHAN=_val(bits, 17, 11))

    @property
    def is_order(self) -> bool:
        return self.SCC == 3
