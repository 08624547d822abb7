"""FOCC/FVC word builders and RECC word parsers, the PyTorch port of
``amps_tpu.codec.words``.

Every builder accepts Python ints or integer tensors of any batch shape
and returns (..., 28) uint8 bit tensors, bit for bit the JAX package's
layouts.  The parsers take (..., 36) bit tensors and return a dict of
(...,) fields: int32, and int64 for the 24- and 32-bit fields (the JAX
package's uint32).
"""

from __future__ import annotations

import numpy as np
import torch

from amps_tpu_torch.codec.bits import expandbits, packbits


def _bcast(*parts):
    """Broadcast the leading dims of (..., k_i) parts and concatenate
    them on the last axis."""
    batch = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return torch.cat([p.expand(batch + p.shape[-1:]) for p in parts], -1)


def _bits(val, nbits):
    return expandbits(torch.as_tensor(val).to(torch.int64), nbits)


def _const(*bits_):
    return torch.tensor(bits_, dtype=torch.uint8)


def focc_word1(multiword, dcc, min1):
    """Word 1 (Abbreviated Address Word)."""
    mw = torch.as_tensor(multiword).to(torch.int64)
    return _bcast(torch.zeros(mw.shape + (1,), dtype=torch.uint8),
                  _bits(mw, 1), _bits(dcc, 2), _bits(min1, 24))


def focc_word2_general(min2, msg_type, ordq, order):
    """Word 2 (SCC=11 order variant)."""
    return _bcast(_const(1, 0, 1, 1), _bits(min2, 10), _const(0),
                  _bits(msg_type, 5), _bits(ordq, 3), _bits(order, 5))


def focc_word2_voice_channel(scc, min2, vmac, chan):
    """Word 2 (VMAC/CHAN voice designation)."""
    return _bcast(_const(1, 0), _bits(scc, 2), _bits(min2, 10),
                  _bits(vmac, 3), _bits(chan, 11))


def fvc_word1_voice_channel(scc, pscc, vmac, chan):
    """FVC Word 1, VMAC/CHAN handoff designation (the JAX package's
    experimental layout, kept bit for bit)."""
    return _bcast(_const(1, 0), _bits(scc, 2), _bits(pscc, 2),
                  _const(0, 0, 0, 0, 0, 0, 0, 0), _bits(vmac, 3),
                  _bits(chan, 11))


def fvc_word1_general(pscc, msg_type, ordq, order):
    """FVC Word 1 (order variant)."""
    return _bcast(_const(1, 0, 1, 1), _bits(pscc, 2),
                  _const(0, 0, 0, 0, 0, 0, 0, 0, 0), _bits(msg_type, 5),
                  _bits(ordq, 3), _bits(order, 5))


# -- FOCC overhead words ---------------------------------------------------

def overhead_word_1(dcc, sid, ep, auth, pci, nawc):
    return _bcast(_const(1, 1), _bits(dcc, 2),
                  _bits(torch.as_tensor(sid).to(torch.int64) >> 1, 14),
                  _bits(ep, 1), _bits(auth, 1), _bits(pci, 1),
                  _bits(nawc, 4),
                  _const(1, 1, 0))                   # OHD = 110


def overhead_word_2(dcc, s, e, regh, regr, dtx, nminusone, rcf, cpa, cmax,
                    end):
    return _bcast(_const(1, 1), _bits(dcc, 2),
                  *[_bits(f, 1) for f in (s, e, regh, regr)],
                  _bits(dtx, 2), _bits(nminusone, 5), _bits(rcf, 1),
                  _bits(cpa, 1), _bits(cmax, 7), _bits(end, 1),
                  _const(1, 1, 1))                   # OHD = 111


CONTROL_FILLER = np.array(
    [1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0,
     0, 1, 1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 1], dtype=np.uint8)


def control_filler_word():
    return torch.as_tensor(CONTROL_FILLER)


def access_type_parameters_global_action(dcc, end=False):
    return _bcast(_const(1, 1), _bits(dcc, 2),
                  _const(1, 0, 0, 1),                # ACT = 1001
                  _const(*([0] * 16)),               # BIS/PCI/BSPC/BSCAP/RSVD
                  _bits(end, 1),
                  _const(1, 0, 0))                   # OHD = 100


def registration_increment_global_action(dcc, regincr, end=False):
    return _bcast(_const(1, 1), _bits(dcc, 2),
                  _const(0, 0, 1, 0),                # ACT = 0010
                  _bits(regincr, 12), _const(0, 0, 0, 0), _bits(end, 1),
                  _const(1, 0, 0))                   # OHD = 100


def registration_id(dcc, regid, end=False):
    return _bcast(_const(1, 1), _bits(dcc, 2), _bits(regid, 20),
                  _bits(end, 1),
                  _const(0, 0, 0))                   # OHD = 000


# -- RECC word parsers (lib/amps_packet.h:103-274), batched -----------------

def _flag(b, i):
    return b[..., i].to(torch.int32)


def parse_recc_word_a(bits36):
    """(..., 36) -> dict of fields (F/NAWC/T/S/E/ER/SCM/MIN1)."""
    b = torch.as_tensor(bits36)
    return {"F": _flag(b, 0), "NAWC": packbits(b[..., 1:4]),
            "T": _flag(b, 4), "S": _flag(b, 5), "E": _flag(b, 6),
            "ER": _flag(b, 7), "SCM": packbits(b[..., 8:12]),
            "MIN1": packbits(b[..., 12:36], torch.int64)}


def parse_recc_word_b(bits36):
    b = torch.as_tensor(bits36)
    return {"F": _flag(b, 0), "NAWC": packbits(b[..., 1:4]),
            "MSG_TYPE": packbits(b[..., 4:9]),
            "ORDQ": packbits(b[..., 9:12]),
            "ORDER": packbits(b[..., 12:17]), "LT": _flag(b, 17),
            "EP": _flag(b, 18), "SCM4": _flag(b, 19),
            "MPCI": packbits(b[..., 20:22]),
            "SDCC1": packbits(b[..., 22:24]),
            "SDCC2": packbits(b[..., 24:26]),
            "MIN2": packbits(b[..., 26:36])}


def parse_recc_word_c_serial(bits36):
    b = torch.as_tensor(bits36)
    return {"F": _flag(b, 0), "NAWC": packbits(b[..., 1:4]),
            "SERIAL": packbits(b[..., 4:36], torch.int64)}


def parse_recc_word_called(bits36):
    b = torch.as_tensor(bits36)
    return {"F": _flag(b, 0), "NAWC": packbits(b[..., 1:4]),
            "DIGITS": packbits(b[..., 4:36], torch.int64)}
