"""BCH(63,51,t=2) codec, the PyTorch port of ``amps_tpu.codec.bch``:
the (40, 28) forward and (48, 36) reverse shortened codes, both ways.

Encode is a GF(2) matmul of the info bits with the parity matrix;
decode is a syndrome matmul mod 2, a pack to a 12-bit index and a
DIRECT index into the packed (4096,) syndrome LUT (the JAX package's
16³ one-hot contractions existed only because TPU gathers are serial
scalar loads; the integers are identical).  Tables are built in numpy
exactly as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from amps_tpu_torch.codec.bits import packbits

N = 63
K = 51
NUM_PARITY = 12
# g(x) = x^12 + x^10 + x^8 + x^5 + x^4 + x^3 + 1 (TIA/EIA-553 §3.7.1)
_GEN = np.array([1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 1], dtype=np.uint8)


def _poly_mod(dividend: np.ndarray) -> np.ndarray:
    rem = dividend.copy()
    for i in range(len(rem) - len(_GEN) + 1):
        if rem[i]:
            rem[i: i + len(_GEN)] ^= _GEN
    return rem[-(len(_GEN) - 1):]


@functools.cache
def _parity_matrix(k_info: int) -> np.ndarray:
    """(k_info, 12) P with parity = info @ P mod 2 (shortened code)."""
    P = np.zeros((k_info, NUM_PARITY), dtype=np.uint8)
    for i in range(k_info):
        m = np.zeros(k_info + NUM_PARITY, dtype=np.uint8)
        m[i] = 1
        P[i] = _poly_mod(m)
    return P


@functools.cache
def _syndrome_matrix(n_code: int) -> np.ndarray:
    """(n_code, 12) H with syndrome = rx @ H mod 2 (remainder mod g)."""
    H = np.zeros((n_code, NUM_PARITY), dtype=np.uint8)
    for i in range(n_code):
        m = np.zeros(n_code, dtype=np.uint8)
        m[i] = 1
        H[i] = _poly_mod(m)
    return H


@functools.cache
def _decode_table_packed(n_code: int) -> np.ndarray:
    """(4096,) int32 syndrome LUT: pos1 | pos2 << 8 | valid << 16.

    Patterns are enumerated over the full 63-bit codeword (the
    reference decodes the zero-padded word); errors in the zero prefix
    are stored as the sentinel position 255 — valid, flipping nothing."""
    H63 = _syndrome_matrix(N)
    pad = N - n_code
    tab = np.full(1 << NUM_PARITY, 255 | (255 << 8), dtype=np.int32)
    weights = (1 << np.arange(NUM_PARITY - 1, -1, -1))

    def syn_index(pattern63):
        return int((pattern63.astype(np.uint8) @ H63 % 2) @ weights)

    def pos(i):
        return i - pad if i >= pad else 255

    tab[0] = 255 | (255 << 8) | (1 << 16)
    for i in range(N):
        p = np.zeros(N, dtype=np.uint8)
        p[i] = 1
        tab[syn_index(p)] = pos(i) | (255 << 8) | (1 << 16)
    for i in range(N):
        for j in range(i + 1, N):
            p = np.zeros(N, dtype=np.uint8)
            p[i] = 1
            p[j] = 1
            tab[syn_index(p)] = pos(i) | (pos(j) << 8) | (1 << 16)
    return tab


@functools.cache
def _device_table(name: str, n: int, device) -> torch.Tensor:
    """Device copy of a constant table (made once per device)."""
    if name == "lut":
        return torch.as_tensor(_decode_table_packed(n), device=device)
    mat = _syndrome_matrix(n) if name == "syndrome" else _parity_matrix(n)
    return torch.as_tensor(mat, dtype=torch.float32, device=device)


def lut_lookup(idx: torch.Tensor, n_code: int = 48) -> torch.Tensor:
    """Packed syndrome LUT value of each 12-bit syndrome index, as a
    direct index into the (4096,) table of the code shortened to n_code."""
    return _device_table("lut", n_code, idx.device)[idx.long()]


def packed_lut_lookup(idx, table: np.ndarray) -> torch.Tensor:
    """table[idx] for a (4096,) packed int table (pos1 | pos2 << 8 |
    valid << 16): a direct index."""
    idx = torch.as_tensor(idx)
    return torch.as_tensor(table, device=idx.device)[idx.long()]


def apply_error_pattern(word, g, k_keep: int):
    """XOR the <=2-bit error pattern encoded in packed LUT value ``g``
    into (..., >=k_keep) received bits; returns (..., k_keep) uint8."""
    word = torch.as_tensor(word).to(torch.uint8)
    g = torch.as_tensor(g, device=word.device)
    p1 = g & 0xFF
    p2 = (g >> 8) & 0xFF
    pos = torch.arange(k_keep, dtype=torch.int32, device=word.device)
    err = (pos == p1[..., None]) | (pos == p2[..., None])
    return torch.bitwise_xor(word[..., :k_keep], err.to(torch.uint8))


def _syndrome_packed(rx, n_code: int):
    rx = torch.as_tensor(rx).to(torch.float32)
    H = _device_table("syndrome", n_code, rx.device)
    syn_bits = torch.remainder(rx @ H, 2.0).to(torch.int32)
    return lut_lookup(packbits(syn_bits), n_code)


def recc_syndrome_packed(rx48):
    """(..., 48) received bits -> (...,) packed int32 LUT values (valid
    bit 16)."""
    return _syndrome_packed(rx48, 48)


def recc_syndrome_matrix() -> np.ndarray:
    """(48, 12) uint8 H of the (48, 36) reverse code."""
    return _syndrome_matrix(48)


def recc_decode_table_packed() -> np.ndarray:
    """(4096,) int32 packed syndrome LUT of the (48, 36) reverse code."""
    return _decode_table_packed(48)


def _encode(info, k_info: int):
    info = torch.as_tensor(info).to(torch.uint8)
    P = _device_table("parity", k_info, info.device)
    parity = torch.remainder(info.to(torch.float32) @ P, 2.0)
    return torch.cat([info, parity.to(torch.uint8)], dim=-1)


def focc_bch_encode(info28):
    """(..., 28) info bits -> (..., 40) coded forward word (uint8)."""
    return _encode(info28, 28)


def recc_bch_encode(info36):
    """(..., 36) info bits -> (..., 48) coded reverse word (uint8)."""
    return _encode(info36, 36)


def recc_bch_decode(rx48):
    """(..., 48) received bits -> ((..., 36) corrected info bits, (...) ok)."""
    rx48 = torch.as_tensor(rx48)
    g = _syndrome_packed(rx48, 48)
    ok = (g & (1 << 16)) != 0
    return apply_error_pattern(rx48, g, 36), ok


def focc_bch_decode(rx40):
    """(..., 40) received bits -> ((..., 28) corrected info bits, (...) ok).

    The base station never decodes the forward code; the mobile side
    (``ms.focc_rx``, ``ms.fvc_rx``) does."""
    rx40 = torch.as_tensor(rx40)
    g = _syndrome_packed(rx40, 40)
    ok = (g & (1 << 16)) != 0
    return apply_error_pattern(rx40, g, 28), ok
