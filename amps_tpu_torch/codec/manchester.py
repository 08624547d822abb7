"""Manchester codec, the PyTorch port of ``amps_tpu.codec.manchester``.

Encode: bit 0 -> (+1, -1), bit 1 -> (-1, +1), each half repeated sps
times.  Decode on sliced 0/1 symbols: (1,0) -> 0, (0,1) -> 1,
(1,1) -> 0 + bad, (0,0) -> 1 + bad; the output bit is the complement of
the first half-symbol, and the bad count (pairs whose halves agree) is
the reference's link-quality metric.
"""

from __future__ import annotations

import torch


def manchester_encode_symbols(bits, sps: int = 1):
    """(..., n) bits -> (..., n*2*sps) ±1 int8 symbol samples."""
    bits = torch.as_tensor(bits)
    first = torch.where(bits == 0, 1, -1).to(torch.int8)
    pair = torch.stack([first, -first], dim=-1)          # (..., n, 2)
    if sps > 1:
        pair = torch.repeat_interleave(pair, sps, dim=-1)
    return pair.reshape(*bits.shape[:-1], -1)


def manchester_decode_bits(symbols01):
    """(..., 2n) sliced 0/1 symbols -> ((..., n) uint8 bits, (...,) int32
    bad count)."""
    s = torch.as_tensor(symbols01).to(torch.int32)
    bits = (1 - s[..., 0::2]).to(torch.uint8)
    pairs = s[..., : s.shape[-1] // 2 * 2].reshape(s.shape[:-1] + (-1, 2))
    bad = torch.sum(pairs[..., 0] == pairs[..., 1], dim=-1,
                    dtype=torch.int32)
    return bits, bad


def slice_symbols(soft):
    """±soft symbols -> 0/1 hard symbols (binary_slicer_fb: >= 0 -> 1)."""
    return (torch.as_tensor(soft) >= 0).to(torch.uint8)
