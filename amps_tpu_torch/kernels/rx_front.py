"""Streaming receive front end: analysis channelizer + FM discriminator
with the previous block's last sample carried in, writing the demod
plane and the per-hop power series.

``analyze_demod`` is the wrapper: a CUDA tensor launches the
hand-written kernel in ``csrc/rx_front.cu`` (the Hopper port of
``amps_tpu/pallas/rx_front_kernel.py::analyze_demod_pallas``, generalised
to what ``amps_tpu.runtime.streamer._rx_stream_block`` computes) or
raises; a CPU tensor computes the kernel's plain version,
``analyze_demod_reference`` -- the port's channelizer ->
quadrature_demod_planar(prev, return_power="series").  There is no
fallback from one to the other.  The kernel runs the all-channel FFT
tile of ``kernels.analysis`` (``csrc/analysis_fft.cuh``): a block
computes ``FFT_WIDE_HOPS[M]`` hops (its f32 rows need twice the analysis
kernel's hops to fill a sector) and owns the demod of all but the
first.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from amps_tpu_torch.dsp.fm import quadrature_demod_planar
from amps_tpu_torch.kernels import route
from amps_tpu_torch.kernels.analysis import (FFT_WIDE_HOPS, _tables,
                                             analyze_reference, bind,
                                             block_geometry, card_block,
                                             check_fft_width, fft_smem_bytes,
                                             fold_coef, launch, route_length)

# demod hops a thread block owns, by M (csrc fft_wide_hops - 1)
TILE_HOPS = {M: h - 1 for M, h in FFT_WIDE_HOPS.items()}

# kernel launches since import (or since the caller last reset it);
# incremented only where the kernel is launched
LAUNCHES = 0


def _check_prev(prev_iq: torch.Tensor, M: int) -> None:
    if tuple(prev_iq.shape) != (M, 2):
        raise ValueError(f"prev_iq must be ({M}, 2), got "
                         f"{tuple(prev_iq.shape)}")


def analyze_demod_reference(x_ext, M: int, T: int, hop0_parity: int,
                            prev_iq):
    """Plain PyTorch version of the kernel, on any device."""
    planar, _, _ = block_geometry(x_ext, M, T)
    _check_prev(prev_iq, M)
    ypl = analyze_reference(x_ext, M, T, hop0_parity, planar=True,
                            planar_in=planar)
    demod, (lr, li), pw = quadrature_demod_planar(
        ypl[0], ypl[1], prev=(prev_iq[:, 0], prev_iq[:, 1]),
        return_power="series")
    return demod, torch.stack([lr, li], dim=-1), pw


@functools.cache
def _launcher(M: int):
    p, i = ctypes.c_void_p, ctypes.c_int
    return bind("rx_front", [p, i, ctypes.c_longlong, p, p, p, p, p, p, i,
                             i, i, i, p], M, TILE_HOPS[M],
                fft_smem_bytes(M, FFT_WIDE_HOPS[M]))


def analyze_demod(x_ext, M: int, T: int, hop0_parity: int, prev_iq):
    """Analysis + discriminator of one streaming block.

    x_ext: ((Nh + 2T - 1) * M/2, 2) float32 riq or (2, ...) planar
    planes, with the analyzer history already prepended; hop0_parity the
    absolute parity of the block's first hop; prev_iq (M, 2) the last
    channel sample of the previous block (zeros at the stream's start).
    Returns (demod (M, Nh), last (M, 2), pw_series (M, Nh)), float32:
    demod[k, n] = arg(y_k[n] conj(y_k[n-1])), pw_series its re² + im²,
    last = y[:, Nh-1]."""
    global LAUNCHES
    if not isinstance(x_ext, torch.Tensor) or \
            not isinstance(prev_iq, torch.Tensor):
        raise TypeError("x_ext and prev_iq must be torch.Tensors")
    if x_ext.device.type == "cpu":
        return analyze_demod_reference(x_ext, M, T, hop0_parity, prev_iq)
    check_fft_width(M)
    planar, n_ext, Nh = card_block(x_ext, M, T)
    if prev_iq.device != x_ext.device or prev_iq.dtype != torch.float32:
        raise ValueError(f"prev_iq must be float32 on {x_ext.device}, got "
                         f"{prev_iq.dtype} on {prev_iq.device}")
    _check_prev(prev_iq, M)
    dev = x_ext.device
    prev = prev_iq.contiguous()
    if route_length(M):
        out = route.front(x_ext, fold_coef(M, T, dev), prev, M, T, Nh,
                          n_ext, planar, hop0_parity)
        LAUNCHES += 1
        return out
    coef, tw = _tables(M, T, dev)
    demod = torch.empty((M, Nh), dtype=torch.float32, device=dev)
    pw = torch.empty((M, Nh), dtype=torch.float32, device=dev)
    last = torch.empty((M, 2), dtype=torch.float32, device=dev)
    launch("rx_front", _launcher(M), dev, x_ext.data_ptr(), int(planar),
           n_ext, coef.data_ptr(), tw.data_ptr(), prev.data_ptr(),
           demod.data_ptr(), pw.data_ptr(), last.data_ptr(), M, T, Nh,
           int(hop0_parity) % 2)
    LAUNCHES += 1
    return demod, last, pw
