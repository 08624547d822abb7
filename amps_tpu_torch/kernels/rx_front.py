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
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.dsp.fm import quadrature_demod_planar
from amps_tpu_torch.kernels import build
from amps_tpu_torch.kernels.rx_phases import (CHANNEL_TILE, MAX_TAPS,
                                              _tables, block_geometry)

TILE_HOPS = 383            # demod hops per thread block (csrc kTileHops)

# kernel launches since import (or since the caller last reset it);
# incremented only where the kernel is launched
LAUNCHES = 0


def _geometry(x_ext: torch.Tensor, M: int, T: int, prev_iq):
    """(planar, n_ext, Nh) of a history-prepended input block."""
    planar, n_ext, Nh = block_geometry(x_ext, M, T)
    if Nh < 1:
        raise ValueError(f"x_ext of {n_ext} samples holds no hop past the "
                         f"history")
    if tuple(prev_iq.shape) != (M, 2):
        raise ValueError(f"prev_iq must be ({M}, 2), got "
                         f"{tuple(prev_iq.shape)}")
    return planar, n_ext, Nh


def analyze_demod_reference(x_ext, M: int, T: int, hop0_parity: int,
                            prev_iq):
    """Plain PyTorch version of the kernel, on any device."""
    planar, _, _ = _geometry(x_ext, M, T, prev_iq)
    ypl = chz._analyze_block_chmajor(x_ext, M, T, int(hop0_parity) % 2,
                                     "bank", planar=True, planar_in=planar)
    demod, (lr, li), pw = quadrature_demod_planar(
        ypl[0], ypl[1], prev=(prev_iq[:, 0], prev_iq[:, 1]),
        return_power="series")
    return demod, torch.stack([lr, li], dim=-1), pw


@functools.cache
def _launcher():
    lib = build.load()
    fn = lib.rx_front_launch
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, i, ctypes.c_longlong, p, p, p, p, p, p, p,
                   i, i, i, i, p]
    fn.restype = i
    for name, want in (("rx_front_channel_tile", CHANNEL_TILE),
                       ("rx_front_tile_hops", TILE_HOPS)):
        getattr(lib, name).restype = i
        if getattr(lib, name)() != want:
            raise RuntimeError(f"{name} of the built kernel != {want}")
    return fn


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
    if x_ext.device.type != "cuda" or prev_iq.device != x_ext.device:
        raise ValueError(f"unsupported devices {x_ext.device}, "
                         f"{prev_iq.device}")
    if x_ext.dtype != torch.float32 or prev_iq.dtype != torch.float32 \
            or not x_ext.is_contiguous():
        raise ValueError("x_ext must be contiguous float32, prev_iq float32")
    if M % CHANNEL_TILE or not 1 <= T <= MAX_TAPS:
        raise ValueError(f"kernel needs M % {CHANNEL_TILE} == 0 and "
                         f"1 <= T <= {MAX_TAPS} (M={M}, T={T})")
    planar, n_ext, Nh = _geometry(x_ext, M, T, prev_iq)
    if x_ext.data_ptr() % (4 if planar else 8):
        raise ValueError("x_ext must be 8-byte aligned (interleaved) or "
                         "4-byte aligned (planar)")
    dev = x_ext.device
    coef, cu, su = _tables(M, T, dev)
    prev = prev_iq.contiguous()
    demod = torch.empty((M, Nh), dtype=torch.float32, device=dev)
    pw = torch.empty((M, Nh), dtype=torch.float32, device=dev)
    last = torch.empty((M, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launcher()(x_ext.data_ptr(), int(planar), n_ext,
                         coef.data_ptr(), cu.data_ptr(), su.data_ptr(),
                         prev.data_ptr(), demod.data_ptr(), pw.data_ptr(),
                         last.data_ptr(), M, T, Nh, int(hop0_parity) % 2,
                         stream)
    if rc != 0:
        raise RuntimeError(f"rx_front kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return demod, last, pw
