"""Fused receive front end: analysis channelizer + FM discriminator +
integrate-and-dump phase streams + 384-hop band-power partials.

``analyze_phases`` is the wrapper: a CUDA tensor launches the
hand-written kernel in ``csrc/rx_phases.cu`` (the Hopper port of
``amps_tpu/pallas/rx_phases_kernel.py::analyze_phases_pallas``) or
raises; a CPU tensor computes the kernel's plain version,
``analyze_phases_reference`` — the port's channelizer ->
quadrature_demod_planar -> symbol_phase_streams / window_power_blocks.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.dsp.fm import quadrature_demod_planar
from amps_tpu_torch.kernels import build
from amps_tpu_torch.rx.correlator import (RSSI_BLOCK, power_from_blocks,
                                          symbol_phase_streams,
                                          window_power_blocks)

TILE_HOPS = RSSI_BLOCK     # hops per thread block (csrc kTileHops)
CHANNEL_TILE = 64          # channels per thread block (csrc KC)
MAX_TAPS = 16              # taps per phase the kernel holds (csrc kMaxT)
MAX_SPS = 32               # its 128-hop demod ring holds 64 + 2 sps - 2 hops

# kernel launches since import (or since the caller last reset it);
# incremented only where the kernel is launched
LAUNCHES = 0


def _is_planar(x: torch.Tensor) -> bool:
    return x.ndim == 2 and x.shape[0] == 2 and x.shape[1] != 2


def block_geometry(x_ext: torch.Tensor, M: int, T: int):
    """(planar, n_ext, Nh) of a history-prepended input block of the
    front-end kernels."""
    planar = _is_planar(x_ext)
    if not planar and not (x_ext.ndim == 2 and x_ext.shape[1] == 2):
        raise ValueError(f"x_ext must be (n, 2) or (2, n), got "
                         f"{tuple(x_ext.shape)}")
    P = M // 2
    n_ext = x_ext.shape[1] if planar else x_ext.shape[0]
    if M % 2 or n_ext % P:
        raise ValueError(f"x_ext length {n_ext} is not a multiple of the "
                         f"hop {P}")
    return planar, n_ext, n_ext // P - (2 * T - 1)


def _geometry(x_ext: torch.Tensor, M: int, T: int, sps: int):
    """(planar, n_ext, Nh, nsym) of a history-prepended input block."""
    planar, n_ext, Nh = block_geometry(x_ext, M, T)
    if Nh < sps:
        raise ValueError(f"block of {Nh} hops is shorter than sps={sps}")
    return planar, n_ext, Nh, (Nh - sps + 1) // sps


def analyze_phases_reference(x_ext, M: int, T: int, sps: int = 3,
                             hop0_parity: int = 0,
                             out_dtype=torch.float32):
    """Plain PyTorch version of the kernel, on any device."""
    planar, _, _, _ = _geometry(x_ext, M, T, sps)
    ypl = chz._analyze_block_chmajor(x_ext, M, T, hop0_parity, "bank",
                                     planar=True, planar_in=planar)
    demod, _, pw = quadrature_demod_planar(ypl[0], ypl[1],
                                           return_power="series")
    phases = symbol_phase_streams(demod, sps).to(out_dtype)
    pw_blk = window_power_blocks([pw])
    return phases, power_from_blocks(pw_blk, pw.shape[-1]), pw_blk


@functools.cache
def _tables(M: int, T: int, device: torch.device):
    """The kernel's tables on device: fold coefficients (T, M) and the
    (M, M/2) cos/sin columns of the channel pairs (u, M - u), u < M/2;
    sin column 0 (sin 0 = 0) carries channel M/2's cos column (-1)^m."""
    C, S = chz._dft_mats(M)
    P = M // 2
    cu = np.ascontiguousarray(C[:, :P])
    su = np.ascontiguousarray(S[:, :P])
    su[:, 0] = C[:, P]
    coef = chz._analysis_consts(M, T, device)[0]
    return (coef, *(torch.as_tensor(a, device=device) for a in (cu, su)))


@functools.cache
def _launcher():
    lib = build.load()
    fn = lib.rx_phases_launch
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, i, ctypes.c_longlong, p, p, p, p, i, p,
                   i, i, i, i, i, i, p]
    fn.restype = i
    for name, want in (("rx_phases_channel_tile", CHANNEL_TILE),
                       ("rx_phases_tile_hops", TILE_HOPS)):
        getattr(lib, name).restype = i
        if getattr(lib, name)() != want:
            raise RuntimeError(f"{name} of the built kernel != {want}")
    return fn


def analyze_phases(x_ext, M: int, T: int, sps: int = 3,
                   hop0_parity: int = 0, out_dtype=torch.float32):
    """Fused analysis + discriminator + integrate-and-dump.

    x_ext: ((Nh + 2T - 1) * M/2, 2) float32 riq or (2, ...) planar
    planes, with the analyzer history already prepended; hop0_parity is
    the absolute parity of the block's first hop.  Returns
    (phases (M, sps, nsym) ``out_dtype``, chan_power (M,) float32,
    pw_blk (M, ceil(Nh / 384)) float32), nsym = (Nh - sps + 1) // sps.
    """
    global LAUNCHES
    if not isinstance(x_ext, torch.Tensor):
        raise TypeError("x_ext must be a torch.Tensor")
    if x_ext.device.type == "cpu":
        return analyze_phases_reference(x_ext, M, T, sps, hop0_parity,
                                        out_dtype)
    if x_ext.device.type != "cuda":
        raise ValueError(f"unsupported device {x_ext.device}")
    if x_ext.dtype != torch.float32 or not x_ext.is_contiguous():
        raise ValueError("x_ext must be contiguous float32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} not float32/bfloat16")
    if (M % CHANNEL_TILE or TILE_HOPS % sps or sps > MAX_SPS
            or not 1 <= T <= MAX_TAPS):
        raise ValueError(f"kernel needs M % {CHANNEL_TILE} == 0, "
                         f"{TILE_HOPS} % sps == 0, sps <= {MAX_SPS} and "
                         f"1 <= T <= {MAX_TAPS} (M={M}, sps={sps}, T={T})")
    planar, n_ext, Nh, nsym = _geometry(x_ext, M, T, sps)
    if x_ext.data_ptr() % (4 if planar else 8):
        raise ValueError("x_ext must be 8-byte aligned (interleaved) or "
                         "4-byte aligned (planar)")
    dev = x_ext.device
    coef, cu, su = _tables(M, T, dev)
    ntile = -(-Nh // TILE_HOPS)
    phases = torch.empty((M, sps, nsym), dtype=out_dtype, device=dev)
    pw_blk = torch.empty((M, ntile), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launcher()(x_ext.data_ptr(), int(planar), n_ext,
                         coef.data_ptr(), cu.data_ptr(), su.data_ptr(),
                         phases.data_ptr(), int(out_dtype == torch.bfloat16),
                         pw_blk.data_ptr(), M, T, sps, Nh, nsym,
                         int(hop0_parity) % 2, stream)
    if rc != 0:
        raise RuntimeError(f"rx_phases kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return phases, power_from_blocks(pw_blk, Nh), pw_blk
