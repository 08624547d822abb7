"""Fused receive front end: analysis channelizer + FM discriminator +
integrate-and-dump phase streams + 384-hop band-power partials.

``analyze_phases`` is the wrapper: a CUDA tensor launches the
hand-written kernel in ``csrc/rx_phases.cu`` (the Hopper port of
``amps_tpu/pallas/rx_phases_kernel.py::analyze_phases_pallas``) or
raises; a CPU tensor computes the kernel's plain version,
``analyze_phases_reference`` — the port's channelizer ->
quadrature_demod_planar -> symbol_phase_streams / window_power_blocks.
There is no fallback from one to the other.  The kernel runs the dense
channel-pair tile (``csrc/analysis_tile.cuh``) on the tables of
``_tables``: blocks of CHANNEL_TILE channels, M a multiple of it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from amps_tpu_torch.dsp.fm import quadrature_demod_planar
from amps_tpu_torch.kernels.analysis import _pair_tables as _tables
from amps_tpu_torch.kernels.analysis import (analyze_reference, bind,
                                             block_geometry, card_block,
                                             launch)
from amps_tpu_torch.rx.correlator import (RSSI_BLOCK, power_from_blocks,
                                          symbol_phase_streams,
                                          window_power_blocks)

CHANNEL_TILE = 64          # channels per thread block (csrc KC)
TILE_HOPS = RSSI_BLOCK     # hops per thread block (csrc kTileHops)
MAX_SPS = 32               # its 128-hop demod ring holds 64 + 2 sps - 2 hops

# kernel launches since import (or since the caller last reset it);
# incremented only where the kernel is launched
LAUNCHES = 0


def _nsym(Nh: int, sps: int) -> int:
    """Whole symbols of sps hops in a block of Nh hops."""
    if Nh < sps:
        raise ValueError(f"block of {Nh} hops is shorter than sps={sps}")
    return (Nh - sps + 1) // sps


def analyze_phases_reference(x_ext, M: int, T: int, sps: int = 3,
                             hop0_parity: int = 0,
                             out_dtype=torch.float32):
    """Plain PyTorch version of the kernel, on any device."""
    planar, _, Nh = block_geometry(x_ext, M, T)
    _nsym(Nh, sps)
    ypl = analyze_reference(x_ext, M, T, hop0_parity, planar=True,
                            planar_in=planar)
    demod, _, pw = quadrature_demod_planar(ypl[0], ypl[1],
                                           return_power="series")
    phases = symbol_phase_streams(demod, sps).to(out_dtype)
    pw_blk = window_power_blocks([pw])
    return phases, power_from_blocks(pw_blk, pw.shape[-1]), pw_blk


@functools.cache
def _launcher():
    p, i = ctypes.c_void_p, ctypes.c_int
    return bind("rx_phases_launch",
                [p, i, ctypes.c_longlong, p, p, p, p, i, p,
                 i, i, i, i, i, i, p],
                rx_phases_channel_tile=CHANNEL_TILE,
                rx_phases_tile_hops=TILE_HOPS)


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
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} not float32/bfloat16")
    if TILE_HOPS % sps or sps > MAX_SPS:
        raise ValueError(f"kernel needs {TILE_HOPS} % sps == 0 and sps <= "
                         f"{MAX_SPS} (sps={sps})")
    if M % CHANNEL_TILE:
        raise ValueError(f"kernel needs M % {CHANNEL_TILE} == 0 (M={M})")
    planar, n_ext, Nh = card_block(x_ext, M, T)
    nsym = _nsym(Nh, sps)
    dev = x_ext.device
    coef, cu, su = _tables(M, T, dev)
    ntile = -(-Nh // TILE_HOPS)
    phases = torch.empty((M, sps, nsym), dtype=out_dtype, device=dev)
    pw_blk = torch.empty((M, ntile), dtype=torch.float32, device=dev)
    launch("rx_phases", _launcher(), dev, x_ext.data_ptr(), int(planar),
           n_ext, coef.data_ptr(), cu.data_ptr(), su.data_ptr(),
           phases.data_ptr(), int(out_dtype == torch.bfloat16),
           pw_blk.data_ptr(), M, T, sps, Nh, nsym, int(hop0_parity) % 2)
    LAUNCHES += 1
    return phases, power_from_blocks(pw_blk, Nh), pw_blk
