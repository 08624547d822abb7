"""Fused receive front end: analysis channelizer + FM discriminator +
integrate-and-dump phase streams + 384-hop band-power partials.

``analyze_phases`` is the wrapper: a CUDA tensor launches the
hand-written kernel in ``csrc/rx_phases.cu`` (the Hopper port of
``amps_tpu/pallas/rx_phases_kernel.py::analyze_phases_pallas``) or
raises; a CPU tensor computes the kernel's plain version,
``analyze_phases_reference`` — the port's channelizer ->
quadrature_demod_planar -> symbol_phase_streams / window_power_blocks.
There is no fallback from one to the other.  The kernel runs the
all-channel FFT tile of ``kernels.analysis`` (``csrc/analysis_fft.cuh``,
any M in ``FFT_WIDTHS``): a block computes
``FFT_WIDE_HOPS[M]`` analysis hops and owns the ``run_hops(M, sps)``
demod hops after the first, whole symbols whose look-ahead fits in the
tile; the 384-hop power partials of the runs go through a scratch that a
second small kernel adds up.  G independent bands of one geometry, a
leading axis of the input, run as one launch with the band as the grid's
second axis (``parallel.pipeline.rx_multichannel_block_batched``).
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
from amps_tpu_torch.rx.correlator import (RSSI_BLOCK, power_from_blocks,
                                          symbol_phase_streams,
                                          window_power_blocks)

# kernel launches since import (or since the caller last reset it);
# incremented only where the kernel is launched
LAUNCHES = 0


def _nsym(Nh: int, sps: int) -> int:
    """Whole symbols of sps hops in a block of Nh hops."""
    if Nh < sps:
        raise ValueError(f"block of {Nh} hops is shorter than sps={sps}")
    return (Nh - sps + 1) // sps


def run_hops(M: int, sps: int) -> int:
    """Demod hops a thread block owns (csrc run_hops): the most whole
    symbols of sps hops whose sps-1 hops of look-ahead and one hop behind
    fit in the block's FFT_WIDE_HOPS[M] analysis hops."""
    return max(0, (FFT_WIDE_HOPS[M] - sps) // sps * sps)


def analyze_phases_reference(x_ext, M: int, T: int, sps: int = 3,
                             hop0_parity: int = 0,
                             out_dtype=torch.float32):
    """Plain PyTorch version of the kernel, on any device (a leading
    band axis included)."""
    planar, _, Nh = block_geometry(x_ext[0] if x_ext.ndim == 3 else x_ext,
                                   M, T)
    _nsym(Nh, sps)
    ypl = analyze_reference(x_ext, M, T, hop0_parity, planar=True,
                            planar_in=planar)
    demod, _, pw = quadrature_demod_planar(ypl[..., 0, :, :],
                                           ypl[..., 1, :, :],
                                           return_power="series")
    phases = symbol_phase_streams(demod, sps).to(out_dtype)
    pw_blk = window_power_blocks([pw])
    return phases, power_from_blocks(pw_blk, pw.shape[-1]), pw_blk


@functools.cache
def _launcher(M: int):
    p, i = ctypes.c_void_p, ctypes.c_int
    return bind("rx_phases", [p, i, ctypes.c_longlong, p, p, p, i, p, p,
                              i, i, i, i, i, i, i, i, p], M,
                FFT_WIDE_HOPS[M], fft_smem_bytes(M, FFT_WIDE_HOPS[M]))


def analyze_phases(x_ext, M: int, T: int, sps: int = 3,
                   hop0_parity: int = 0, out_dtype=torch.float32):
    """Fused analysis + discriminator + integrate-and-dump.

    x_ext: ((Nh + 2T - 1) * M/2, 2) float32 riq or (2, ...) planar
    planes, with the analyzer history already prepended; hop0_parity is
    the absolute parity of the block's first hop.  Returns
    (phases (M, sps, nsym) ``out_dtype``, chan_power (M,) float32,
    pw_blk (M, ceil(Nh / 384)) float32), nsym = (Nh - sps + 1) // sps.
    G independent bands, x_ext (G, n_ext, 2) or (G, 2, n_ext), give the
    same with a leading G axis, from one launch.
    """
    global LAUNCHES
    if not isinstance(x_ext, torch.Tensor):
        raise TypeError("x_ext must be a torch.Tensor")
    if x_ext.device.type == "cpu":
        return analyze_phases_reference(x_ext, M, T, sps, hop0_parity,
                                        out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} not float32/bfloat16")
    check_fft_width(M)
    on_route = route_length(M) > 0
    if on_route and not 1 <= sps <= route.MAX_SPS:
        raise ValueError(f"the device-memory route needs 1 <= sps <= "
                         f"{route.MAX_SPS} at M={M} (sps={sps})")
    if not on_route and (sps < 1 or run_hops(M, sps) < sps):
        raise ValueError(f"kernel needs 1 <= sps <= "
                         f"{FFT_WIDE_HOPS[M] // 2} at M={M} (sps={sps})")
    if x_ext.ndim == 3:
        if not x_ext.is_contiguous():
            raise ValueError("x_ext must be contiguous float32")
        G = x_ext.shape[0]
        planar, n_ext, Nh = card_block(x_ext[0], M, T)
        lead = (G,)
    else:
        G, lead = 1, ()
        planar, n_ext, Nh = card_block(x_ext, M, T)
    nsym = _nsym(Nh, sps)
    dev = x_ext.device
    phases = torch.empty(lead + (M, sps, nsym), dtype=out_dtype, device=dev)
    pw_blk = torch.empty(lead + (M, -(-Nh // RSSI_BLOCK)),
                         dtype=torch.float32, device=dev)
    if on_route:
        route.phases(x_ext, fold_coef(M, T, dev), phases, pw_blk, M, T, sps,
                     Nh, nsym, n_ext, planar, hop0_parity)
        LAUNCHES += 1
        return phases, power_from_blocks(pw_blk, Nh), pw_blk
    coef, tw = _tables(M, T, dev)
    nrun = -(-Nh // run_hops(M, sps))
    pw_part = torch.empty(lead + (M, nrun, 2), dtype=torch.float32,
                          device=dev)
    launch("rx_phases", _launcher(M), dev, x_ext.data_ptr(), int(planar),
           n_ext, coef.data_ptr(), tw.data_ptr(), phases.data_ptr(),
           int(out_dtype == torch.bfloat16), pw_part.data_ptr(),
           pw_blk.data_ptr(), M, T, sps, Nh, nsym, int(hop0_parity) % 2,
           nrun, G)
    LAUNCHES += 1
    return phases, power_from_blocks(pw_blk, Nh), pw_blk
