"""Synthesis channelizer: M channel basebands -> one wideband stream.

``synthesize_block`` is the wrapper: a CUDA tensor launches the
hand-written kernel in ``csrc/synth.cu`` (the Hopper port of
``amps_tpu/pallas/synthesizer_kernel.py::synthesize_pallas``) or raises;
a CPU tensor computes the kernel's plain version,
``synthesize_block_reference`` -- the port's
``dsp.channelizer._synthesize_block``.  There is no fallback from one to
the other.  The kernel runs the all-channel FFT tile of
``kernels.analysis`` on hop-major rows of Y (``FFT_WIDE_HOPS[M]`` a pass,
any M in ``FFT_WIDTHS``), reads the inverse transform off the
forward FFT by index and overlap-adds in registers: its tables are the
tile's twiddles and ``_gain_taps``.  Past M = 1024 (512 for T > 8) a
thread's ring of running sums would outgrow its registers, so the P =
M/2 columns split into ``column_groups(M, T)`` groups, a grid axis, each
of which transforms the pass's hops itself (``thread_columns``: at most
2 columns a thread).  Past M = 4096 a group is a cluster of C blocks
(``kernels.analysis.cluster_blocks``: 2 up to 8192, up to 8 past it, 8
at a Bluestein width) that share each hop's transform and split the
group's columns, each block a contiguous range; each thread reads its
columns' two values of the forward FFT from whichever ranks hold them
(through distributed shared memory: at a split width channel k at rank
k // N, position k mod N; at a Bluestein width at rank k mod 8,
position k // 8).  The groups stay as many as at 4096, and each thread's
ring (32 running sums) waits in shared memory while the tile transforms
a pass, so a pass takes ``SYNTH_HOPS[M]`` hops (4 at 8192 and 16384),
fewer than the other kernels' ``FFT_WIDE_HOPS[M]``.

Past ``CHUNK_TAPS`` (16) taps the overlap-add splits by linearity into
chunks of 16 gain rows (``tap_chunks``): each chunk is one launch of the
kernel on its rows with a zero carry, into a scratch plane, and a small
kernel adds the chunks' planes, chunk c shifted by 32c hops, and the
carry-in into the block and the new carry.  A call of T taps is then
``chunk_launches(T)`` launches of the kernel (``LAUNCHES`` counts each).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.kernels import build, route
from amps_tpu_torch.kernels.analysis import (CHUNK_TAPS, FFT_WIDE_HOPS,
                                             FFT_WIDTHS, LIBRARY_WIDTHS,
                                             SMEM_BYTES, _tables, bind,
                                             check_fft_width, cluster_blocks,
                                             fft_hop_stride, fft_plan_width,
                                             fft_smem_bytes, launch,
                                             route_length)

# kernel launches since import (or since the caller last reset it);
# incremented only where the kernel is launched
LAUNCHES = 0

# running sums of a thread's ring past 4096 (thread_columns · 2·MT at
# both rings), parked in shared memory while the tile transforms a pass
# (csrc kSynthParkValues)
PARK_VALUES = 32


def park_bytes(M: int) -> int:
    """Shared memory of a block's parked ring (csrc synth_park_bytes):
    8 bytes a sum, 256 threads, past 4096 only."""
    return 8 * PARK_VALUES * 256 if cluster_blocks(M) > 1 else 0


def _synth_hops(M: int) -> int:
    """Hops a pass transforms (csrc synth_hops): FFT_WIDE_HOPS[M], or
    past 4096 the most even hops whose plane fits beside the parked
    ring."""
    if cluster_blocks(M) == 1:
        return FFT_WIDE_HOPS[M]
    return (SMEM_BYTES - park_bytes(M)) \
        // (8 * fft_hop_stride(fft_plan_width(M))) & ~1


# hops a pass of K4 transforms, by M
SYNTH_HOPS = {M: _synth_hops(M) for M in FFT_WIDTHS}


def smem_bytes(M: int) -> int:
    """A block's shared memory (csrc synth_smem): the plane of
    SYNTH_HOPS[M] hops and the parked ring."""
    return fft_smem_bytes(M, SYNTH_HOPS[M]) + park_bytes(M)


def _check(Y, M: int, T: int, carry):
    if Y.ndim != 3 or Y.shape[1:] != (M, 2):
        raise ValueError(f"Y must be (Nh, {M}, 2), got {tuple(Y.shape)}")
    if M % 2 or T < 1:
        raise ValueError(f"need an even M and T >= 1 (M={M}, T={T})")
    want = (M * T - M // 2, 2)
    if tuple(carry.shape) != want:
        raise ValueError(f"carry must be {want}, got {tuple(carry.shape)}")


def synthesize_block_reference(Y, M: int, T: int, hop0_parity: int, carry,
                               split: int = -1):
    """Plain PyTorch version of the kernel, on any device; split=-1
    takes the channelizer's default (two-stage at M >= 512)."""
    _check(Y, M, T, carry)
    if split < 0:
        split = chz.default_split(M)
    return chz._synthesize_block(Y, M, T, int(hop0_parity) % 2, carry, split)


def thread_columns(M: int, T: int) -> int:
    """Columns of the ring a thread may hold (csrc
    synth_thread_columns): a block's ceil(P/256) (P/C a block in a
    cluster of C), but at most 2 with the ring of T <= 8 (2·8 running sums)
    and 1 with that of 16 (2·16), which T <= 16 and every full chunk of
    a longer filter run (a last chunk of at most 8 taps runs the ring of
    8: ``thread_columns(M, taps)`` of its ``tap_chunks`` entry)."""
    return min(-(-(M // 2 // cluster_blocks(M)) // 256), 2 if T <= 8 else 1)


def column_groups(M: int, T: int) -> int:
    """Column groups of a pass, the grid's first axis (csrc
    synth_groups): ceil(P / (ranks · 256 · thread_columns)), 1 up to M =
    1024 at T <= 8 (512 with the ring of 16, T > 8), each group's block
    (or cluster of ``cluster_blocks(M)`` blocks past 4096)
    transforming the pass's hops itself."""
    return -(-(M // 2) // (cluster_blocks(M) * 256 * thread_columns(M, T)))


def tap_chunks(T: int):
    """(first gain row, taps) of each launch of a T-tap call (csrc
    synth_launch): T itself up to CHUNK_TAPS, else chunks of CHUNK_TAPS
    rows and a last one of the rest; chunk (t0, Tc) adds its Nh + 2Tc - 1
    output hops from hop 2·t0 on."""
    if T <= CHUNK_TAPS:
        return [(0, T)]
    return [(t0, min(CHUNK_TAPS, T - t0)) for t0 in range(0, T, CHUNK_TAPS)]


def chunk_launches(T: int) -> int:
    """Kernel launches of one T-tap call: ceil(T / CHUNK_TAPS)."""
    return len(tap_chunks(T))


def scratch_values(M: int, T: int, Nh: int) -> int:
    """float2 values of the scratch a T-tap call of Nh hops needs (csrc
    synth_scratch_values): none up to CHUNK_TAPS; past it a zero carry of
    2·CHUNK_TAPS - 1 hops, then each chunk's plane of Nh + 2Tc - 1 hops."""
    if T <= CHUNK_TAPS:
        return 0
    return (2 * CHUNK_TAPS - 1 + sum(Nh + 2 * tc - 1
                                     for _, tc in tap_chunks(T))) * (M // 2)


@functools.cache
def _launcher(M: int):
    """The launcher of width M, once its tile constants, column groups and
    scratch sizes are the wrapper's."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = bind("synth", [p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i,
                        p], M, SYNTH_HOPS[M], smem_bytes(M),
              column_groups={(M, T): column_groups(M, T)
                             for T in (8, CHUNK_TAPS, 4 * CHUNK_TAPS)})
    f = build.load(None if M in LIBRARY_WIDTHS else M).synth_scratch_values
    f.argtypes, f.restype = [i, i, i], ctypes.c_longlong
    got = {(T, Nh): f(M, T, Nh) for T, Nh in ((8, 5), (17, 5), (33, 8192))}
    want = {k: scratch_values(M, *k) for k in got}
    if got != want:
        raise RuntimeError(f"synth kernel built for M={M} has the scratch "
                           f"sizes {got}, the wrapper's {want}")
    return fn


@functools.cache
def _gain_taps(M: int, T: int, device: torch.device) -> torch.Tensor:
    """(T, M) prototype taps times P, as the plain version forms them."""
    return (torch.as_tensor(chz.prototype_taps(M, T), device=device)
            .reshape(T, M) * np.float32(M // 2))


def synthesize_block(Y, M: int, T: int, hop0_parity: int, carry):
    """Synthesis of one block: Y (Nh, M, 2) float32 hop-major channel
    basebands, hop0_parity the absolute parity of its first hop, carry
    the (L-P, 2) overlap-add tail of the previous block.  Returns
    (x (Nh*M/2, 2), new carry (L-P, 2)), float32."""
    global LAUNCHES
    if not isinstance(Y, torch.Tensor) or not isinstance(carry, torch.Tensor):
        raise TypeError("Y and carry must be torch.Tensors")
    if Y.device.type == "cpu":
        return synthesize_block_reference(Y, M, T, hop0_parity, carry)
    if Y.device.type != "cuda" or carry.device != Y.device:
        raise ValueError(f"unsupported devices {Y.device}, {carry.device}")
    _check(Y, M, T, carry)
    if Y.dtype != torch.float32 or carry.dtype != torch.float32:
        raise ValueError("Y and carry must be float32")
    check_fft_width(M)
    Y = Y.contiguous()
    carry = carry.contiguous()
    if Y.data_ptr() % 8 or carry.data_ptr() % 8:
        # the kernel reads both as float2
        raise ValueError("Y and carry must be 8-byte aligned")
    dev = Y.device
    Nh = Y.shape[0]
    gm = _gain_taps(M, T, dev)
    if route_length(M):
        out = route.synth(Y, gm, carry, M, T, Nh, hop0_parity)
        LAUNCHES += 1
        return out
    _, tw = _tables(M, T, dev)
    out = torch.empty((Nh * (M // 2), 2), dtype=torch.float32, device=dev)
    new_carry = torch.empty_like(carry)
    n = scratch_values(M, T, Nh)
    scratch = torch.empty((n, 2), dtype=torch.float32, device=dev) \
        if n else None
    launch("synth", _launcher(M), dev, Y.data_ptr(), tw.data_ptr(),
           gm.data_ptr(), carry.data_ptr(), out.data_ptr(),
           new_carry.data_ptr(), scratch.data_ptr() if n else None, n, M, T,
           Nh, int(hop0_parity) % 2)
    LAUNCHES += chunk_launches(T)
    return out, new_carry
