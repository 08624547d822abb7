"""Analysis channelizer: polyphase fold + M-point DFT of one streaming
block, writing the channel-major baseband planes; and what the front-end
kernels built on this analysis share.

``analyze_block`` is the wrapper: a CUDA tensor launches the
hand-written kernel in ``csrc/analysis.cu`` (the Hopper port of
``amps_tpu/pallas/channelizer_kernel.py::analyze_chmajor_pallas``,
without its even-parity and whole-tile limits) or raises; a CPU tensor
computes the kernel's plain version, ``analyze_reference``.  There is no
fallback from one to the other.  ``dsp.channelizer.analyze`` calls the
wrapper.

All four kernels run one all-channel FFT tile (``csrc/analysis_fft.cuh``):
a thread block folds each of its hops once, any number of taps T (past
``CHUNK_TAPS`` in chunks of that many) (or, for the synthesis in
``kernels.synth``, loads hop-major rows of channel basebands) and
transforms them with an f32 Stockham FFT whose radices are
``fft_radices(M)`` (mixed radix: 16, then 2, 4 or 8, then the odd prime
factors of M) and whose twiddles are the table of ``_tables``; M is any
width in ``FFT_WIDTHS``: every even M from 2 to 16384, and past it M =
C·N with C <= 8 and N <= 4096, up to 32768.  Every other even M (the
4432 unsplit widths in (16384, 32768] and every M past 32768) runs the
device-memory route of ``kernels.route`` (csrc/route.cu): the hops of a
chunk folded into a scratch plane, a Stockham FFT of length
``route_length(M)`` in passes of radix ``route_radices(L)`` between two
planes (direct at a power of two, Bluestein's chirp convolution
elsewhere), then each kernel's epilogue; ``check_fft_width`` refuses
only odd M and M < 2.  Past ``BLOCK_WIDTH`` (4096)
a cluster of ``fft_cluster_size(M)`` = C thread blocks (the smallest
divisor of M from 2 to ``CLUSTER_SIZE`` with M/C <= 4096) shares each
hop: each block transforms its part at ``fft_plan_width(M)`` = M/C and a
radix-C pass across the cluster, through distributed shared memory,
leaves each block a contiguous range of M/C channels.  The even widths
in (8192, 16384] that no such cluster splits (937 of them, 8194 the
first: ``bluestein_length(M)`` = 32768) run Bluestein's chirp transform,
a circular convolution of length 32768 on a cluster of
``cluster_blocks(M)`` = 8 blocks of 4096 points (the split width 32768's
transform, forward and, decimated in frequency, inverse), block r
holding the ``fft_block_channels(M)`` channels 8c + r < M; its tables
(``bluestein_tables``) follow the twiddles of length 32768.  The powers
of two up to 4096 live in the main library; any other width, every
cluster width among them, builds a library of its own at first use
(``kernels.build``).  The analysis kernel takes ``FFT_TILE_HOPS[M]``
hops a block, the receive front ends (``kernels.rx_front``,
``kernels.rx_phases``) and the synthesis ``FFT_WIDE_HOPS[M]``; a block's
shared memory is ``fft_smem_bytes`` (the plane, and up to
``SHARED_TWIDDLE_WIDTH`` the twiddle table; past it the passes read the
table from device memory).  The front ends' plain versions start from
``analyze_reference``, and the wrappers share ``card_block`` (the checks
of an input block on the card), ``bind`` and ``launch``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from amps_tpu_torch.dsp.polyphase import (DENSE_MAX_WIDTH, _analysis_consts,
                                         _hop_sign, fft_rows, prototype_taps)
from amps_tpu_torch.kernels import build

# taps per phase one chunk of the fold holds in registers, and the gain
# rows of one chunk launch of the synthesis (csrc kFftChunkT); a longer
# filter runs in chunks of this many
CHUNK_TAPS = 16
# the widest transform one thread block runs (csrc kFftBlockWidth); past
# it a cluster of up to CLUSTER_SIZE blocks (the portable cluster size)
# shares each hop
BLOCK_WIDTH = 4096
CLUSTER_SIZE = 8           # csrc kFftClusterSize
MAX_FFT_WIDTH = CLUSTER_SIZE * BLOCK_WIDTH   # csrc kFftMaxWidth
# M the main library instantiates: the powers of two up to BLOCK_WIDTH;
# every other width builds a library of its own at first use
LIBRARY_WIDTHS = tuple(1 << b for b in range(1, 13))
# plane bytes a block of the analysis kernel may hold at a width up to
# 2048 that is not a power of two (csrc kFftPlaneBudget): ~100 KB, M =
# 1024's plane
PLANE_BUDGET = 102400
# shared memory a Hopper block may opt in to (csrc kFftMaxSmem)
SMEM_BYTES = 232448
# the widest M whose twiddle table sits in a block's shared memory
# (csrc kFftSharedTwiddleWidth); past it the passes read it from device
# memory
SHARED_TWIDDLE_WIDTH = 2048


def fft_cluster_size(M: int) -> int:
    """Blocks of a cluster that share each hop at width M (csrc
    fft_ranks): 1 up to BLOCK_WIDTH; past it the smallest C from 2 to
    CLUSTER_SIZE that divides M with M/C <= BLOCK_WIDTH (2 for every even
    M up to 8192), or 0 where there is none (M not taken)."""
    if M <= BLOCK_WIDTH:
        return 1
    return next((C for C in range(2, CLUSTER_SIZE + 1)
                 if M % C == 0 and M // C <= BLOCK_WIDTH), 0)


def bluestein_length(M: int) -> int:
    """The length L of Bluestein's chirp transform at width M (csrc
    fft_bluestein): MAX_FFT_WIDTH (32768 >= 2M - 1) for every even M up
    to MAX_FFT_WIDTH / 2 that no cluster splits (``fft_cluster_size(M)``
    0: 937 widths in (8192, 16384], 8194 the first), else 0."""
    return MAX_FFT_WIDTH if (M % 2 == 0 and 2 <= M <= MAX_FFT_WIDTH // 2
                             and not fft_cluster_size(M)) else 0


def cluster_blocks(M: int) -> int:
    """Blocks of the cluster that runs width M (csrc fft_blocks): the
    split's ``fft_cluster_size(M)``, or in the Bluestein mode those of its
    length L (CLUSTER_SIZE)."""
    L = bluestein_length(M)
    return fft_cluster_size(L) if L else fft_cluster_size(M)


def fft_plan_width(M: int) -> int:
    """The width of one block's transform (csrc fft_width): M, or M/C in
    a cluster of C, or in the Bluestein mode L/C (BLOCK_WIDTH)."""
    return (bluestein_length(M) or M) // cluster_blocks(M)


def fft_block_channels(M: int) -> int:
    """Plane positions of a block that hold channels (csrc
    fft_channels): ``fft_plan_width(M)``, or in the Bluestein mode
    ceil(M/C), position c of rank r holding channel C·c + r where that
    is below M."""
    C = cluster_blocks(M)
    return -(-M // C) if bluestein_length(M) else fft_plan_width(M)


# M the FFT tile takes: every even width from 2 to 16384 (491.46 Msps at
# 16382) -- up to 8192 split or whole, past it the M = C·N that a cluster
# of C <= 8 blocks of N <= 4096 channels splits and, for the rest,
# Bluestein's chirp transform of length 32768 on a cluster of 8 --, and
# past 16384 the split widths up to 32768 (983.04 Msps)
FFT_WIDTHS = tuple(M for M in range(2, MAX_FFT_WIDTH + 1, 2)
                   if fft_cluster_size(M) or bluestein_length(M))

# the device-memory route (``kernels.route``, csrc/route.cu): the radices
# of its passes run from ROUTE_MIN_RADIX to ROUTE_MAX_RADIX (csrc
# kRouteMinRadix, kRouteMaxRadix)
ROUTE_MIN_RADIX = 256
ROUTE_MAX_RADIX = 4096


def route_length(M: int) -> int:
    """The length L of the device-memory route's FFT at width M (csrc
    route.cu), for every even M >= 2 that no in-shared-memory mode takes
    (not in ``FFT_WIDTHS``: the 4432 unsplit even widths in (16384, 32768]
    and every M past 32768): M itself where M is a power of two (direct),
    else the least power of two >= 2M - 1 (Bluestein's chirp transform:
    65536 up to 32768, 131072 at 32770); 0 for every other M."""
    if M % 2 or M < 2 or fft_cluster_size(M) or bluestein_length(M):
        return 0
    return M if M & (M - 1) == 0 else 1 << (2 * M - 2).bit_length()


def route_radices(L: int, max_radix: int = ROUTE_MAX_RADIX):
    """The radices of the route's Stockham passes at length L = 2^k (csrc
    route_radix): ceil(k / log2(max_radix)) passes, the k bits split as
    evenly as they go, the larger shares first (two passes up to 2^24 at
    4096, three past it; (256, 256) at L = 65536)."""
    k, b = L.bit_length() - 1, max_radix.bit_length() - 1
    n = -(-k // b)
    return tuple(1 << (k // n + (p < k % n)) for p in range(n))


def _fit_hops(M: int) -> int:
    """csrc fft_fit_hops: the most even hops (up to 16) whose plane fits
    in a block's shared memory (6 at M = 4096, and 6 of a block's plane
    of M/C at 8192 and 16384)."""
    return min(16, SMEM_BYTES // (8 * fft_hop_stride(fft_plan_width(M)))
               & ~1)


def _tile_hops(M: int) -> int:
    """csrc fft_tile_hops: ~100 KB of shared plane at M = 1024, so two
    blocks share an SM; at a width up to 2048 that is not a power of two
    the most even hops (2 .. 16) whose plane fits in PLANE_BUDGET; past
    2048 ``_fit_hops``."""
    if M > SHARED_TWIDDLE_WIDTH:
        return _fit_hops(M)
    if M & (M - 1) == 0:
        return 16 if M <= 512 else 12 if M == 1024 else 4
    h = PLANE_BUDGET // (8 * fft_hop_stride(M))
    return 16 if h >= 16 else max(2, h & ~1)


def fft_hop_stride(M: int) -> int:
    """Complex values a hop's row takes in the plane: one float2 of
    padding every 32 (csrc fft_hop_stride)."""
    return M + M // 32 + 1


# analysis hops a block of the FFT tile computes (csrc fft_tile_hops)
FFT_TILE_HOPS = {M: _tile_hops(M) for M in FFT_WIDTHS}
# hops a block of the kernels with a heavier epilogue computes (csrc
# fft_wide_hops): twice as many up to 2048, to fill the sectors of 4-byte
# rows; past it as many as the analysis kernel's
FFT_WIDE_HOPS = {M: 2 * h if M <= SHARED_TWIDDLE_WIDTH else h
                 for M, h in FFT_TILE_HOPS.items()}

# kernel launches since import (or since the caller last reset it);
# incremented only where the kernel is launched
LAUNCHES = 0


def block_geometry(x_ext: torch.Tensor, M: int, T: int):
    """(planar, n_ext, Nh) of one history-prepended input block of the
    front-end kernels: (n_ext, 2) riq or (2, n_ext) planar planes, whole
    hops of M/2 samples, at least one hop past the history."""
    planar = x_ext.ndim == 2 and x_ext.shape[0] == 2 and x_ext.shape[1] != 2
    if not planar and not (x_ext.ndim == 2 and x_ext.shape[1] == 2):
        raise ValueError(f"x_ext must be (n, 2) or (2, n), got "
                         f"{tuple(x_ext.shape)}")
    P = M // 2
    n_ext = x_ext.shape[1] if planar else x_ext.shape[0]
    if M % 2 or n_ext % P:
        raise ValueError(f"x_ext length {n_ext} is not a multiple of the "
                         f"hop {P}")
    Nh = n_ext // P - (2 * T - 1)
    if Nh < 1:
        raise ValueError(f"x_ext of {n_ext} samples holds no hop past the "
                         f"history")
    return planar, n_ext, Nh


def _fold_banks(x_ext: torch.Tensor, M: int, T: int, planar_in: bool):
    """Polyphase fold of the bank path: (..., 2, Nh, P) even and odd
    parity banks as T shifted multiply-adds over P-sample blocks
    (sample nP + tM + q_w lives in block n + 2t (+1 if q_w >= P))."""
    P = M // 2
    n_ext = x_ext.shape[-1 if planar_in else -2]
    Nh = (n_ext - (M * T - P)) // P
    nblk = n_ext // P
    batch = x_ext.shape[:-2]
    if planar_in:
        xpl = x_ext[..., : nblk * P]
    else:
        xpl = x_ext[..., : nblk * P, :].transpose(-1, -2)
    bl = xpl.reshape(batch + (2, nblk, P)).to(torch.float32)
    coef = fold_coef(M, T, bl.device) if M > DENSE_MAX_WIDTH else \
        _analysis_consts(M, T, bl.device)[0]
    ke, ko = coef[:, :P], coef[:, P:]
    acc_e = ke[0] * bl[..., 0:Nh, :]
    acc_o = ko[0] * bl[..., 1:1 + Nh, :]
    for t in range(1, T):
        acc_e = acc_e + ke[t] * bl[..., 2 * t: 2 * t + Nh, :]
        acc_o = acc_o + ko[t] * bl[..., 2 * t + 1: 2 * t + 1 + Nh, :]
    return acc_e, acc_o, Nh


def analyze_reference(x_ext, M: int, T: int, hop0_parity: int = 0,
                      planar: bool = False, planar_in: bool = False):
    """Plain PyTorch version of the kernel, on any device: x_ext
    (..., L-P+N, 2) riq with the history prepended (N = Nh*P), or
    (..., 2, L-P+N) planar planes when ``planar_in``.  Returns Y
    (..., M, Nh, 2) channel-major, or (..., 2, M, Nh) when ``planar``.
    The transform runs in float32 on the dense tables; past
    DENSE_MAX_WIDTH it is the float64 FFT of the folded windows f_n =
    (even bank, odd bank) (``fft_rows``), cast to f32, then the hop sign:
    y_k[n] = (-1)^{k(n+parity)} sum_m f_n[m] e^{-j2πkm/M}."""
    acc_e, acc_o, Nh = _fold_banks(x_ext, M, T, planar_in)
    if M > DENSE_MAX_WIDTH:
        f = torch.cat([acc_e, acc_o], dim=-1)              # (..., 2, Nh, M)
        yr2, yi2 = (t.transpose(-1, -2)
                    for t in fft_rows(f[..., 0, :, :], f[..., 1, :, :]))
        del f
        sgn = _hop_sign(M, Nh, int(hop0_parity) % 2, acc_e.device)
        if planar:
            return torch.stack([yr2 * sgn, yi2 * sgn], dim=-3)
        return torch.stack([yr2 * sgn, yi2 * sgn], dim=-1)
    er, ei = acc_e[..., 0, :, :], acc_e[..., 1, :, :]
    or_, oi = acc_o[..., 0, :, :], acc_o[..., 1, :, :]
    _, Co, So, Ce, Se, rc, rs = _analysis_consts(M, T, acc_e.device)

    def dot(A, v):   # einsum("kq,...nq->...kn")
        return A @ v.transpose(-1, -2)

    yr = dot(Co, or_) - dot(So, oi) + dot(Ce, er) - dot(Se, ei)
    yi = dot(So, or_) + dot(Co, oi) + dot(Se, er) + dot(Ce, ei)
    yr2 = yr * rc - yi * rs
    yi2 = yr * rs + yi * rc
    sgn = _hop_sign(M, Nh, int(hop0_parity) % 2, acc_e.device)
    if planar:
        return torch.stack([yr2 * sgn, yi2 * sgn], dim=-3)
    return torch.stack([yr2 * sgn, yi2 * sgn], dim=-1)


def fft_radices(M: int):
    """The radices of the FFT tile's Stockham passes, in pass order (csrc
    fft_radix): for M = 2^a · r, r odd, 16 while four bits of 2^a remain,
    then one pass of 2, 4 or 8, then the odd prime factors of r
    ascending.  A power of two keeps the radix-16 plan alone."""
    a = (M & -M).bit_length() - 1
    out = [16] * (a // 4) + ([1 << a % 4] if a % 4 else [])
    r, q = M >> a, 3
    while r > 1:
        if r % q:
            q += 2
        else:
            out.append(q)
            r //= q
    return tuple(out)


def fft_generic(R: int) -> bool:
    """A prime radix with no register butterfly, which the generic pass
    runs (csrc fft_generic)."""
    return R % 2 == 1 and R > 7


# the register butterflies' constants at the head of the twiddle table,
# as (R, powers): W_16^1..3 always, W_3, W_5^1..2 and W_7^1..3 where M is
# not a power of two (csrc fft_head_size, fft_head_offset)
FFT_HEAD = ((16, (1, 2, 3)), (3, (1,)), (5, (1, 2)), (7, (1, 2, 3)))


def fft_twiddle_exponents(M: int) -> np.ndarray:
    """The exponents e of the FFT tile's twiddle table W_M^e (csrc
    fft_twiddle_offset, fft_table_size).  In the Bluestein mode: those of
    its length L, as W_L^e (the chirp and the convolution's transform
    follow them in the table: ``bluestein_tables``).  In a cluster of C
    (M past BLOCK_WIDTH): the table of the block's width N = M/C, its W_N^e as
    W_M^{Ce}, then the pass across the cluster's W_M^{s·c} for 1 <= s <
    C, c < N (s-major; at C = 2 the combine's W_M^c), and past C = 2 the
    constants W_C^e = W_M^{eN}, e < C.  Otherwise: the head,
    j·M/R for the powers j of each radix R
    of FFT_HEAD (only W_16's where M is a power of two; taken as ⌊j·M/R⌋,
    whole wherever R is in the plan, the only place a butterfly reads
    it: at M = 8 only W_16^2 = W_8^1), then for each register pass after
    the first, with Ns the product of the earlier radices, the
    (R-1) x Ns block jm·r·M/(Ns·R) for r = 1 .. R-1, jm < Ns; where the
    plan has a generic pass, every e < M last."""
    if bluestein_length(M):
        return fft_twiddle_exponents(bluestein_length(M))
    C = fft_cluster_size(M)
    if C > 1:
        N = M // C
        s, c = np.meshgrid(np.arange(1, C), np.arange(N), indexing="ij")
        w_c = np.arange(C) * N if C > 2 else np.zeros(0, np.int64)
        return np.concatenate([C * fft_twiddle_exponents(N),
                               (s * c).ravel(), w_c]).astype(np.int64)
    heads = FFT_HEAD[:1] if M & (M - 1) == 0 else FFT_HEAD
    out = [j * M // R for R, js in heads for j in js]
    ns = 1
    for p, R in enumerate(fft_radices(M)):
        if p and not fft_generic(R):
            r = np.arange(1, R)[:, None]
            jm = np.arange(ns)[None, :]
            out.extend((jm * r * (M // (ns * R))).ravel().tolist())
        ns *= R
    if any(fft_generic(R) for R in fft_radices(M)):
        out.extend(range(M))
    return np.asarray(out, dtype=np.int64)


def fft_smem_bytes(M: int, H: int) -> int:
    """Shared memory of a block of H hops at width M (csrc
    fft_smem_bytes): the plane of the block's fft_plan_width(M) channels,
    and up to SHARED_TWIDDLE_WIDTH the twiddle table."""
    table = len(fft_twiddle_exponents(M)) if M <= SHARED_TWIDDLE_WIDTH else 0
    return 8 * (H * fft_hop_stride(fft_plan_width(M)) + table)


def bluestein_exponents(M: int) -> np.ndarray:
    """n² mod 2M for n < M, in exact integers (int64): the chirp w[n] =
    e^{-jπn²/M} = e^{-jπ(n² mod 2M)/M}."""
    n = np.arange(M, dtype=np.int64)
    return n * n % (2 * M)


def bluestein_tables(M: int):
    """Bluestein's tables at width M in float64 (csrc FftTile::chirp_in,
    icross, chirp_out): the chirp w[n] = e^{-jπn²/M}, n < M, its angle
    from n² mod 2M in exact integers (n² reaches 2.7e8, past f32's 2^24),
    laid out in the C rows of ``fft_block_channels(M)`` of the ranks
    (row r: w[C·c + r], zero past M); and B = FFT_L(b) / L of the
    conjugate chirp b[n] = conj(w[|n|]), |n| < M, wrapped to L - n, so
    that the M-point DFT is X[k] = w[k] sum_n x[n] w[n] b[k - n]."""
    L, C, NC = bluestein_length(M), cluster_blocks(M), fft_block_channels(M)
    n = np.arange(M, dtype=np.int64)
    w = np.exp(-1j * np.pi * bluestein_exponents(M) / M)
    rows = np.zeros(C * NC, np.complex128)
    rows[(n % C) * NC + n // C] = w
    b = np.zeros(L, np.complex128)
    b[:M] = np.conj(w)
    b[L - n[1:]] = np.conj(w[1:])
    return rows, np.fft.fft(b) / L


@functools.cache
def _fft_twiddles(M: int) -> np.ndarray:
    """(n, 2) float32 twiddle table W_M^e = e^{-j2πe/M} at the exponents
    of ``fft_twiddle_exponents``: the angle in float64 from e reduced mod
    M, cast to f32, as ``_dft_mats`` builds its tables.  In the Bluestein
    mode: the table of its length L, then the chirp's rows and B of
    ``bluestein_tables``, each cast from float64 to f32."""
    L = bluestein_length(M)
    if L:
        parts = [np.stack([z.real, z.imag], axis=-1)
                 for z in bluestein_tables(M)]
        return np.concatenate([_fft_twiddles(L), *parts]).astype(np.float32)
    ang = 2.0 * np.pi * (fft_twiddle_exponents(M) % M) / M
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)


@functools.cache
def fold_coef(M: int, T: int, device: torch.device) -> torch.Tensor:
    """The fold coefficients coef[t, m] = h[M·T - 1 - (tM + m)] (T, M) on
    device: the prototype's taps reversed, as the FFT tile's fold
    (``_tables``) and the device-memory route's read them."""
    return torch.as_tensor(np.ascontiguousarray(
        prototype_taps(M, T)[::-1]).reshape(T, M), device=device)


@functools.cache
def _tables(M: int, T: int, device: torch.device):
    """The FFT tile's tables on device: fold coefficients coef[t, m] =
    h[M·T - 1 - (tM + m)] (T, M), the prototype's taps reversed as
    ``dsp.polyphase._analysis_consts`` takes them (without the plain
    version's dense matrices; ``fold_coef``), and the twiddle table of
    ``_fft_twiddles``."""
    return (fold_coef(M, T, device),
            torch.as_tensor(_fft_twiddles(M), device=device))


def check_fft_width(M: int) -> None:
    """The kernels take every even M >= 2: ``FFT_WIDTHS`` in shared
    memory (every even M from 2 to 16384 -- past 8192 split, or else
    Bluestein's chirp transform of length MAX_FFT_WIDTH --, and past 16384
    M = C·N with C <= CLUSTER_SIZE and N <= BLOCK_WIDTH up to
    MAX_FFT_WIDTH), and every other even M on the device-memory route
    (``route_length``).  Odd M and M < 2 raise ValueError."""
    if M % 2 or M < 2:
        raise ValueError(
            f"kernel needs an even M from 2 to {MAX_FFT_WIDTH // 2} (past "
            f"{2 * BLOCK_WIDTH} split, or Bluestein's chirp transform of "
            f"length {MAX_FFT_WIDTH}), or M = C·N with C <= {CLUSTER_SIZE} "
            f"and N <= {BLOCK_WIDTH} up to {MAX_FFT_WIDTH}, in shared memory, "
            f"or any other even M >= 2 through device memory (M={M})")


def card_block(x_ext: torch.Tensor, M: int, T: int):
    """The checks every front-end kernel makes of its input block on the
    card: a contiguous float32 CUDA tensor of whole hops (``block_geometry``),
    T >= 1 (past CHUNK_TAPS the fold runs in chunks), and the alignment of
    its layout (8 bytes riq, 4 planar).  Each wrapper checks M against its
    own tile.  Returns (planar, n_ext, Nh)."""
    if x_ext.device.type != "cuda":
        raise ValueError(f"unsupported device {x_ext.device}")
    if x_ext.dtype != torch.float32 or not x_ext.is_contiguous():
        raise ValueError("x_ext must be contiguous float32")
    if T < 1:
        raise ValueError(f"kernel needs T >= 1 (T={T})")
    planar, n_ext, Nh = block_geometry(x_ext, M, T)
    if x_ext.data_ptr() % (4 if planar else 8):
        raise ValueError("x_ext must be 8-byte aligned (interleaved) or "
                         "4-byte aligned (planar)")
    return planar, n_ext, Nh


def bind(prefix: str, argtypes, M: int, hops: int, smem: int, **consts):
    """The launcher ``{prefix}_launch`` of the library that holds width M
    (the main library for a power of two up to 4096, else M's own, built
    at first use) with its argument types (it returns a cudaError_t),
    once the library's tile constants at M are the wrapper's: its hops
    (``{prefix}_tile_hops``), a block's shared memory
    (``{prefix}_smem_bytes``), its FFT plan at ``fft_plan_width(M)``,
    pass by pass (``{prefix}_fft_passes``, ``{prefix}_fft_radix``), its
    cluster size (``{prefix}_cluster_size``), its chirp transform's length
    (``{prefix}_bluestein_length``), and each of ``consts``
    (name: {int arguments: value} of ``{prefix}_{name}``).  At a cluster
    width (a cluster of 2 to 8 blocks, the Bluestein widths among them)
    the card must hold at least one
    cluster of the kernel
    (``{prefix}_max_clusters``, cudaOccupancyMaxActiveClusters), or this
    raises: such a width never falls back."""
    lib = build.load(None if M in LIBRARY_WIDTHS else M)
    fn = getattr(lib, f"{prefix}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int

    def const(name, *args):
        f = getattr(lib, f"{prefix}_{name}")
        f.argtypes, f.restype = [ctypes.c_int] * len(args), ctypes.c_int
        return f(*args)

    want = {"tile_hops": hops, "smem_bytes": smem,
            "plan": fft_radices(fft_plan_width(M)),
            "cluster_size": cluster_blocks(M),
            "bluestein_length": bluestein_length(M), **consts}
    got = {"tile_hops": const("tile_hops", M),
           "smem_bytes": const("smem_bytes", M),
           "plan": tuple(const("fft_radix", M, p)
                         for p in range(const("fft_passes", M))),
           "cluster_size": const("cluster_size", M),
           "bluestein_length": const("bluestein_length", M),
           **{name: {args: const(name, *args) for args in values}
              for name, values in consts.items()}}
    if got != want:
        raise RuntimeError(f"{prefix} kernel built for M={M} has the tile "
                           f"constants {got}, the wrapper's {want}")
    if cluster_blocks(M) > 1:
        n = max_clusters(prefix, M)
        if n <= 0:
            raise RuntimeError(f"{prefix} kernel at M={M}: the card holds "
                               f"no cluster of {cluster_blocks(M)} blocks "
                               f"of {smem} bytes (cudaOccupancyMaxActive"
                               f"Clusters: {n})")
    return fn


def max_clusters(prefix: str, M: int) -> int:
    """Clusters of kernel ``prefix`` at cluster width M that the current
    card holds at once (``{prefix}_max_clusters``)."""
    lib = build.load(None if M in LIBRARY_WIDTHS else M)
    f = getattr(lib, f"{prefix}_max_clusters")
    f.argtypes, f.restype = [ctypes.c_int], ctypes.c_int
    return f(M)


def probe_clusters(M: int, blocks: int) -> int:
    """Clusters of ``blocks`` blocks of the analysis kernel at width M (its
    shared memory a block) that the current card holds at once with
    cluster sizes past the portable 8 allowed (``analysis_probe_clusters``,
    cudaOccupancyMaxActiveClusters): a probe of the card's limit for a
    chirp transform longer than a cluster of 8 holds.  Launches
    nothing."""
    f = build.load(None if M in LIBRARY_WIDTHS else M).analysis_probe_clusters
    f.argtypes, f.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return f(M, blocks)


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the launcher ``fn`` with ``args`` and the device's current
    stream; raise if it returns a CUDA error."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


@functools.cache
def _launcher(M: int):
    p, i = ctypes.c_void_p, ctypes.c_int
    return bind("analysis", [p, i, ctypes.c_longlong, p, p, p, i, i, i, i,
                             i, p], M, FFT_TILE_HOPS[M],
                fft_smem_bytes(M, FFT_TILE_HOPS[M]))


def analyze_block(x_ext, M: int, T: int, hop0_parity: int = 0,
                  planar: bool = False, planar_in: bool = False):
    """Analysis of one streaming block (on the card any even M: the FFT
    tile, or past its widths the device-memory route).

    x_ext: (..., (Nh + 2T - 1) * M/2, 2) float32 riq, or (..., 2, ...)
    planar planes when ``planar_in``, with the analyzer history already
    prepended; hop0_parity the absolute parity of the block's first hop.
    Returns Y (..., M, Nh, 2) float32, or (..., 2, M, Nh) when
    ``planar``: y_k[n] = (-1)^{k(n+parity)} sum_m f_n[m] e^{-j2πkm/M} of
    the folded hop-n window f_n.  On the card each row of the leading
    dimensions is one launch."""
    global LAUNCHES
    if not isinstance(x_ext, torch.Tensor):
        raise TypeError("x_ext must be a torch.Tensor")
    if x_ext.device.type == "cpu":
        return analyze_reference(x_ext, M, T, hop0_parity, planar, planar_in)
    if x_ext.ndim > 2:
        rows = x_ext.reshape((-1,) + tuple(x_ext.shape[-2:]))
        ys = [analyze_block(r, M, T, hop0_parity, planar, planar_in)
              for r in rows.unbind(0)]
        return torch.stack(ys).reshape(tuple(x_ext.shape[:-2])
                                       + tuple(ys[0].shape))
    check_fft_width(M)
    is_planar, n_ext, Nh = card_block(x_ext, M, T)
    if is_planar != planar_in:
        raise ValueError(f"x_ext of shape {tuple(x_ext.shape)} with "
                         f"planar_in={planar_in}")
    dev = x_ext.device
    if route_length(M):
        from amps_tpu_torch.kernels import route
        y = route.analysis(x_ext, fold_coef(M, T, dev), M, T, Nh, n_ext,
                           planar_in, planar, hop0_parity)
        LAUNCHES += 1
        return y
    coef, tw = _tables(M, T, dev)
    y = torch.empty((2, M, Nh) if planar else (M, Nh, 2),
                    dtype=torch.float32, device=dev)
    launch("analysis", _launcher(M), dev, x_ext.data_ptr(), int(planar_in),
           n_ext, coef.data_ptr(), tw.data_ptr(), y.data_ptr(), int(planar),
           M, T, Nh, int(hop0_parity) % 2)
    LAUNCHES += 1
    return y
