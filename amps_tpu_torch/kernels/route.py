"""The device-memory route of the four kernels: every even bank width
that no in-shared-memory mode of the FFT tile takes
(``kernels.analysis.route_length(M)`` > 0: the 4432 unsplit even widths
in (16384, 32768] and every M past 32768).

The wrappers of ``kernels.analysis``, ``kernels.rx_front``,
``kernels.rx_phases`` and ``kernels.synth`` hand such a width on a CUDA
tensor to ``analysis``, ``front``, ``phases`` or ``synth`` here, which
launch ``csrc/route.cu`` (main library): each folds (K1-K3) or loads (K4)
the hops of a chunk into a scratch plane in device memory, transforms
the plane with a Stockham FFT of length L = ``route_length(M)`` run as
passes of radix ``route_radices(L)`` between two planes -- directly where
M is a power of two, as Bluestein's chirp convolution elsewhere --, and
ends in its kernel's epilogue.  There is no per-width library: M, L and
T are runtime arguments.

The tables (``tables``, cached per width and device): W_L^e for e < L
and the FFT tile's tables at the radices 256 .. 4096 (``_fft_twiddles``);
in the Bluestein mode the chirp w[n] = e^{-jπn²/M}, its angle from n² mod
2M in exact 64-bit integers and float64, and B̂ = FFT_L(b) / L of the
conjugate chirp from a float64 FFT on the host; each cast once to f32.
The scratch (``scratch_rows``) is two planes of rows of L values under
``SCRATCH_BYTES`` whatever Nh is, taken from the caching allocator, so a
call captured in a CUDA graph allocates only from the graph's pool and
builds nothing once the tables exist.

A call of a wrapper on the route is one call of its ``LAUNCHES`` (K1-K4
alike); ``launches(M, Nh, behind)`` gives the CUDA kernels it runs, in
``chunks(M, Nh, behind)`` chunks.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from amps_tpu_torch.kernels import build
from amps_tpu_torch.kernels.analysis import (ROUTE_MAX_RADIX,
                                             ROUTE_MIN_RADIX, _fft_twiddles,
                                             bluestein_exponents, launch,
                                             route_length, route_radices)

# bytes of the two scratch planes of a call, whatever its hops (at L =
# 65536: 1024 rows a plane; at L = 2^25: 2)
SCRATCH_BYTES = 1 << 30
# K3's longest symbol on the route (csrc kRouteMaxSps)
MAX_SPS = 16
# the radices whose tile tables the passes read, in the order of their
# concatenation (csrc route_tile_offset)
RADICES = tuple(1 << b for b in range(ROUTE_MIN_RADIX.bit_length() - 1,
                                      ROUTE_MAX_RADIX.bit_length()))


def route_hops(R: int) -> int:
    """Butterflies a block of a pass of radix R takes, the FFT tile's
    hops (csrc route_hops): 16 up to 1024, 8 at 2048, 4 at 4096."""
    return 16 if R <= 1024 else 8 if R == 2048 else 4


def scratch_rows(L: int) -> int:
    """Rows of L complex values a scratch plane holds: two planes within
    SCRATCH_BYTES, at least 2 (K2 and K3 keep the hop behind a chunk)."""
    return max(2, SCRATCH_BYTES // (2 * 8 * L))


def chirp(M: int) -> np.ndarray:
    """w[n] = e^{-jπn²/M}, n < M, complex128: the angle π(n² mod 2M)/M from
    n² mod 2M in exact integers (n² passes 2^31 from n = 46341 and 2^53
    near 9.5e7, so it is never formed in int32 or a float)."""
    return np.exp(-1j * np.pi * bluestein_exponents(M) / M)


def bhat(M: int, L: int) -> np.ndarray:
    """B̂ = FFT_L(b) / L, complex128, of the conjugate chirp b[n] =
    conj(w[|n|]) for |n| < M, wrapped to L - n (float64 FFT)."""
    w = chirp(M)
    b = np.zeros(L, np.complex128)
    b[:M] = np.conj(w)
    b[L - np.arange(1, M)] = np.conj(w[1:])
    return np.fft.fft(b) / L


def _riq(z: np.ndarray) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


@functools.cache
def twiddles_l(L: int) -> np.ndarray:
    """(L, 2) float32 W_L^e = e^{-j2πe/L}, e < L: the angle in float64,
    cast once to f32."""
    ang = 2.0 * np.pi * np.arange(L) / L
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)


@functools.cache
def tables(M: int, device: torch.device):
    """The route's tables at width M on ``device``: (L, W_L (L, 2), the
    concatenated tile tables of RADICES, chirp (M, 2) or None, B̂ (L, 2)
    or None), the last two in the Bluestein mode (M not L)."""
    L = route_length(M)
    if not L:
        raise ValueError(f"M={M} is not a width of the device-memory route")

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    tile = np.concatenate([_fft_twiddles(R) for R in RADICES])
    if L == M:
        return L, dev(twiddles_l(L)), dev(tile), None, None
    return (L, dev(twiddles_l(L)), dev(tile), dev(_riq(chirp(M))),
            dev(_riq(bhat(M, L))))


def chunks(M: int, Nh: int, behind: int) -> int:
    """Chunks of one call on the route at width M over Nh hops: a chunk
    is a plane's rows, less the hop behind it for K2 and K3 (``behind``
    1, else 0)."""
    return -(-Nh // (scratch_rows(route_length(M)) - behind))


def launches(M: int, Nh: int, behind: int) -> int:
    """CUDA kernels of one call on the route at width M over Nh hops: a
    fold (or load), the passes (twice in the Bluestein mode) and the
    epilogue a chunk.  K3 runs this for each band."""
    L = route_length(M)
    passes = len(route_radices(L)) * (1 if L == M else 2)
    return chunks(M, Nh, behind) * (2 + passes)


@functools.cache
def _lib():
    """The main library's route launchers, once its plan, block hops and
    tile tables are the wrapper's."""
    lib = build.load()
    i, q = ctypes.c_int, ctypes.c_longlong

    def const(name, argtypes, *args):
        f = getattr(lib, name)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        return f(*args)

    Ls = [1 << k for k in range(16, 31)]
    got = {"plan": {L: tuple(const("route_fft_radix", [q, i], L, p)
                             for p in range(const("route_fft_passes", [q],
                                                  L))) for L in Ls},
           "hops": {R: const("route_block_hops", [i], R) for R in RADICES},
           "tile": const("route_tile_values", []),
           "sps": const("route_max_sps", [])}
    want = {"plan": {L: route_radices(L) for L in Ls},
            "hops": {R: route_hops(R) for R in RADICES},
            "tile": sum(len(_fft_twiddles(R)) for R in RADICES),
            "sps": MAX_SPS}
    if got != want:
        raise RuntimeError(f"the route's kernels were built with {got}, the "
                           f"wrapper's {want}")
    return lib


@functools.cache
def _launcher(name: str):
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tabs = [p, p, p, p, q]
    argtypes = {
        "route_analysis_launch": [p, i, q, p, *tabs, p, i, i, i, i, i, p,
                                  i, p],
        "route_front_launch": [p, i, q, p, *tabs, p, p, p, p, i, i, i, i, p,
                               i, p],
        "route_phases_launch": [p, i, q, p, *tabs, p, i, p, p, i, i, i, i,
                                i, i, p, i, p],
        "route_synth_launch": [p, *tabs, p, p, p, p, i, i, i, i, p, i, p],
    }[name]
    fn = getattr(_lib(), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _setup(M: int, Nh: int, behind: int, device: torch.device):
    """(the table pointers and L, the scratch, its rows a plane)."""
    L, twl, tile, w, bh = tables(M, device)
    rows = min(scratch_rows(L), Nh + behind)
    scratch = torch.empty((2, rows, L, 2), dtype=torch.float32,
                          device=device)
    ptrs = (twl.data_ptr(), tile.data_ptr(),
            w.data_ptr() if w is not None else None,
            bh.data_ptr() if bh is not None else None, L)
    return ptrs, scratch, rows


def analysis(x_ext, coef, M, T, Nh, n_ext, planar_in, planar,
             hop0_parity):
    """K1 on the route (``kernels.analysis.analyze_block``)."""
    dev = x_ext.device
    ptrs, scratch, rows = _setup(M, Nh, 0, dev)
    y = torch.empty((2, M, Nh) if planar else (M, Nh, 2),
                    dtype=torch.float32, device=dev)
    launch("analysis (device-memory route)",
           _launcher("route_analysis_launch"), dev, x_ext.data_ptr(),
           int(planar_in), n_ext, coef.data_ptr(), *ptrs, y.data_ptr(),
           int(planar), M, T, Nh, int(hop0_parity) % 2, scratch.data_ptr(),
           rows)
    return y


def front(x_ext, coef, prev, M, T, Nh, n_ext, planar, hop0_parity):
    """K2 on the route (``kernels.rx_front.analyze_demod``)."""
    dev = x_ext.device
    ptrs, scratch, rows = _setup(M, Nh, 1, dev)
    demod = torch.empty((M, Nh), dtype=torch.float32, device=dev)
    pw = torch.empty((M, Nh), dtype=torch.float32, device=dev)
    last = torch.empty((M, 2), dtype=torch.float32, device=dev)
    launch("rx_front (device-memory route)",
           _launcher("route_front_launch"), dev, x_ext.data_ptr(),
           int(planar), n_ext, coef.data_ptr(), *ptrs, prev.data_ptr(),
           demod.data_ptr(), pw.data_ptr(), last.data_ptr(), M, T, Nh,
           int(hop0_parity) % 2, scratch.data_ptr(), rows)
    return demod, last, pw


def phases(x_ext, coef, phases_out, pw_blk, M, T, sps, Nh, nsym, n_ext,
           planar, hop0_parity):
    """K3 on the route (``kernels.rx_phases.analyze_phases``): each band
    of x_ext (G, ...) or the one block into ``phases_out`` and
    ``pw_blk``, one band after another (1 <= sps <= MAX_SPS: the
    wrapper checks it)."""
    dev = x_ext.device
    ptrs, scratch, rows = _setup(M, Nh, 1, dev)
    state = torch.empty((M, MAX_SPS + 1), dtype=torch.float32, device=dev)
    bands = (zip(x_ext, phases_out, pw_blk) if x_ext.ndim == 3
             else [(x_ext, phases_out, pw_blk)])
    for xb, ph, pb in bands:
        launch("rx_phases (device-memory route)",
               _launcher("route_phases_launch"), dev, xb.data_ptr(),
               int(planar), n_ext, coef.data_ptr(), *ptrs, ph.data_ptr(),
               int(ph.dtype == torch.bfloat16), pb.data_ptr(),
               state.data_ptr(), M, T, sps, Nh, nsym, int(hop0_parity) % 2,
               scratch.data_ptr(), rows)


def synth(Y, gm, carry, M, T, Nh, hop0_parity):
    """K4 on the route (``kernels.synth.synthesize_block``)."""
    dev = Y.device
    ptrs, scratch, rows = _setup(M, Nh, 0, dev)
    out = torch.empty((Nh * (M // 2), 2), dtype=torch.float32, device=dev)
    new_carry = torch.empty_like(carry)
    launch("synth (device-memory route)", _launcher("route_synth_launch"),
           dev, Y.data_ptr(), *ptrs, gm.data_ptr(), carry.data_ptr(),
           out.data_ptr(), new_carry.data_ptr(), M, T, Nh,
           int(hop0_parity) % 2, scratch.data_ptr(), rows)
    return out, new_carry
