"""RECC trigger search on the card: correlation, window energies,
quality and K greedy picks of every channel row in one launch of the
hand-written kernel in ``csrc/trigger_search.cu``.

``rx.correlator.find_bursts_phases`` is the entry point: it checks its
arguments, computes the plain version (``find_bursts_phases_reference``,
the JAX package's banded Toeplitz matmul) for a CPU tensor and calls
``search`` here for a CUDA tensor, which launches the kernel or raises.
There is no fallback from one to the other.  The kernel keeps the plain
version's rounding points, so the two agree up to the order of the f32
sums.

``plan`` chooses the kernel's tiling from the row it is given: a row
whose symbols and quality fit in ``RESIDENT_BYTES`` of shared memory
stays there for all K pick rounds (the loop's 3 x 3703 symbols do); a
longer one is cut into tiles of one phase and up to ``MAX_TILE_BLOCKS``
blocks of lags that each round loads and recomputes.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from amps_tpu_torch.kernels import build
from amps_tpu_torch.kernels.analysis import launch
from amps_tpu_torch.rx.correlator import (CAPTURE_SYMBOLS, TRIGGER_SYMBOLS,
                                          _detection_kernels,
                                          trigger_template)

# kernel launches since import (or since the caller last reset it);
# incremented only where the kernel is launched
LAUNCHES = 0

# a block that keeps its row in shared memory: two blocks an SM at least
RESIDENT_BYTES = 112 * 1024
MAX_TILE_BLOCKS = 32       # blocks of lags a tile of a longer row holds
MAX_SMEM_BYTES = 227 * 1024


def plan(sps: int, nsym: int, O: int, K: int, out_bf16: bool):
    """(resident, tile_blocks): the whole row in shared memory, or tiles
    of one phase and ``tile_blocks`` blocks of lags, by the shared memory
    that the library's layout gives them."""
    smem = _library()[1]
    nblk = -(-(nsym - TRIGGER_SYMBOLS + 1) // O)

    def size(nph, nb):
        return smem(nph, nb, O, K, int(out_bf16))

    if size(sps, nblk) <= RESIDENT_BYTES:
        return True, nblk
    nb = min(MAX_TILE_BLOCKS, nblk)
    while nb > 1 and size(1, nb) > RESIDENT_BYTES:
        nb -= 1
    if size(1, nb) > MAX_SMEM_BYTES:
        raise ValueError(f"corr_block {O} with {K} picks needs "
                         f"{size(1, nb)} bytes of shared memory, the card "
                         f"has {MAX_SMEM_BYTES}")
    return False, nb


@functools.cache
def _library():
    """(launcher, shared memory of a tile) of the main library, once the
    trigger's taps and signs and the word-sync tap it was built with are
    the wrapper's."""
    lib = build.load()
    i = ctypes.c_int

    def bind(name, argtypes, restype=ctypes.c_int):
        f = getattr(lib, f"trigger_search_{name}")
        f.argtypes, f.restype = argtypes, restype
        return f

    tmpl = trigger_template(1)
    tap = bind("tap", [i])
    got = {"taps": bind("taps", [])(), "word_sync": bind("word_sync", [])(),
           "signs": [tap(t) for t in range(len(tmpl))]}
    want = {"taps": TRIGGER_SYMBOLS, "word_sync": _detection_kernels(1)[3],
            "signs": [int(v) for v in tmpl]}
    if got != want:
        raise RuntimeError(f"the trigger search kernel was built with {got}, "
                           f"the wrapper's {want}")
    p, f = ctypes.c_void_p, ctypes.c_float
    return (bind("launch", [p, i, i, i, i, i, i, i, f, f, f, f, i, i, i, i, i,
                            p, p, p, p]),
            bind("smem_bytes", [i] * 5, ctypes.c_longlong))


@functools.cache
def _constants(O: int, out_bf16: bool):
    """(1e-9, tnorm, wsnorm) rounded to the accumulation dtype, as the
    plain version's constants are."""
    acc_t = torch.bfloat16 if out_bf16 else torch.float32
    return tuple(float(torch.full((), v, dtype=acc_t).item())
                 for v in (1e-9, *_detection_kernels(1, O)[4:]))


def search(x: torch.Tensor, sps: int, max_bursts: int, threshold: float,
           corr_block: int, out_bf16: bool):
    """The trigger search of phase streams x (..., sps, nsym), bfloat16 or
    float32, on their CUDA device: (starts (..., K) int32, valid (..., K)
    bool, quality (..., K) float32), as ``find_bursts_phases``, which
    checks the arguments."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the trigger search kernel runs on a CUDA device, "
                         f"not {x.device}")
    L, K, O = TRIGGER_SYMBOLS, int(max_bursts), int(corr_block)
    nsym = x.shape[-1]
    batch = tuple(x.shape[:-2])
    rows = math.prod(batch)
    if sps * nsym + (L + CAPTURE_SYMBOLS) * sps >= 2 ** 31:
        raise ValueError(f"a row of {sps} x {nsym} symbols passes the "
                         f"kernel's 32-bit positions")
    dev = x.device
    starts = torch.empty(batch + (K,), dtype=torch.int32, device=dev)
    valid = torch.empty(batch + (K,), dtype=torch.bool, device=dev)
    quality = torch.empty(batch + (K,), dtype=torch.float32, device=dev)
    if rows == 0:
        return starts, valid, quality
    resident, tile_blocks = plan(sps, nsym, O, K, bool(out_bf16))
    xc = x.contiguous()
    launch("trigger_search", _library()[0], dev, xc.data_ptr(),
           int(x.dtype == torch.bfloat16), int(out_bf16), rows, sps, nsym, O,
           K, *_constants(O, bool(out_bf16)), float(threshold), L * sps,
           (L + CAPTURE_SYMBOLS) * sps, L * sps, int(resident), tile_blocks,
           starts.data_ptr(), valid.data_ptr(), quality.data_ptr())
    LAUNCHES += 1
    return starts, valid, quality
