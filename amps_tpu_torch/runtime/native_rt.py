"""ctypes bindings for the native host runtime (``native/ampsrt.cc``),
the PyTorch port of ``amps_tpu.runtime.native_rt``: the lock-free SPSC
byte ring between an I/O thread and the device feeder, single-word
BCH(63,51) encode/decode, Manchester encode/decode and the exact
trigger scan.

The library is built with g++ at first use, never at import, into
``amps_tpu_torch/build/`` (git-ignored) under a name that carries a
hash of the source and the flags, written through a temporary file and
``os.replace``, so concurrent processes never load a half-written file.
No ``-march=native``: a tree built on one host may run on another.  A
missing g++ or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = pathlib.Path(__file__).resolve().parent / "native" / "ampsrt.cc"
BUILD_DIR = _PKG / "build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra")
TIMEOUT_S = 300


def library_path() -> pathlib.Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libampsrt_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the source unless its library exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native runtime cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, out.name)
        proc = subprocess.run([gxx, *FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True,
                              timeout=TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The native library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.amps_focc_bch_encode.argtypes = [u8p, u8p]
    lib.amps_recc_bch_encode.argtypes = [u8p, u8p]
    lib.amps_recc_bch_decode.argtypes = [u8p, u8p]
    lib.amps_recc_bch_decode.restype = ctypes.c_int
    lib.amps_manchester_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                           i8p]
    lib.amps_manchester_decode.argtypes = [u8p, ctypes.c_int, u8p]
    lib.amps_manchester_decode.restype = ctypes.c_int
    lib.amps_trigger_scan.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long]
    lib.amps_trigger_scan.restype = ctypes.c_long
    lib.amps_ring_create.argtypes = [ctypes.c_size_t]
    lib.amps_ring_create.restype = ctypes.c_void_p
    lib.amps_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.amps_ring_write.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.amps_ring_write.restype = ctypes.c_size_t
    lib.amps_ring_read.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.amps_ring_read.restype = ctypes.c_size_t
    lib.amps_ring_read_available.argtypes = [ctypes.c_void_p]
    lib.amps_ring_read_available.restype = ctypes.c_size_t
    lib.amps_ring_write_available.argtypes = [ctypes.c_void_p]
    lib.amps_ring_write_available.restype = ctypes.c_size_t
    return lib


def _u8(a, size: int | None = None) -> np.ndarray:
    """``a`` as contiguous uint8; ``size`` is the length the native
    function reads, checked here because C reads past a short buffer."""
    out = np.ascontiguousarray(np.asarray(a, dtype=np.uint8).reshape(-1))
    if size is not None and out.size != size:
        raise ValueError(f"expected {size} bits, got {out.size}")
    return out


def _ptr(a, typ=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def focc_bch_encode(info28) -> np.ndarray:
    src = _u8(info28, 28)
    out = np.zeros(40, np.uint8)
    load().amps_focc_bch_encode(_ptr(src), _ptr(out))
    return out


def recc_bch_encode(info36) -> np.ndarray:
    src = _u8(info36, 36)
    out = np.zeros(48, np.uint8)
    load().amps_recc_bch_encode(_ptr(src), _ptr(out))
    return out


def recc_bch_decode(rx48):
    src = _u8(rx48, 48)
    out = np.zeros(36, np.uint8)
    ok = load().amps_recc_bch_decode(_ptr(src), _ptr(out))
    return out, bool(ok)


def manchester_encode(bits, sps: int = 1) -> np.ndarray:
    src = _u8(bits)
    out = np.zeros(len(src) * 2 * sps, np.int8)
    load().amps_manchester_encode(_ptr(src), len(src), sps,
                                  _ptr(out, ctypes.c_int8))
    return out


def manchester_decode(symbols01):
    src = _u8(symbols01)
    nbits = len(src) // 2
    out = np.zeros(nbits, np.uint8)
    bad = load().amps_manchester_decode(_ptr(src), nbits, _ptr(out))
    return out, int(bad)


def trigger_scan(haystack01, needle01) -> int:
    hay, nee = _u8(haystack01), _u8(needle01)
    return int(load().amps_trigger_scan(_ptr(hay), len(hay), _ptr(nee),
                                        len(nee)))


class Ring:
    """SPSC byte ring buffer backed by the native implementation: one
    thread writes, one reads."""

    def __init__(self, capacity_pow2: int):
        lib = load()
        self._lib = lib
        self._h = lib.amps_ring_create(capacity_pow2)
        if not self._h:
            raise ValueError("capacity must be a power of two")

    def write(self, data) -> int:
        """Write what fits of ``data`` (bytes or any buffer, read in
        place); returns the bytes written."""
        buf = np.frombuffer(data, np.uint8)
        return int(self._lib.amps_ring_write(self._h, _ptr(buf), len(buf)))

    def read(self, n: int) -> bytes:
        out = np.empty(n, np.uint8)
        got = self._lib.amps_ring_read(self._h, _ptr(out), n)
        return out[:got].tobytes()

    @property
    def readable(self) -> int:
        return int(self._lib.amps_ring_read_available(self._h))

    @property
    def writable(self) -> int:
        return int(self._lib.amps_ring_write_available(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.amps_ring_destroy(self._h)
            self._h = None
