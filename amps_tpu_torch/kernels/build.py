"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``sm_90a``) into an object file, all sources at once in parallel
processes; the objects link into one shared library with a plain C
interface.  The library lands in ``amps_tpu_torch/build/`` (git-ignored)
under a name that carries a hash of the sources, the shared headers and
the flags, so an edited source rebuilds and concurrent processes never
load a half-written file.  No fast-math: the discriminator's
``fast_atan2`` relies on IEEE division.

A missing ``nvcc`` or a failed build raises; there is no fallback.
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

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
DEFAULT_NVCC = pathlib.Path("/usr/local/cuda/bin/nvcc")
TIMEOUT_S = 600


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin directory on PATH)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libamps_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Start every command at once, wait for all; returns their output
    and raises on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    try:
        for cmd, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=TIMEOUT_S)
            logs.append(out)
            if p.returncode != 0:
                failed.append(f"nvcc failed ({p.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def build(extra_flags=()):
    """Compile the sources unless the library for them exists; returns
    (library path, nvcc's output).  ``extra_flags`` (e.g.
    ``("-Xptxas", "-v")``) force a rebuild and are passed to nvcc."""
    out = library_path()
    if out.exists() and not extra_flags:
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in _sources()]
        log = _run([[nvcc, *COMPILE_FLAGS, *extra_flags, "-c", "-o", obj,
                     str(src)] for src, obj in zip(_sources(), objs)])
        tmp = os.path.join(tmpdir, out.name)
        log += _run([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, out)
    return out, log


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    return ctypes.CDLL(str(build()[0]))
