"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``sm_90a``) into an object file, all sources at once in parallel
processes; the objects link into one shared library with a plain C
interface.  The main library instantiates the FFT tile at every power of
two from 2 to 4096 and holds the device-memory route (``route.cu``,
whose widths are runtime arguments) and the trigger search
(``trigger_search.cu``); any other width M the tile takes
(8192 and the other cluster widths past 4096 among them) compiles into a
small library of its own, from the same sources but the width-free
ones (``MAIN_ONLY``: the route and the trigger search) with
``-DAMPS_FFT_WIDTH=M`` (``build(widths=...)`` builds several in one
parallel run).  The libraries
land in ``amps_tpu_torch/build/`` (git-ignored) under names that carry
a hash of the sources, the shared headers, the flags and the width, so
an edited source rebuilds and concurrent processes never load a
half-written file.  No fast-math: the discriminator's ``fast_atan2``
relies on IEEE division.

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


# the sources that take no width, the main library's alone: the
# device-memory route and the trigger search
MAIN_ONLY = ("route.cu", "trigger_search.cu")


def _sources(width=None):
    """The sources of the main library (width None), or of one width's:
    all but ``MAIN_ONLY``."""
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return [s for s in srcs if width is None or s.name not in MAIN_ONLY]


def _flags(width):
    return COMPILE_FLAGS + ((f"-DAMPS_FFT_WIDTH={width}",) if width else ())


def library_path(width=None) -> pathlib.Path:
    """Where the library for the current sources and flags lives: the
    main one (``width`` None) or the one of a single width."""
    h = hashlib.sha256(" ".join(_flags(width) + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    stem = "libamps_kernels" + (f"_m{width}" if width else "")
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


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


def _build(widths, extra_flags):
    """Compile the libraries of ``widths`` (None: the main one) that do not
    exist yet -- every source of every library at once, then every link
    at once; ``extra_flags`` force a rebuild.  Returns ({width: path},
    nvcc's output)."""
    paths = {w: library_path(w) for w in widths}
    todo = [w for w, path in paths.items()
            if extra_flags or not path.exists()]
    if not todo:
        return paths, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = {w: [os.path.join(tmpdir, f"{w or 'main'}_{src.stem}.o")
                    for src in _sources(w)] for w in todo}
        log = _run([[nvcc, *_flags(w), *extra_flags, "-c", "-o", obj,
                     str(src)]
                    for w in todo for src, obj in zip(_sources(w), objs[w])])
        tmps = {w: os.path.join(tmpdir, paths[w].name) for w in todo}
        log += _run([[nvcc, *LINK_FLAGS, "-o", tmps[w], *objs[w]]
                     for w in todo])
        for w in todo:
            os.replace(tmps[w], paths[w])
    return paths, log


def build(extra_flags=(), widths=()):
    """Compile the main library, and the single-width libraries of
    ``widths``, unless they exist -- all in one parallel build; returns
    (the main library's path, nvcc's output).  ``extra_flags`` (e.g.
    ``("-Xptxas", "-v")``) force a rebuild and are passed to nvcc."""
    paths, log = _build([None, *map(int, widths)], tuple(extra_flags))
    return paths[None], log


@functools.cache
def load(width=None) -> ctypes.CDLL:
    """The kernels' shared library -- the main one, or that of one width
    -- built on first call."""
    return ctypes.CDLL(str(_build([width], ())[0][width]))
