"""A/B timing of variants of the port's FFT analysis tile on one CUDA card.

Builds copies of ``amps_tpu_torch/csrc/analysis.cu`` and ``rx_front.cu``
with ``analysis_fft.cuh`` changed by text (one shared library per
variant, all compiled at once), launches each through its C launcher on
the same inputs and prints, per variant, the analysis kernel's time at a
superframe (Nh=50004) and at Nh=8192 and the streaming front end's at
Nh=8192, with the error against the plain versions.  The variants that
drop the FFT or the fold compute garbage on purpose: their times split
the kernel's into its phases.  Run from the repository root:

    python3 tools/fft_tile_ab.py
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from amps_tpu_torch.eval.traffic import unit_channel_band  # noqa: E402
from amps_tpu_torch.kernels import analysis as KA  # noqa: E402
from amps_tpu_torch.kernels import build  # noqa: E402
from amps_tpu_torch.kernels import rx_front as R  # noqa: E402

VARIANTS = {
    "as built": {},
    "analysis without the FFT": {"skip_fft": True},
    "analysis without the fold": {"skip_fold": True},
    "analysis store only": {"skip_fft": True, "skip_fold": True},
    "8 hops a block at M=1024 (rx_front 16)": {"hops": 8},
    "10 hops a block at M=1024 (rx_front 20)": {"hops": 10},
    "rx_front with the analysis kernel's 12 hops": {"rx_same_hops": True},
}


def sources(hops=None, skip_fft=False, skip_fold=False, rx_same_hops=False):
    csrc = build.CSRC
    text = {n: (csrc / n).read_text() for n in
            ("common.cuh", "analysis_fft.cuh", "analysis.cu", "rx_front.cu")}

    def edit(name, old, new):
        assert old in text[name], (name, old)
        text[name] = text[name].replace(old, new)
    if hops is not None:
        edit("analysis_fft.cuh", "(M == 1024 ? 12 : 4)",
             f"(M == 1024 ? {hops} : 4)")
    if skip_fft:
        edit("analysis.cu", "  tile.fft();\n", "")
    if skip_fold:
        edit("analysis.cu",
             "  tile.fold(x, planar_in, n_ext, coef, T, h0);\n", "")
    if rx_same_hops:
        edit("rx_front.cu", "return 2 * fft_tile_hops(M);",
             "return fft_tile_hops(M);")
    return text


def build_all(tmp: pathlib.Path):
    nvcc, procs = build._nvcc(), {}
    for i, (name, kw) in enumerate(VARIANTS.items()):
        d = tmp / str(i)
        d.mkdir()
        for fname, t in sources(**kw).items():
            (d / fname).write_text(t)
        procs[name] = (d, subprocess.Popen(
            [nvcc, *build.COMPILE_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "analysis.cu"), str(d / "rx_front.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate(timeout=build.TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.analysis_launch.argtypes = [p, i, ctypes.c_longlong, p, p, p, i,
                                        i, i, i, i, p]
        lib.rx_front_launch.argtypes = [p, i, ctypes.c_longlong, p, p, p, p,
                                        p, p, i, i, i, i, p]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("fft_tile_ab: no CUDA device", file=sys.stderr)
        return 1
    dev, M, T = torch.device("cuda", 0), 1024, 8
    print(f"card: {cs.card_line()}", flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        libs = build_all(pathlib.Path(tmp))
        coef, tw = KA._tables(M, T, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def k1(lib, x, Nh, y):
            assert lib.analysis_launch(x.data_ptr(), 0, x.shape[0],
                                       coef.data_ptr(), tw.data_ptr(),
                                       y.data_ptr(), 0, M, T, Nh, 0,
                                       stream) == 0

        def k2(lib, x, Nh, prev, d, pw, last):
            assert lib.rx_front_launch(x.data_ptr(), 0, x.shape[0],
                                       coef.data_ptr(), tw.data_ptr(),
                                       prev.data_ptr(), d.data_ptr(),
                                       pw.data_ptr(), last.data_ptr(), M, T,
                                       Nh, 0, stream) == 0
        res = {n: {} for n in libs}
        for Nh in (50004, 8192):
            x = unit_channel_band(M, T, Nh, M + Nh, dev)
            ry = KA.analyze_reference(x, M, T, 0)
            ys = {n: torch.empty((M, Nh, 2), device=dev) for n in libs}
            for n, lib in libs.items():
                k1(lib, x, Nh, ys[n])
                torch.cuda.synchronize()
                res[n][f"analysis err Nh={Nh}"] = (ys[n] - ry).abs().max().item()
            t = cs.timed({n: (lambda lib=lib, n=n: k1(lib, x, Nh, ys[n]))
                          for n, lib in libs.items()}, 20, cs.KERNEL_REPS)
            for n in libs:
                res[n][f"analysis ms Nh={Nh}"] = t[n]
            del ys, ry
        prev = torch.zeros((M, 2), device=dev)
        outs = {n: (torch.empty((M, Nh), device=dev),
                    torch.empty((M, Nh), device=dev),
                    torch.empty((M, 2), device=dev)) for n in libs}
        rd, _, _ = R.analyze_demod_reference(x, M, T, 0, prev)
        for n, lib in libs.items():
            k2(lib, x, Nh, prev, *outs[n])
            torch.cuda.synchronize()
            res[n]["rx_front max demod err"] = (outs[n][0] - rd).abs().max().item()
        t = cs.timed({n: (lambda lib=lib, n=n: k2(lib, x, Nh, prev, *outs[n]))
                      for n, lib in libs.items()}, 20, cs.KERNEL_REPS)
        for n in libs:
            res[n][f"rx_front ms Nh={Nh}"] = t[n]
    for n, r in res.items():
        print(json.dumps({"variant": n, **r}), flush=True)
    print(f"card: {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
