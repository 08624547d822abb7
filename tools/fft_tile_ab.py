"""A/B timing of variants of the port's FFT-tile kernels on one CUDA card.

Builds copies of the kernels' sources (``amps_tpu_torch/csrc``) changed
by text, one shared library per variant, all compiled at once; launches
each through its C launcher on the same inputs and prints, per variant,
the time of every kernel it builds at M=1024 -- the analysis kernel (K1)
at a superframe (Nh=50004) and at Nh=8192, the streaming front end (K2)
and the one-shot front end (K3, bf16 phases) at Nh=8192, the synthesis
(K4) at a superframe and at Nh=8192 -- with the error against the plain
versions.  The variants that drop a phase (the fold, the row load, the
FFT, the output) compute garbage on purpose: their times split the
kernel's into its phases.  Run from the repository root:

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
from amps_tpu_torch.kernels import rx_phases as K3  # noqa: E402
from amps_tpu_torch.kernels import synth as K4  # noqa: E402

SOURCES = {"analysis": "analysis.cu", "rx_front": "rx_front.cu",
           "rx_phases": "rx_phases.cu", "synth": "synth.cu"}
K12, K34 = ("analysis", "rx_front"), ("rx_phases", "synth")
NO_FFT = ("  tile.fft();\n", "")
NO_K1_FOLD = ("  tile.fold(x, planar_in, n_ext, coef, T, h0);\n", "")

# name: (kernels built and timed, {source: [(old text, new text), ...]})
VARIANTS = {
    "as built": (K12 + K34, {}),
    "analysis without the FFT": (("analysis",), {"analysis.cu": [NO_FFT]}),
    "analysis without the fold": (("analysis",),
                                  {"analysis.cu": [NO_K1_FOLD]}),
    "analysis store only": (("analysis",),
                            {"analysis.cu": [NO_FFT, NO_K1_FOLD]}),
    "8 hops a block at M=1024 (rx_front 16)": (K12, {"analysis_fft.cuh": [
        ("(M == 1024 ? 12 : 4)", "(M == 1024 ? 8 : 4)")]}),
    "10 hops a block at M=1024 (rx_front 20)": (K12, {"analysis_fft.cuh": [
        ("(M == 1024 ? 12 : 4)", "(M == 1024 ? 10 : 4)")]}),
    "rx_front with the analysis kernel's 12 hops": (("rx_front",), {
        "analysis_fft.cuh": [("return 2 * fft_tile_hops(M);",
                              "return fft_tile_hops(M);")]}),
    "rx_phases without the FFT": (("rx_phases",), {"rx_phases.cu": [NO_FFT]}),
    "rx_phases without the fold": (("rx_phases",), {"rx_phases.cu": [
        ("  tile.fold(x, planar, n_ext, coef, T, h0 - 1);\n", "")]}),
    "rx_phases without the dump": (("rx_phases",), {"rx_phases.cu": [
        ("    if (j < nsym) {\n", "    if (j < 0) {\n")]}),
    "synth without the FFT": (("synth",), {"synth.cu": [NO_FFT]}),
    "synth without the row load": (("synth",), {"synth.cu": [
        ("    tile.load_rows(Y, hb, Nh);\n", "    __syncthreads();\n")]}),
    "synth without the output": (("synth",), {"synth.cu": [
        ("          if (store) {\n", "          if (store && h < 0) {\n")]}),
    "synth with 12 hops a pass, two blocks an SM": (("synth",), {
        "synth.cu": [("__launch_bounds__(kFftThreads, 1)",
                      "__launch_bounds__(kFftThreads, 2)"),
                     ("fft_wide_hops(M)", "fft_tile_hops(M)")]}),
}


def sources(kernels, edits):
    text = {n: (build.CSRC / n).read_text()
            for n in ["common.cuh", "analysis_fft.cuh"]
            + [SOURCES[k] for k in kernels]}
    for name, pairs in edits.items():
        for old, new in pairs:
            assert old in text[name], (name, old)
            text[name] = text[name].replace(old, new)
    return text


def build_all(tmp: pathlib.Path):
    nvcc, procs = build._nvcc(), {}
    for i, (name, (kernels, edits)) in enumerate(VARIANTS.items()):
        d = tmp / str(i)
        d.mkdir()
        for fname, t in sources(kernels, edits).items():
            (d / fname).write_text(t)
        procs[name] = (d, kernels, subprocess.Popen(
            [nvcc, *build.COMPILE_FLAGS, "-shared", "-o", str(d / "lib.so"),
             *(str(d / SOURCES[k]) for k in kernels)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    argtypes = {"analysis": [p, i, ll, p, p, p, i, i, i, i, i, p],
                "rx_front": [p, i, ll, p, p, p, p, p, p, i, i, i, i, p],
                "rx_phases": [p, i, ll, p, p, p, i, p, p, i, i, i, i, i,
                              i, i, i, p],
                "synth": [p, p, p, p, p, p, i, i, i, i, p]}
    libs = {}
    for name, (d, kernels, proc) in procs.items():
        out, _ = proc.communicate(timeout=build.TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for k in kernels:
            getattr(lib, f"{k}_launch").argtypes = argtypes[k]
        libs[name] = (lib, kernels)
    return libs


def time_kernel(libs, kernel, launch, outputs, err, res, label):
    """Launch each variant that builds ``kernel`` once into its own
    ``outputs()``, record ``err`` of them, then time all interleaved."""
    mine = {n: lib for n, (lib, ks) in libs.items() if kernel in ks}
    outs = {n: outputs() for n in mine}
    for n, lib in mine.items():
        assert launch(lib, *outs[n]) == 0, (n, label)
        torch.cuda.synchronize()
        res[n][f"{label} err"] = err(*outs[n])
    t = cs.timed({n: (lambda lib=lib, n=n: launch(lib, *outs[n]))
                  for n, lib in mine.items()}, 20, cs.KERNEL_REPS)
    for n in mine:
        res[n][f"{label} ms"] = t[n]


def main() -> int:
    if not torch.cuda.is_available():
        print("fft_tile_ab: no CUDA device", file=sys.stderr)
        return 1
    dev, M, T, sps = torch.device("cuda", 0), 1024, 8, 3
    print(f"card: {cs.card_line()}", flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        libs = build_all(pathlib.Path(tmp))
        coef, tw = KA._tables(M, T, dev)
        gm = K4._gain_taps(M, T, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        res = {n: {} for n in libs}
        for Nh in (50004, 8192):
            x = unit_channel_band(M, T, Nh, M + Nh, dev)
            ry = KA.analyze_reference(x, M, T, 0)
            time_kernel(
                libs, "analysis",
                lambda lib, y: lib.analysis_launch(
                    x.data_ptr(), 0, x.shape[0], coef.data_ptr(),
                    tw.data_ptr(), y.data_ptr(), 0, M, T, Nh, 0, stream),
                lambda: (torch.empty((M, Nh, 2), device=dev),),
                lambda y: (y - ry).abs().max().item(), res,
                f"analysis Nh={Nh}")
            del ry
            g = torch.Generator(dev).manual_seed(Nh)
            Y = torch.randn((Nh, M, 2), device=dev, generator=g)
            carry = torch.randn((M * T - M // 2, 2), device=dev, generator=g)
            rx, rc = K4.synthesize_block_reference(Y, M, T, 0, carry)
            time_kernel(
                libs, "synth",
                lambda lib, o, c: lib.synth_launch(
                    Y.data_ptr(), tw.data_ptr(), gm.data_ptr(),
                    carry.data_ptr(), o.data_ptr(), c.data_ptr(), M, T, Nh,
                    0, stream),
                lambda: (torch.empty_like(rx), torch.empty_like(rc)),
                lambda o, c: (o - rx).abs().max().item(), res,
                f"synth Nh={Nh}")
            del Y, rx, rc
        prev = torch.zeros((M, 2), device=dev)
        rd, _, _ = R.analyze_demod_reference(x, M, T, 0, prev)
        time_kernel(
            libs, "rx_front",
            lambda lib, d, pw, last: lib.rx_front_launch(
                x.data_ptr(), 0, x.shape[0], coef.data_ptr(), tw.data_ptr(),
                prev.data_ptr(), d.data_ptr(), pw.data_ptr(), last.data_ptr(),
                M, T, Nh, 0, stream),
            lambda: (torch.empty((M, Nh), device=dev),
                     torch.empty((M, Nh), device=dev),
                     torch.empty((M, 2), device=dev)),
            lambda d, pw, last: (d - rd).abs().max().item(), res,
            f"rx_front Nh={Nh}")
        nsym, nrun = (Nh - sps + 1) // sps, -(-Nh // K3.run_hops(M, sps))
        rph, _, _ = K3.analyze_phases_reference(x, M, T, sps,
                                                out_dtype=torch.bfloat16)
        time_kernel(
            libs, "rx_phases",
            lambda lib, ph, part, blk: lib.rx_phases_launch(
                x.data_ptr(), 0, x.shape[0], coef.data_ptr(), tw.data_ptr(),
                ph.data_ptr(), 1, part.data_ptr(), blk.data_ptr(), M, T, sps,
                Nh, nsym, 0, nrun, 1, stream),
            lambda: (torch.empty((M, sps, nsym), dtype=torch.bfloat16,
                                 device=dev),
                     torch.empty((M, nrun, 2), device=dev),
                     torch.empty((M, -(-Nh // 384)), device=dev)),
            lambda ph, part, blk: (ph.float() - rph.float()).abs().max()
            .item(), res, f"rx_phases Nh={Nh}")
    for n, r in res.items():
        print(json.dumps({"variant": n, **r}), flush=True)
    print(f"card: {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
