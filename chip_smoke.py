"""GPU smoke run of the PyTorch/CUDA port.  It builds the four CUDA
kernels of the ported paths (rx_phases, rx_front, synth, analysis),
holds each against its plain PyTorch version at M=1024 and 256 and at
the small banks M=2, 4, 6, 8, 16 and 32, drives the 1024-channel
receive block, the station's streaming duplex -- MultichannelTransmitter
superframes read back through the rx_phases kernel, and planted bursts
streamed through MultichannelReceiver --, a whole call over channelized RF
(BaseStation, the transmitter, the mobile simulator's ear on the
analysis kernel, its RECC bursts through the receiver), the fused TX->RX
closed loop under a CUDA graph (synth + rx_front once a block), the
batched small-bank block (rx_phases with a band axis), the
single-channel TX and RX chains and the receiver's voice supervision,
and the station as operators run it -- the BS-in-a-box app through the
CLI (synth on its TX thread, rx_front on its RX thread), the executor
over the native ring, the link-quality curve, the capture monitor and
the demo; the multi-device station on the card -- the sharded
full-duplex step and closed loop on a 2x2 mesh whose four workers share
it (each worker's analysis on K1, its synthesis on K4), ``bs --mesh 2x2``
through a paged call, ``dryrun_multichip(4)`` and weak scaling; the
station's certification -- every soak of ``eval/soak.py`` at its full
size, each held to its bar, and the paced legs of ``eval/pacing.py``
shortened (receive 20 s with no deadline miss, full duplex 10 s threaded
and 10 s in one thread); the cross-process station -- two processes of
this script (``--xproc-worker``) joined by ``torch.distributed`` into
the {time: 2, chan: 2} mesh on the one card, over gloo, running the
sharded step and loop with reports equal to the one-process mesh's --;
the flagship forward ``dryrun.entry()`` on the rx_phases kernel; the
FFT tile at widths that are not powers of two -- each width's own
library built at first use, every kernel against its plain version at
M = 24, 160, 448, 768, 1458 and 2038, their times at 768, 1536 and 2038
beside 1024, and the station's main path at M=768 (a 23.04 Msps radio:
the one-shot block, the receiver, the transmitter read back, the closed
loop under its graph, the mobile's analysis) --; banks past 2048
channels -- every wrapper refusing the odd M = 4095, 8193, 32769 and M = 0,
every kernel against its plain version at M = 2304, 3072, 4000, 4094
and 4096, their times at 2048, 3072 and 4096 beside 1024, the same main
path at M=4096 (a 122.88 Msps radio) and a short call of the station
app there --; banks past 4096 channels, each hop shared by a cluster
of two thread blocks over distributed shared memory -- every kernel
against its plain version at M = 4098, 4100, 6144, 8190 and 8192, their
times at 6144 and 8192 beside 1024 and 4096, the same main path and
short app call at M=8192 (a 245.76 Msps radio), the peak device memory
--; filters longer than 16 taps a phase -- every kernel against its
plain version at T = 17, 24, 32, 33 and 64 and M = 8 to 8192, their
times at M=1024 for T = 8 to 64, the main path and one sharded step at
M=1024, T=32 --; banks past 8192 channels, each hop shared by a cluster
of 3 to 8 blocks with a radix-C pass across it -- every wrapper refusing
M = 8195, 16389 and 32769, every kernel against its plain version at
M = 8196, 12288, 16384, 20480, 12294, 28672, 32768 and 16424, their
times at 12288 and 16384 beside 8192, the same main path and short app
call at M=16384 (a 491.52 Msps radio), the peak device memory --; the
even widths past 8192 that no cluster splits, each a chirp convolution
of length 32768 (Bluestein) on a cluster of 8 blocks -- every wrapper
refusing M = 8193, 16383, 32769 and 0, every kernel against its
plain version and float64 at M = 8194, 8198, 13334, 16378 and 16382
(and at 8194 with T=32), their times at 8194 and 16382 beside 8192 and
16384, the clusters of 16 the card would hold, the same main path and
short app call at M=16382 (a 491.46 Msps radio), the peak device
memory --; every other even width through device memory (a Stockham FFT
of passes of radix 256-4096 between scratch planes, direct at a power of
two, Bluestein's chirp convolution elsewhere) -- every wrapper refusing
M = 8193, 32769 and 0, every kernel against its plain version and
float64 at M = 16388, 32766, 32770, 65536, 1048574 and 8388610 (and at
16388 with T=32), their times at 32766 and 65536 beside 32768, each
wrapper's CUDA launches in one call (profiler spans, held to the
route's count), the same main path and short app call at M=32766 (a
982.98 Msps radio), the peak device memory --; the trigger search
kernel (K5) alone on the duplex loop's rows at M=1024 and 16384 against
its plain version and its bound (phase 36, the ``trigger_search``
line); and
times kernels and paths against their plain versions,
their bounds and a cuFFT yardstick, with profiler windows of one
one-shot block, one receiver push, one transmitter superframe, one
superframe of the ear, one run of the closed loop, one run of the app
and one sharded step.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Every check raises on failure.  The last line of standard output is a
JSON object naming the device; the line before it lists each kernel of
the paths with its launches on its main path, its error against the
plain version, both times, its bound (the least time of the function:
an FFT-sized transform and the fold or overlap-add against the bytes
moved), its transform ("fft": all four run the all-channel FFT tile),
the cuFFT time of its transform alone, its error at the small banks and
its launches and times on the closed loop or the batched block, for
K1 and K4 their launches, errors and times at the sharded workers'
shapes, and each kernel's errors at phase 29's widths and its times,
bounds and cuFFT yardsticks at 768, 1024, 1536 and 2038 (``widths_*``),
and the same at phase 30's (``wide_*``), phase 31's (``widest_*``) and
phase 33's (``wider_*``, with K1's, K2's and K4's errors against
float64 references of their functions, the kernel's beside its plain
version's, in ``wider_vs_float64``) and phase 34's (``bluestein_*``,
``bluestein_vs_float64`` by M and T) and phase 35's (``route_*``: its
source, errors, float64 witness, times at 32766 and 65536, the split
cluster's at 32768 beside them, the CUDA launches of a call the
profiler saw at each checked M and Nh, and the peak memory), and
phase 32's errors by M and times by T (``taps_*``);
``launches_by_path`` counts each kernel's launches on every path it
runs, the soaks', the paced legs', the two processes' of the
cross-process station and the M=768, M=4096, M=8192, M=16384 and
M=16382 and M=32766 paths' (``m768_*``, ``m4096_*``, ``m8192_*``,
``m16384_*``, ``m16382_*``, ``m32766_*``; on the device-memory route a
wrapper call counts one) and the T=32 paths' (``t32_*``)
among them.  Without a CUDA card it exits non-zero.

    python3 chip_smoke.py --digest TREE

builds the port in source tree TREE and prints the sha256 of each
kernel's outputs at T = 8 and 32 on fixed inputs (``digest``): run on
two trees in one call, it shows a change leaving them bit for bit.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

PHASE_ATOL = 1e-3          # f32 phases and demod, kernel vs plain version
BRANCH_CUT_FRACTION = 1e-5  # share of noise samples allowed past PHASE_ATOL
POWER_RTOL = 1e-4
BF16_ATOL = 0.02           # bf16 phase output against the f32 plain version
N_TIMED = 30
KERNEL_REPS = 5            # back-to-back calls per timed kernel turn
PROFILE_TRIES = 3          # profiler windows a profile_window may take
BURST_HOPS = (30 + 11 + 7 + 7 * 240) * 2 * 3   # one RECC burst at sps 3
# wideband noise of the phase-2 band: ~37 dB per-channel SNR at M=1024,
# so that no channel is dominated by the f32 roundoff of the bursts
BAND_SIGMA = 0.3
SYNTH_RTOL = 1e-4          # synthesis, kernel vs plain: max |err| / out RMS
# The forward band of M identical FOCC superframes sums coherently: its
# peak is ~43x its RMS at M=1024, and even the plain f32 synthesis is off
# a float64 one by 1.3e-4 of the RMS (3e-6 of the peak; CPU measurement
# at M=1024).  So the transmitter's output is held relative to its peak.
TX_PEAK_RTOL = 2e-5
# power series, kernel vs plain, relative: per sample inside the planted
# bursts, and as the 384-hop block means the rssi is built from over the
# whole plane (a noise sample near zero carries the roundoff of the
# strong channels, up to ~1.5e-2 of its own size on an H100)
SERIES_RTOL = 1e-4
LAST_RTOL = 1e-4           # last channel sample: max |err| / its RMS
RX_PUSH = 1 << 22          # samples per receiver push
ANALYSIS_ATOL = 2e-4       # analysis, kernel vs plain, unit-amplitude channels
CALL_LOG = ["paged", "assigned 355", "ringing", "answered",
            "handoff 355->356", "hang_up"]
# published H100 SXM peaks: f32 outside the tensor cores, HBM3
F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12


T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def stamp(label):
    """A line with the seconds since the script started, before a phase
    or a part of one."""
    log(f"[{time.perf_counter() - T_START:.1f} s] {label}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_usage(nvcc_log: str):
    """(kernel<template args>, "registers; spills") of each function in
    nvcc's -Xptxas -v output."""
    out, name, spill = [], "?", ""
    for line in nvcc_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"\d([a-z_]+_kernel)((?:ILi\d+E(?:Li\d+E)*)?)",
                          m.group(1))
            args = re.findall(r"Li(\d+)E", k.group(2)) if k else []
            name = (k.group(1) if k else m.group(1)[:40]) + \
                (f"<{', '.join(args)}>" if args else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used \d+ registers", line)
            out.append((name, f"{regs.group(0) if regs else line.strip()}; "
                              f"{spill}"))
    return out


def plant_events(M: int, seed: int, max_words: int = 7):
    """8 bursts starting at hops 100..1799: channels 0, 1, 2 (adjacent),
    M/2-1, M/2, M-1 and two more, 2..max_words random 36-bit info words
    each, DCC 0."""
    from amps_tpu_torch.eval.traffic import BurstEvent
    rng = np.random.default_rng(seed)
    chans = [0, 1, 2, M // 2 - 1, M // 2, M - 1, M // 4 + 3, 3 * M // 4 - 5]
    events = []
    for c in chans:
        nw = int(rng.integers(2, max_words + 1))
        words = rng.integers(0, 2, (nw, 36)).astype(np.uint8)
        events.append(BurstEvent(c, int(rng.integers(100, 1800)), words))
    return events


def check_planted(out, events):
    """The one-shot block's planted bursts: each valid once in slot 0,
    word_ok, bit-exact, DCC 0, and no other valid slot; finite rssi and
    channel power.  Returns the expected valid plane."""
    valid = out["valid"].cpu().numpy()
    words = out["words"].cpu().numpy()
    word_ok = out["word_ok"].cpu().numpy()
    dcc = out["dcc_bits"].cpu().numpy()
    expect = np.zeros_like(valid)
    for ev in events:
        c, nw = ev.channel, len(ev.words)
        expect[c, 0] = True
        assert valid[c, 0], f"burst on channel {c} not found"
        assert word_ok[c, 0, :nw].all(), f"channel {c}: word_ok"
        assert np.array_equal(words[c, 0, :nw], ev.words), f"channel {c}"
        assert not dcc[c, 0].any(), f"channel {c}: DCC bits"
    assert np.array_equal(valid, expect), np.argwhere(valid != expect)
    rssi = out["rssi"].cpu().numpy()
    assert np.isfinite(rssi).all() and np.isfinite(
        out["chan_power"].cpu().numpy()).all()
    log(f"  all {len(events)} bursts valid, word_ok, bit-exact, DCC 0; "
        f"no other valid slot; rssi of bursts "
        f"{np.round(rssi[valid], 4).tolist()}")
    return expect


def compare_front_end(K, x, M, T, sps, label, events=()):
    """Kernel vs plain version on one input.  Noise-only samples obey the
    branch-cut rule: two correct f32 summation orders may put a sample
    on opposite sides of ±π and move its symbol by ~2π/3, so at most
    BRANCH_CUT_FRACTION of the phases may exceed PHASE_ATOL.  Inside the
    planted bursts (constant-envelope FM, |Δφ| <= 0.84 rad) every phase
    is held to PHASE_ATOL; returns their max abs error."""
    ph, cp, pw = K.analyze_phases(x, M, T, sps)
    torch.cuda.synchronize()
    rph, rcp, rpw = K.analyze_phases_reference(x, M, T, sps)
    torch.cuda.synchronize()
    assert ph.shape == rph.shape and pw.shape == rpw.shape, label
    assert torch.isfinite(ph).all() and torch.isfinite(pw).all(), label
    err = (ph - rph).abs()
    beyond = (err > PHASE_ATOL).double().mean().item()
    pw_rel = ((pw - rpw).abs() / rpw.abs().clamp(min=1e-30)).max().item()
    cp_rel = ((cp - rcp).abs() / rcp.abs().clamp(min=1e-30)).max().item()
    log(f"  {label}: phases max|err| {err.max().item():.3e}, "
        f"share > {PHASE_ATOL} {beyond:.2e}; pw_blk max rel {pw_rel:.3e}; "
        f"chan_power max rel {cp_rel:.3e}")
    assert beyond <= BRANCH_CUT_FRACTION, (label, beyond)
    burst_err = 0.0
    for ev in events:
        j0 = -(-(ev.start_hop + 1) // sps)
        j1 = min(ev.start_hop + BURST_HOPS, ph.shape[-1] * sps) // sps - 1
        if j1 > j0:
            burst_err = max(burst_err,
                            err[ev.channel, :, j0:j1].max().item())
    if events:
        log(f"  {label}: max|err| inside the {len(events)} bursts "
            f"{burst_err:.3e}")
        assert burst_err <= PHASE_ATOL, (label, burst_err)
    assert pw_rel <= POWER_RTOL and cp_rel <= POWER_RTOL, (label, pw_rel,
                                                            cp_rel)
    bph, _, _ = K.analyze_phases(x, M, T, sps, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    berr = (bph.float() - rph).abs()
    bbeyond = (berr > BF16_ATOL).double().mean().item()
    assert bbeyond <= BRANCH_CUT_FRACTION, (label, "bf16", bbeyond)
    return burst_err


def timed(fns, n=N_TIMED, reps=1):
    """Median ms of each callable, interleaved in turns, CUDA events.  A
    turn times ``reps`` back-to-back calls and divides by them: a kernel
    (reps = KERNEL_REPS) is timed on a fed queue, so the wrapper's host
    work overlaps the previous launch; a path (reps = 1) is timed call by
    call, its host work included."""
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(n):
        for k, f in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                f()
            b.record()
            torch.cuda.synchronize()
            times[k].append(a.elapsed_time(b) / reps)
    return {k: float(np.median(v)) for k, v in times.items()}


def analysis_f64(x, M, T, parity):
    """K1's function in float64 on riq x ((Nh + 2T - 1)·M/2, 2), on its
    device: the polyphase fold with ``prototype_taps(M, T)``, y_n[k] =
    sum_m v_n[m] e^{+j2πkm/M} (v_n[P-1-q] the odd bank's fold, v_n[M-1-q]
    the even one's) as M times an inverse FFT, the derotation
    e^{+j2πk/M} and the hop sign.  Returns (M, Nh) complex128: the
    reference to which phase 33 holds each kernel and its plain version
    alike."""
    from amps_tpu_torch.dsp.polyphase import _hop_sign, prototype_taps
    P = M // 2
    Nh = x.shape[0] // P - (2 * T - 1)
    coef = torch.as_tensor(np.ascontiguousarray(
        prototype_taps(M, T)[::-1]).reshape(T, M), device=x.device).double()
    z = torch.complex(x[:, 0].double(), x[:, 1].double())
    bl = z[: x.shape[0] // P * P].reshape(-1, P)
    acc_e = sum(coef[t, :P] * bl[2 * t: 2 * t + Nh] for t in range(T))
    acc_o = sum(coef[t, P:] * bl[2 * t + 1: 2 * t + 1 + Nh]
                for t in range(T))
    v = torch.cat([acc_o.flip(-1), acc_e.flip(-1)], dim=-1)
    k = torch.arange(M, device=x.device, dtype=torch.float64)
    y = M * torch.fft.ifft(v, dim=-1) * torch.exp(2j * math.pi * k / M)
    return y.T * _hop_sign(M, Nh, parity, x.device).double()


def demod_f64(y, prev):
    """K2's discriminator in float64 on channel-major y (M, Nh)
    complex128 after prev (M, 2): fast_atan2's polynomial (dsp.fm)
    evaluated in float64 on y_n conj(y_{n-1})."""
    from amps_tpu_torch.dsp import fm
    s = torch.cat([torch.complex(prev[:, :1].double(), prev[:, 1:].double()),
                   y[:, :-1]], dim=1)
    w = y * s.conj()
    ax, ay = w.real.abs(), w.imag.abs()
    z = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-30)
    z2 = z * z
    base = z * (float(fm._ATAN_A) + z2 * (float(fm._ATAN_B) + z2 * (
        float(fm._ATAN_C) + z2 * float(fm._ATAN_D))))
    base = torch.where(ay > ax, float(fm._HALF_PI) - base, base)
    base = torch.where(w.real < 0, float(fm._PI) - base, base)
    return torch.where(w.imag < 0, -base, base)


def synth_f64(Y, M, T, parity, carry):
    """K4's function in float64 on Y (Nh, M, 2) and carry, on Y's
    device: u_n[m] = sum_k s_n[k] y_n[k] e^{+j2πkm/M} (s the hop sign)
    as M times an inverse FFT, then the overlap-add out[n + j] +=
    g_j u_n[(j & 1)P .. +P] with g = P · ``prototype_taps(M, T)`` and
    the carry added to the first 2T - 1 hops.  Returns (wideband (Nh·P,
    2), carry ((2T - 1)·P, 2)) float64."""
    from amps_tpu_torch.dsp.polyphase import _hop_sign, prototype_taps
    P, Nh = M // 2, Y.shape[0]
    g = torch.as_tensor(prototype_taps(M, T), device=Y.device).double() \
        .reshape(T, M) * P
    out = torch.zeros((Nh + 2 * T - 1, P), dtype=torch.complex128,
                      device=Y.device)
    step = max(1, (1 << 26) // M)      # hops a chunk: ~1 GB of complex128
    for a in range(0, Nh, step):
        b = min(a + step, Nh)
        # the chunk's hop sign, (b - a, M): its hops keep their parity
        y = torch.complex(Y[a:b, :, 0].double(), Y[a:b, :, 1].double()) \
            * _hop_sign(M, b - a, (parity + a) % 2, Y.device).double().T
        u = M * torch.fft.ifft(y, dim=-1)
        for j in range(2 * T):
            h = (j & 1) * P
            out[a + j: b + j] += g[j // 2, h: h + P] * u[:, h: h + P]
        del y, u
    out = torch.view_as_real(out.reshape(-1))
    out[: carry.shape[0]] += carry.double()
    return out[: Nh * P], out[Nh * P:]


def synth_f64_f32(Y, M, T, parity, carry):
    """``synth_f64`` rounded once to float32, in the wrapper's terms: a
    reference synthesis whose only error is that rounding.  Phases 7 and
    13 run their reference paths on it at widths where the plain
    synthesis is a dense f32 DFT past 8192 (phase 34): there its sums of
    16382 coherent terms (FOCC on every channel) stray from float64 by
    ~8e-5 of the band's peak, four times TX_PEAK_RTOL, on the H100."""
    out, tail = synth_f64(Y, M, T, parity, carry)
    return out.float(), tail.float()


def compare_synth(S, M, T, Nh, dev, seed, rtol=SYNTH_RTOL, witness=None):
    """Synthesis kernel vs plain version on random channel basebands
    with a nonzero carry-in, both hop parities, and two chained calls vs
    one; errors relative to the output RMS, held to ``rtol``.  With
    ``witness`` (a dict) both are also held to ``synth_f64``:
    witness[M] = (kernel, plain) max |err| / RMS over both parities.
    Returns the max abs error."""
    g = torch.Generator(dev).manual_seed(seed)
    Y = torch.randn((Nh, M, 2), device=dev, generator=g)
    carry = torch.randn((M * T - M // 2, 2), device=dev, generator=g)
    max_abs = 0.0
    for parity in (0, 1):
        x, c = S.synthesize_block(Y, M, T, parity, carry)
        rx, rc = S.synthesize_block_reference(Y, M, T, parity, carry)
        sync(dev)
        rms = rx.pow(2).mean().sqrt().item()
        ex, ec = (x - rx).abs().max().item(), (c - rc).abs().max().item()
        log(f"  synth M={M} T={T} Nh={Nh} parity {parity}: max|err| "
            f"{ex:.3e} ({ex / rms:.2e} of RMS), carry {ec:.3e} "
            f"({ec / rms:.2e})")
        assert torch.isfinite(x).all() and torch.isfinite(c).all()
        assert ex <= rtol * rms and ec <= rtol * rms
        max_abs = max(max_abs, ex, ec)
        if witness is not None:
            fx, fc = synth_f64(Y, M, T, parity, carry)
            frms = fx.pow(2).mean().sqrt().item()
            witness[M] = tuple(
                max(w, (a.double() - fx).abs().max().item() / frms,
                    (b.double() - fc).abs().max().item() / frms)
                for w, (a, b) in zip(witness.get(M, (0.0, 0.0)),
                                     ((x, c), (rx, rc))))
    h = Nh // 2 + 1
    xa, ca = S.synthesize_block(Y[:h].contiguous(), M, T, 0, carry)
    xb, cb = S.synthesize_block(Y[h:].contiguous(), M, T, h % 2, ca)
    x, c = S.synthesize_block(Y, M, T, 0, carry)
    sync(dev)
    e = max((torch.cat([xa, xb]) - x).abs().max().item(),
            (cb - c).abs().max().item()) / x.pow(2).mean().sqrt().item()
    log(f"  synth M={M}: two chained calls vs one, max|err| {e:.2e} of RMS")
    assert e <= rtol
    return max_abs


def compare_rx_front(R, x_ext, M, T, label, events, dev):
    """Streaming front-end kernel vs plain version, both parities, a
    random carried prev_iq: demod under the branch-cut rule and to
    PHASE_ATOL inside the planted bursts, the power series to
    SERIES_RTOL inside the bursts and as 384-hop block means, `last` to
    LAST_RTOL of its RMS (roundoff of the two
    transforms' summation orders); and two chained calls (prev_iq = the first call's `last`) equal
    one call bit for bit.  Returns the max abs demod error in bursts."""
    from amps_tpu_torch.rx.correlator import window_power_blocks
    P = M // 2
    Nh = x_ext.shape[0] // P - (2 * T - 1)
    prev = torch.randn((M, 2), device=dev,
                       generator=torch.Generator(dev).manual_seed(M))
    burst_err = 0.0
    for parity in (0, 1):
        d, last, pw = R.analyze_demod(x_ext, M, T, parity, prev)
        rd, rlast, rpw = R.analyze_demod_reference(x_ext, M, T, parity, prev)
        sync(dev)
        assert d.shape == rd.shape == pw.shape == (M, Nh), label
        assert torch.isfinite(d).all() and torch.isfinite(pw).all(), label
        err = (d - rd).abs()
        beyond = (err > PHASE_ATOL).double().mean().item()
        rel = (pw - rpw).abs() / rpw.abs().clamp(min=1e-30)
        blk, rblk = (window_power_blocks([p]) for p in (pw, rpw))
        blk_rel = ((blk - rblk).abs() / rblk.clamp(min=1e-30)).max().item()
        last_e = ((last - rlast).abs().max()
                  / rlast.pow(2).mean().sqrt()).item()
        series = 0.0
        for ev in events:
            h0, h1 = ev.start_hop + 2 * T + 1, min(ev.start_hop + BURST_HOPS,
                                                   Nh)
            if h1 > h0:
                burst_err = max(burst_err, err[ev.channel, h0:h1].max().item())
                series = max(series, rel[ev.channel, h0:h1].max().item())
        log(f"  {label} parity {parity}: demod max|err| "
            f"{err.max().item():.3e}, share > {PHASE_ATOL} {beyond:.2e}, "
            f"in bursts {burst_err:.3e}; power series rel in bursts "
            f"{series:.2e} (whole plane {rel.max().item():.2e}), 384-hop "
            f"block means {blk_rel:.2e}; last {last_e:.2e} of RMS")
        assert beyond <= BRANCH_CUT_FRACTION, (label, beyond)
        assert burst_err <= PHASE_ATOL, (label, burst_err)
        assert series <= SERIES_RTOL and blk_rel <= SERIES_RTOL, label
        assert last_e <= LAST_RTOL, label
    n1 = Nh // 2 + 1
    zero = torch.zeros_like(prev)
    d, last, pw = R.analyze_demod(x_ext, M, T, 0, zero)
    da, la, pa = R.analyze_demod(x_ext[: (n1 + 2 * T - 1) * P].contiguous(),
                                 M, T, 0, zero)
    db, lb, pb = R.analyze_demod(x_ext[n1 * P:].contiguous(), M, T, n1 % 2,
                                 la)
    sync(dev)
    assert torch.equal(torch.cat([da, db], 1), d) and torch.equal(lb, last)
    assert torch.equal(torch.cat([pa, pb], 1), pw)
    log(f"  {label}: two chained calls equal one call bit for bit")
    return burst_err


def check_forward_band(K3, band, M, T, sps, want_bits, chans, page):
    """Read the forward band back through the rx_phases kernel: slice
    each channel's Manchester symbols after the bank delay of 2T-1 hops
    and compare the second superframe's frame bits on ``chans`` with
    ``want_bits`` (channel -> bits); ``page`` = (channel, slot, word28)
    must appear as word A of that frame.  band: two superframes and the
    synthesis tail (silence follows)."""
    from amps_tpu_torch.tx.focc import _FRAME_SRC, FRAME_BITS
    P = M // 2
    zeros = torch.zeros((M * T - P, 2), device=band.device)
    x_ext = torch.cat([zeros, band, zeros]).contiguous()
    ph, _, _ = K3.analyze_phases(x_ext, M, T, sps)
    delay = 2 * T - 1
    p, j0 = delay % sps, delay // sps
    nb = next(iter(want_bits.values())).shape[-1]
    sym = ph[:, p, j0: j0 + 4 * nb].reshape(M, 2 * nb, 2)
    bits = (sym[..., 0] - sym[..., 1] < 0).to(torch.uint8)[:, nb:].cpu()
    bad = [c for c in chans if not torch.equal(bits[c], want_bits[c])]
    assert not bad, f"frame bits differ on channels {bad}"
    c, slot, word = page
    frame = bits[c].reshape(-1, FRAME_BITS)[slot].numpy()
    msg = frame[_FRAME_SRC >= 0]
    assert np.array_equal(msg[21:49], word), "page word not on its channel"
    return len(chans)


def rx_duplex_events(M: int, T: int, total_hops: int, seed: int):
    """10 planted bursts of 2..7 random words, DCC 0, at channels 0, 1,
    M/2-1, M/2, M-1 and five others; the last ends 4 hops before the
    stream does.  The others start at hops 300 .. 34001 of a stream of
    49152 hops or more (six pushes of 8192), and in a shorter one (phase
    35's pushes of 4096 hops) in proportion to the hops left before the
    last."""
    from amps_tpu_torch.eval.traffic import BurstEvent
    rng = np.random.default_rng(seed)
    chans = [0, 1, M // 2 - 1, M // 2, M - 1, 200 % M, 700 % M, 3, 900 % M,
             64 % M]
    scale = min(1.0, (total_hops - 4 - BURST_HOPS) / (49152 - 4 - BURST_HOPS))
    starts = [int(h * scale) for h in (300, 5000, 9001, 12002, 15000, 20001,
                                       26002, 30000, 34001)] \
        + [total_hops - 4 - BURST_HOPS]
    return [BurstEvent(c, h, rng.integers(0, 2, (int(rng.integers(2, 8)),
                                                 36)).astype(np.uint8))
            for c, h in zip(chans, starts)]


def stream_reports(MR, spec, blocks, front_end=None, depth=2,
                   pad_tail=True, search=None):
    """Report list of one receiver over the blocks, flushed.  The
    receiver is built without a device, so it lives on the card, where
    the blocks are."""
    kw = {k: f for k, f in (("front_end", front_end), ("search", search))
          if f is not None}
    rx = MR(spec, pipeline_depth=depth, **kw)
    reps = []
    for b in blocks:
        reps += rx.push(b)
    assert rx.device == blocks[0].device, (rx.device, blocks[0].device)
    return reps + rx.flush(pad_tail=pad_tail)


def plain_search(*a, **k):
    """The trigger search's plain version, the plain paths' search."""
    from amps_tpu_torch.rx.correlator import find_bursts_phases_reference
    return find_bursts_phases_reference(*a, **k)


def report_key(r):
    return (r.channel, r.abs_symbol, r.words.tolist(), r.word_ok.tolist(),
            np.asarray(r.bad_symbols).tolist(), r.dcc)


def phase_synth(dev, widths, T):
    """Phase 5: the synthesis kernel against its plain version."""
    from amps_tpu_torch.kernels import synth as S
    log("phase 5: synth kernel vs plain version (random Y, carry-in)")
    return {M: compare_synth(S, M, T, 8192, dev, M) for M in widths}


def phase_rx_front(dev, widths, T):
    """Phase 6: the streaming front-end kernel against its plain version
    on a planted band (noise of BAND_SIGMA)."""
    from amps_tpu_torch.eval.traffic import synthesize_reverse_band
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.parallel import pipeline as pl
    log("phase 6: rx_front kernel vs plain version (planted band, "
        "random prev_iq)")
    errs = {}
    for M in widths:
        P, Nh = M // 2, 8192
        spec = pl.MultichannelSpec(num_channels=M, taps_per_phase=T,
                                   fold="bank")
        planted = plant_events(M, 5)
        band = synthesize_reverse_band(planted, spec, Nh,
                                       noise_sigma=BAND_SIGMA, device=dev)
        x_ext = torch.cat([torch.zeros(((2 * T - 1) * P, 2), device=dev),
                           band]).contiguous()
        errs[M] = compare_rx_front(R, x_ext, M, T, f"rx_front M={M} Nh={Nh}",
                                   planted, dev)
    return errs


def phase_tx(dev, M, T, n_random=60, witness=False):
    """Phase 7: MultichannelTransmitter, all M channels FOCC, a page on
    channel 1; two superframes through the synth kernel, held against
    the plain synthesis (with ``witness``, the float64 one,
    ``synth_f64_f32``) and read back through the rx_phases kernel.
    Returns the synth kernel's launches in the two next_block calls."""
    from amps_tpu_torch.codec import words as W
    from amps_tpu_torch.kernels import rx_phases as K3
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime.streamer import MultichannelTransmitter
    from amps_tpu_torch.tx.focc import STREAM_BOTH, FoccStream, focc_frame_bits
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    sps = prod.chan_sps
    log(f"phase 7: MultichannelTransmitter, M={M}, all channels FOCC, page "
        f"on channel 1, two superframes")
    page = [W.focc_word1(True, 0, 0x5A5A5A).numpy(),
            W.focc_word2_general(0x2D3, 0, 0, 0).numpy()]
    tx = MultichannelTransmitter(prod, device=dev)
    against = "float64" if witness else "plain"
    tx_plain = MultichannelTransmitter(
        prod, device=dev, synthesize=synth_f64_f32 if witness
        else S.synthesize_block_reference)
    mirror = FoccStream(sps=sps)
    for st in (tx.focc[1], tx_plain.focc[1], mirror):
        st.push_words(STREAM_BOTH, page, repeats=2)
    S.LAUNCHES = 0
    xs = [tx.next_block() for _ in range(2)]
    sync(dev)
    launches = S.LAUNCHES
    log(f"  synth kernel launches on the main path: {launches}")
    for i, x in enumerate(xs):
        ref = tx_plain.next_block()
        sync(dev)
        rms = ref.pow(2).mean().sqrt().item()
        peak = ref.abs().max().item()
        e = (x - ref).abs().max().item()
        log(f"  superframe {i}: {tuple(x.shape)}, max|err| vs {against} "
            f"synthesis {e:.3e} ({e / peak:.2e} of the peak, {e / rms:.2e} "
            f"of RMS)")
        assert torch.isfinite(x).all() and e <= TX_PEAK_RTOL * peak
    del x, ref                  # (a superframe is 6.5 GB at M=32766)
    mirror.next_word_pairs()
    rng = np.random.default_rng(M)
    fixed = [0, 1, M // 2 - 1, M // 2, M - 1]
    others = [int(c) for c in rng.permutation(M) if c not in fixed]
    chans = fixed + others[:n_random]
    # every channel but 1 sends the same steady-state superframe: its bits
    # once, for each channel read back
    idle = focc_frame_bits(FoccStream(sps=sps).next_word_pairs())
    want = {c: idle for c in chans}
    want[1] = focc_frame_bits(mirror.next_word_pairs())
    band = torch.cat(xs + [tx._state.carry])
    del xs
    n = check_forward_band(K3, band, M, T, sps, want, chans,
                           (1, 4, page[0]))
    log(f"  read back through the rx_phases kernel after the bank delay: "
        f"the second superframe's frame bits equal focc_frame_bits on {n} "
        f"channels "
        f"(0, 1, M/2-1, M/2, M-1 and {len(chans) - 5} random); the page "
        f"word is frame 4's word A on channel 1")
    return launches


def phase_rx(dev, M, T, push=RX_PUSH, n_push=6):
    """Phase 8: planted RECC bursts streamed through MultichannelReceiver
    (pipeline_depth=2) in pushes of ``push`` samples, one of them not a
    multiple of M/2; flush(pad_tail=True) completes the last burst.  The
    trigger search kernel runs once a window, as the front end does.
    Returns (rx_front launches, pushes)."""
    from amps_tpu_torch.eval.traffic import synthesize_reverse_band
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import trigger_search as KS
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime.streamer import MultichannelReceiver
    P, sps = M // 2, 3
    total = n_push * push // P
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    events = rx_duplex_events(M, T, total, 553)
    x = synthesize_reverse_band(events, prod, total, noise_sigma=0.001,
                                device=dev)
    sizes = [push] * n_push
    sizes[1], sizes[2] = push + 100, push - 100
    edges = np.cumsum(sizes)
    blocks = [x[e - n: e] for e, n in zip(edges, sizes)]
    bounds = edges[:-1] // P
    straddle = sum(any(ev.start_hop < b < ev.start_hop + BURST_HOPS
                       for b in bounds) for ev in events)
    log(f"phase 8: MultichannelReceiver, M={M}, production spec, depth 2, "
        f"{len(events)} planted bursts (σ 0.001), pushes of {sizes} "
        f"samples; {straddle} bursts straddle a push boundary")
    assert straddle >= 3 and any(n % P for n in sizes)
    R.LAUNCHES = KS.LAUNCHES = 0
    reps = stream_reports(MultichannelReceiver, prod, blocks)
    sync(dev)
    launches = R.LAUNCHES
    log(f"  rx_front kernel launches on the main path: {launches} "
        f"({len(blocks)} pushes + the pad_tail push), trigger search "
        f"kernel launches {KS.LAUNCHES}")
    assert KS.LAUNCHES == launches, (KS.LAUNCHES, launches)
    assert len(reps) == len(events), [report_key(r)[:2] for r in reps]
    for ev in events:
        # the capture starts after 41 bits of dotting and word sync, one
        # bank delay (2T-1 hops) later at the receiver
        want_sym = (ev.start_hop + 41 * 2 * sps + 2 * T - 1) // sps
        mine = [r for r in reps if r.channel == ev.channel
                and r.abs_symbol == want_sym]
        assert len(mine) == 1, (ev.channel, want_sym, len(mine))
        r, nw = mine[0], len(ev.words)
        assert np.array_equal(r.words[:nw], ev.words), ev.channel
        assert r.word_ok[:nw].all() and r.dcc == 0, ev.channel
    log(f"  every planted burst reported once: channel, abs_symbol, words, "
        f"word_ok and DCC 0 right, no other report; rssi "
        f"{[round(r.rssi, 4) for r in reps]}")
    f32 = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank")
    kern = stream_reports(MultichannelReceiver, f32, blocks)
    plain = stream_reports(MultichannelReceiver, f32, blocks,
                           front_end=R.analyze_demod_reference,
                           search=plain_search)
    assert [report_key(r) for r in kern] == [report_key(r) for r in plain]
    assert [report_key(r)[:3] for r in kern] == \
        [report_key(r)[:3] for r in reps]
    nopad = stream_reports(MultichannelReceiver, f32, blocks, depth=1,
                           pad_tail=False)
    last = events[-1]
    assert len(nopad) == len(events) - 1 and not any(
        r.channel == last.channel and r.abs_symbol * sps > last.start_hop
        for r in nopad)
    log(f"  f32 spec: kernel front end and plain front end give the "
        f"identical report list ({len(kern)} reports); without pad_tail "
        f"the last burst is not reported")
    return launches, len(blocks)


def phase_times(dev, M, T, card, n_timed=10):
    """Phase 9: kernels and the duplex paths against their plain
    versions; medians, CUDA events."""
    from amps_tpu_torch.eval.traffic import synthesize_reverse_band
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime.streamer import (MultichannelReceiver,
                                                 MultichannelTransmitter)
    P, n = M // 2, RX_PUSH
    Nh = n // P
    log(f"phase 9: times, M={M}, median of {n_timed}, CUDA events, on {card}")
    g = torch.Generator(dev).manual_seed(1)
    Y = torch.randn((Nh, M, 2), device=dev, generator=g)
    carry = torch.randn((M * T - P, 2), device=dev, generator=g)
    out = {"synth": timed({
        "kernel": lambda: S.synthesize_block(Y, M, T, 0, carry),
        "plain": lambda: S.synthesize_block_reference(Y, M, T, 0, carry),
    }, n_timed, KERNEL_REPS)}
    # the synthesis reads Y and the carry and writes Nh*P samples and the
    # new carry
    sy = out["synth"]
    sy["bound"], sy["bound_by"] = bound(
        M, T, Nh, 2 * nbytes(carry) + nbytes(Y) + Nh * P * 8)
    sy["fft"] = fft_ms(M, Nh, dev, inverse=True)
    # a superframe, the shape next_block hands the kernel
    n_sf = 18 * 463 * 2 * 3
    Ysf = torch.randn((n_sf, M, 2), device=dev, generator=g)
    out["synth_sf"] = timed({
        "kernel": lambda: S.synthesize_block(Ysf, M, T, 0, carry),
        "plain": lambda: S.synthesize_block_reference(Ysf, M, T, 0, carry),
    }, n_timed, KERNEL_REPS)
    ss = out["synth_sf"]
    ss["bound"], ss["bound_by"] = bound(
        M, T, n_sf, 2 * nbytes(carry) + nbytes(Ysf) + n_sf * P * 8)
    ss["fft"] = fft_ms(M, n_sf, dev, inverse=True)
    del Ysf
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    xb = synthesize_reverse_band(plant_events(M, 11), prod, Nh,
                                 noise_sigma=0.001, device=dev)
    x_ext = torch.cat([torch.zeros(((2 * T - 1) * P, 2), device=dev),
                       xb]).contiguous()
    prev = torch.zeros((M, 2), device=dev)
    out["rx_front"] = timed({
        "kernel": lambda: R.analyze_demod(x_ext, M, T, 0, prev),
        "plain": lambda: R.analyze_demod_reference(x_ext, M, T, 0, prev),
    }, n_timed, KERNEL_REPS)
    # reads the block, its tables and prev; writes demod and power planes
    # and `last`; the discriminator's few operations a sample are left out
    fe = out["rx_front"]
    fe["bound"], fe["bound_by"] = bound(
        M, T, Nh, nbytes(x_ext, prev, *R._tables(M, T, dev))
        + 2 * M * Nh * 4 + nbytes(prev))
    fe["fft"] = fft_ms(M, Nh, dev)
    rxs = {"kernel": MultichannelReceiver(prod, device=dev),
           "plain": MultichannelReceiver(
               prod, device=dev, front_end=R.analyze_demod_reference,
               search=plain_search)}
    out["push"] = timed({k: (lambda r=r: r.push(xb)) for k, r in rxs.items()},
                        n_timed)
    profile_window(f"MultichannelReceiver.push of {n} samples, kernel "
                   f"front end", lambda: rxs["kernel"].push(xb), dev)
    txs = {"kernel": MultichannelTransmitter(prod, device=dev),
           "plain": MultichannelTransmitter(
               prod, device=dev, synthesize=S.synthesize_block_reference)}
    out["next_block"] = timed({k: t.next_block for k, t in txs.items()},
                              max(3, n_timed // 3))
    profile_window("MultichannelTransmitter.next_block, one superframe, "
                   "synth kernel", txs["kernel"].next_block, dev)
    for name, label, samples in (
            ("synth", f"synth kernel, Nh={Nh}", Nh * P),
            ("synth_sf", f"synth kernel, a superframe (Nh={n_sf})",
             n_sf * P),
            ("rx_front", f"rx_front kernel, Nh={Nh}", n),
            ("push", f"MultichannelReceiver.push of {n} samples, depth 1",
             n),
            ("next_block", "MultichannelTransmitter.next_block, one "
             "superframe, all channels", n_sf * P)):
        for k in ("kernel", "plain"):
            ms = out[name][k]
            log(f"  {label}, {k}: {ms:.3f} ms, "
                f"{samples / ms / 1e3:.1f} Msamples/s")
        if "bound" in out[name]:
            log(f"  {label}: bound {out[name]['bound']:.3f} ms "
                f"({out[name]['bound_by']}), cuFFT of the plane "
                f"{out[name]['fft']:.3f} ms")
    return out


def profile_window(label, fn, dev, top=6, all_threads=False):
    """One call of ``fn`` under torch.profiler after a warm-up: device
    busy time (the union of the card's kernel and copy spans), the traced
    sections (``utils.profiling.trace`` ranges; of every thread when
    ``all_threads``, through the profiler's experimental config), the host
    wall time of the same call without the profiler (median of 3; the
    profiler's own host cost would inflate it), the idle share between
    them, and the top device ops by total time.  Returns (busy ms, wall
    ms, {op name: (device ms, calls)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    # the profiler's device-side record buffers are allocated on the card
    # while it traces: release the allocator's unused cache first
    torch.cuda.empty_cache()
    walls = []
    for _ in range(4):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls[1:]))
    # device activity is recorded from every thread in any case; other
    # threads' record_function ranges (the app's TX and RX threads) only
    # under this config
    config = (torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
              if all_threads else None)
    # a window whose trace holds no device activity at all is taken again,
    # up to PROFILE_TRIES times (CUPTI dropped a whole window of the ear's
    # once on a card where the same window had recorded 37 ops before)
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     experimental_config=config) as prof:
            # the first launch after the profiler starts may go unrecorded
            # (a window that opens on a hand-written kernel lost its span
            # in some runs): spend it on a fill, and count what starts in
            # the window
            torch.zeros(1, device=dev)
            sync(dev)
            t0 = time.perf_counter()
            with record_function("profile_window"):
                fn()
                sync(dev)
            wall_prof = (time.perf_counter() - t0) * 1e3
        t_win = min(e.time_range.start for e in prof.events()
                    if e.name == "profile_window")
        # a record_function range (profile_window's own, the port's
        # utils.profiling.trace sections) is not device work
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and e.time_range.start >= t_win and e.name != "profile_window"
              and not e.is_user_annotation]
        if ev:
            break
        log(f"  profile, {label}: the trace holds no device activity "
            f"(try {attempt + 1} of {PROFILE_TRIES})")
    assert ev, f"{label}: the profiler saw no device activity"
    ranges = {}
    for e in prof.events():
        if e.is_user_annotation and e.device_type == DeviceType.CPU and \
                e.name != "profile_window":
            ranges[e.name] = ranges.get(e.name, 0) + 1
    busy, end, by_name = 0.0, -math.inf, {}
    for a, b, name in sorted((e.time_range.start, e.time_range.end, e.name)
                             for e in ev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        us, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (us + (b - a), calls + 1)
    busy /= 1e3
    log(f"  profile, {label}: device busy {busy:.3f} ms in {len(ev)} device "
        f"ops, host wall {wall:.3f} ms ({wall_prof:.3f} under the "
        f"profiler), idle share {1 - busy / wall:.1%}; card memory free "
        f"{torch.cuda.mem_get_info(dev)[0] / 1e9:.2f} GB after it")
    if ranges:
        log("    traced sections: " + ", ".join(
            f"{k} {n}x" for k, n in sorted(ranges.items())))
    for name, (us, calls) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:top]:
        log(f"    {us / 1e3:8.3f} ms {us / 1e3 / busy:6.1%} {calls:5d}x  "
            f"{name[:90]}")
    return busy, wall, {k: (us / 1e3, calls)
                        for k, (us, calls) in by_name.items()}


def bound(M, T, Nh, nbytes):
    """(least ms, what sets it) of one bank pass over Nh hops that moves
    ``nbytes``, at the published H100 SXM peaks.  The least work of the
    function is an FFT-sized transform, 5·M·log2(M) flops a hop (the
    radix-2 count of an M-point complex FFT), plus the polyphase fold or
    overlap-add, 2·T·M FMAs a hop."""
    flops = Nh * (5 * M * math.log2(M) + 4 * T * M)
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def fft_ms(M, Nh, dev, inverse=False):
    """The transform-only yardstick: cuFFT over M of the (Nh, M) complex64
    plane (timed here, never called by the port)."""
    g = torch.Generator(dev).manual_seed(Nh)
    z = torch.randn((Nh, M), dtype=torch.complex64, device=dev, generator=g)
    f = torch.fft.ifft if inverse else torch.fft.fft
    return timed({"fft": lambda: f(z, dim=-1)}, 10, KERNEL_REPS)["fft"]


def phase_analysis(dev, T, card, n_timed=10):
    """Phase 10: the analysis kernel (K1) against its plain version on
    unit-amplitude channels at M = 1024 and 256, Nh = 8192 and a
    superframe's 50004 hops; both parities, riq and planar in and out;
    two chained calls equal one.  Returns ({(M, Nh): max abs error},
    {(M, Nh): times})."""
    from amps_tpu_torch.eval.traffic import unit_channel_band
    from amps_tpu_torch.kernels import analysis as KA
    log(f"phase 10: analysis kernel vs plain version (unit-amplitude "
        f"channels, atol {ANALYSIS_ATOL}); times median of {n_timed}, CUDA "
        f"events, on {card}")
    errs, times = {}, {}
    for M in (1024, 256):
        for Nh in (8192, 50004):
            x = unit_channel_band(M, T, Nh, M + Nh, dev)
            xp = x.t().contiguous()
            err = 0.0
            for parity in (0, 1):
                for xi, pin, pout in ((x, False, False), (xp, True, True),
                                      (x, False, True)):
                    y = KA.analyze_block(xi, M, T, parity, pout, pin)
                    ry = KA.analyze_reference(xi, M, T, parity, pout, pin)
                    sync(dev)
                    assert y.shape == ry.shape and torch.isfinite(y).all()
                    e = (y - ry).abs().max().item()
                    err = max(err, e)
                    assert e <= ANALYSIS_ATOL, (M, Nh, parity, pin, pout, e)
                    del y, ry
            P = M // 2
            n1 = Nh // 2 + 1
            y = KA.analyze_block(x, M, T, 0)
            ya = KA.analyze_block(x[: (n1 + 2 * T - 1) * P].contiguous(), M,
                                  T, 0)
            yb = KA.analyze_block(x[n1 * P:].contiguous(), M, T, n1 % 2)
            sync(dev)
            assert torch.equal(torch.cat([ya, yb], 1), y), (M, Nh)
            del y, ya, yb
            errs[M, Nh] = err
            t = timed({"kernel": lambda: KA.analyze_block(x, M, T, 0),
                       "plain": lambda: KA.analyze_reference(x, M, T, 0)},
                      n_timed, KERNEL_REPS)
            t["fft"] = fft_ms(M, Nh, dev)
            tables = KA._tables(M, T, dev)
            t["bound"], t["bound_by"] = bound(
                M, T, Nh, nbytes(x, *tables) + M * Nh * 8)
            times[M, Nh] = t
            log(f"  M={M} Nh={Nh}: max|err| {err:.3e} over both parities, "
                f"riq/planar; two chained calls equal one bit for bit; "
                f"kernel {t['kernel']:.3f} ms, plain {t['plain']:.3f} ms, "
                f"cuFFT {t['fft']:.3f} ms, bound {t['bound']:.3f} ms "
                f"({t['bound_by']})")
            del x, xp
            torch.cuda.empty_cache()
    return errs, times


def phase_call(dev, M, T, analysis_block=None, label="kernel ear",
               sigma=1e-3, profile=False):
    """Phase 11: tests/test_system_loop.py's whole call at full width.
    The station's FOCC rides slot 1 of a transmitter carrying FOCC on
    every slot but 3, 4 and 5, its VoiceFvcSlot slot 4 (AMPS channel
    355); the mobile's ear analyzes the whole band each superframe and
    only its two demod rows cross to the host; its RECC bursts are
    synthesized into a 1024-channel reverse band (slot 3, σ ``sigma``
    noise) and pushed into the streaming receiver.  Every entry point
    runs on its default device.  Returns (mob.log, decoded FOCC frames
    and FVC words per superframe, kernel launches, per-superframe times).
    """
    from amps_tpu_torch.control.station import BaseStation
    from amps_tpu_torch.dsp import channelizer as chz
    from amps_tpu_torch.dsp.fm import fm_modulate_symbols, quadrature_demod
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.ms import SimMobile, decode_focc_stream
    from amps_tpu_torch.ms import decode_fvc_words
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime.sources import VoiceFvcSlot
    from amps_tpu_torch.runtime.streamer import (MultichannelReceiver,
                                                 MultichannelTransmitter)
    focc_slot, fvc_slot, rev_slot = 1, 4, 3
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    sps, P = prod.chan_sps, M // 2
    station = BaseStation(sps=sps)
    tx = MultichannelTransmitter(
        prod, control_channels=[c for c in range(M) if c not in (3, 4, 5)])
    station.focc = tx.focc[focc_slot]
    slot, slot_ms = VoiceFvcSlot(station), []

    def voice_fvc(n):        # the slot, its time recorded
        t0 = time.perf_counter()
        out = slot(n)
        slot_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    tx.set_channel_source(fvc_slot, voice_fvc)
    rx = MultichannelReceiver(
        prod, threshold=0.5, min_rssi=0.05,
        on_burst=lambda r: station.handle_burst(r.words, r.word_ok,
                                                r.bad_symbols))
    mob = SimMobile("5551234567", sps=sps)
    ear = {"s": chz.analyzer_init(prod.chz_spec)}
    assert tx.device.type == rx.device.type == slot.device.type == \
        ear["s"].history.device.type == dev.type
    noise = torch.Generator(dev).manual_seed(553)
    heard, times = [], []

    def clock(f):
        sync(dev)
        t0 = time.perf_counter()
        out = f()
        sync(dev)
        return out, (time.perf_counter() - t0) * 1e3

    def listen(blk):
        ear["blk"] = blk
        Y, ear["s"] = chz.analyze(blk, prod.chz_spec, ear["s"],
                                  block=analysis_block, chmajor=True)
        demod, _ = quadrature_demod(Y[[focc_slot, fvc_slot]])
        return demod.cpu().numpy()

    def forward():
        blk, t_tx = clock(tx.next_block)
        rows, t_ear = clock(lambda: listen(blk))
        assert rows.shape == (2, blk.shape[0] // P) and np.isfinite(
            rows).all()
        mob.hear_focc(rows[0], sps=sps)
        mob.hear_fvc(rows[1], sps=sps)
        frames = decode_focc_stream(rows[0], sps)
        heard.append(([(f.word_a.tolist(), f.word_b.tolist(), bool(f.ok_a),
                        bool(f.ok_b), bool(f.busy)) for f in frames],
                      [w.tolist() for w in decode_fvc_words(rows[1], sps)]))
        times.append({"next_block": t_tx, "slot": slot_ms[-1],
                      "ear": t_ear})

    def reverse():
        t_push = 0.0
        while mob.outbox:
            _, syms = mob.outbox.pop(0)
            bb, _ = fm_modulate_symbols(
                torch.as_tensor(syms.astype(np.int8), device=dev),
                prod.fm_sensitivity)
            Y = torch.zeros((bb.shape[0] + 4000, M, 2), device=dev)
            Y[2000: 2000 + bb.shape[0], rev_slot] = bb
            x, _ = chz.synthesize(Y, prod.chz_spec,
                                  chz.synthesizer_init(prod.chz_spec))
            x = x + sigma * torch.randn(x.shape, device=dev, generator=noise)
            _, t = clock(lambda: rx.push(x[: (x.shape[0] // P) * P]))
            t_push += t
        times[-1]["push"] = t_push

    sv = station.supervisors
    KA.LAUNCHES = R.LAUNCHES = S.LAUNCHES = 0
    station.handle_command("page 5551234567")
    forward()
    assert "paged" in mob.log, mob.log
    reverse()
    assert sv[355].state == "alerting"
    forward()
    assert mob.voice_chan == 355 and mob.state == "ringing", mob.log
    station.push_supervision(355, *mob.supervision_frames(30))
    assert sv[355].state == "alerting"
    mob.answer()
    station.push_supervision(355, *mob.supervision_frames(30))
    assert sv[355].state == "conversation"
    assert (station.fvc_mute, station.audio_mute) == (True, False)
    station.handle_command("handoff 355 356")
    forward()
    assert mob.voice_chan == 356, mob.log
    station.push_supervision(356, *mob.supervision_frames(50))
    assert sv[356].state == "conversation"
    mob.hang_up()
    station.push_supervision(356, *mob.supervision_frames(200))
    sync(dev)
    launches = {"analysis": KA.LAUNCHES, "rx_front": R.LAUNCHES,
                "synth": S.LAUNCHES}
    assert 356 not in sv
    assert [e for e in station.events if e.kind == "release"]
    assert mob.log == CALL_LOG, mob.log
    for i, t in enumerate(times):
        log(f"  {label}, superframe {i}: tx.next_block {t['next_block']:.3f} "
            f"ms (of it the voice/FVC slot {t['slot']:.3f} ms), "
            f"ear (analyze + 2 demod rows to host) {t['ear']:.3f} ms"
            + (f", rx.push {t['push']:.3f} ms" if "push" in t else ""))
    log(f"  {label}: mob.log {mob.log}; launches {launches}; FOCC frames "
        f"decoded per superframe {[len(h[0]) for h in heard]}, FVC words "
        f"{[len(h[1]) for h in heard]}")
    if profile:     # after the call: the ear hears its last block again
        profile_window(f"one superframe of the {label} (analyze + 2 demod "
                       f"rows to host)", lambda: listen(ear["blk"]), dev)
    return mob.log, heard, launches, times


CHANNEL_MSPS = 0.03         # a 30 kHz channel; an M-channel band runs at
                            # M x it (30.72 Msamples/s at M=1024)
BATCH_ATOL = 1e-2           # batched vs single band: bf16 quality (one
                            # bf16 step near 1 is 4e-3), f32 rssi, chan_power
LOOP_QUALITY_ATOL = 2e-3    # quality_max, kernel path vs plain path (f32
                            # planes; bf16 planes round it to ~4e-3 steps)


ATAN_SEAM = 0.0417          # fast_atan2's step where |im| = |re|: its
                            # polynomial reads 0.76457 at z = 1, pi/4 - 0.02083


# phase 12's banks: 2, 4 and 6 (the smallest the JAX package takes), and 8
# (the station app's default), 16 and 32
SMALL_WIDTHS = (2, 4, 6, 8, 16, 32)


def demod_err(d, rd):
    """Two demod planes of a signal band, sample by sample: (max |err|
    off the seam, samples on it).  Every sample is held to PHASE_ATOL but
    those at the octant seam of ``fast_atan2`` (|angle| within 0.025 of
    pi/4 or 3pi/4), where the reference's polynomial steps by ATAN_SEAM
    and two f32 summation orders may land on either side: they are held
    to the step, and to BRANCH_CUT_FRACTION of the plane."""
    err, a = (d - rd).abs(), rd.abs()
    seam = ((a - math.pi / 4).abs() < 0.025) \
        | ((a - 3 * math.pi / 4).abs() < 0.025)
    on_seam = (err > PHASE_ATOL) & seam
    off = err.masked_fill(on_seam, 0.0).max().item()
    n = int(on_seam.sum())
    assert off <= PHASE_ATOL, off
    assert n <= BRANCH_CUT_FRACTION * err.numel(), n
    assert n == 0 or err[on_seam].max().item() <= ATAN_SEAM + PHASE_ATOL
    return off, n


def fsk_band(M, T, Nh, seed, dev):
    """History-prepended wideband ((Nh + 2T - 1) * M/2, 2) whose M
    channels all carry random-data FSK at 3 hops a symbol (the
    discriminator stays within ±0.84 rad: no branch cut at ±pi, so a
    front end is held sample by sample), through the plain synthesis
    bank."""
    from amps_tpu_torch.dsp import channelizer as chz
    from amps_tpu_torch.dsp.fm import fm_modulate_symbols
    rng = np.random.default_rng(seed)
    syms = np.repeat(rng.choice(np.array([-1, 1], np.int8), (M, -(-Nh // 3))),
                     3, axis=1)[:, :Nh]
    bb, _ = fm_modulate_symbols(torch.as_tensor(syms, device=dev),
                                2.0 * np.pi * 8000 / 60000)
    carry = torch.zeros((M * T - M // 2, 2), device=dev)
    x, _ = chz._synthesize_block(bb.transpose(0, 1).contiguous(), M, T, 0,
                                 carry)
    return torch.cat([carry, x]).contiguous()


def phase_small_widths(dev, Nh=4001, widths=SMALL_WIDTHS, Ts=(4, 8),
                       label="phase 12: the small banks", times=True,
                       seam=False, bounds=None, witness=None):
    """Phase 12: the four kernels against their plain versions at the
    small banks M = 2, 4, 6, 8, 16, 32 (the station app's default bank is
    8 channels), T = 4 and 8, both parities, riq and planar where the
    kernel takes both, two chained calls against one, at the bounds the
    wide widths meet; then each kernel's time at these widths, Nh=8192,
    T=8.  Phase 29 runs the same checks at its ``widths`` with ``seam``:
    a demod sample on fast_atan2's seam is then held as ``demod_err``
    holds it, and moves the sps phase symbols it enters by a third of
    the step.  ``bounds`` ({kernel: bound}, phase 32) holds K1's max |err|
    on its unit-modulus channels, K2's demod error off the seam
    (radians) and K4's share of the output's RMS to tighter bounds than
    ANALYSIS_ATOL, PHASE_ATOL and SYNTH_RTOL.  ``witness`` (phase 33,
    {kernel: {}} for analysis, rx_front and synth) gets {M: (kernel
    error, plain error)} against the float64 references
    ``analysis_f64``, ``demod_f64`` and ``synth_f64``, in the terms of
    ``bounds``, the largest over both parities, riq and planar.  Returns ({kernel: {M: max abs error}},
    {kernel: {M: (kernel ms, plain ms)}})."""
    from amps_tpu_torch.eval.traffic import unit_channel_band
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.rx.correlator import window_power_blocks
    log(f"{label}, M = {', '.join(map(str, widths))} (T = "
        f"{' and '.join(map(str, Ts))}, both parities, riq and planar, "
        f"chained = one), Nh={Nh}")
    errs = {k: {} for k in ("analysis", "rx_front", "rx_phases", "synth")}
    n1 = Nh // 2 + 1
    for M in widths:
        P = M // 2
        e1 = e2 = e3 = e4 = 0.0
        for T in Ts:
            xu = unit_channel_band(M, T, Nh, M + T, dev)
            xf = fsk_band(M, T, Nh, M + T, dev)
            skip = 2 * T + 2         # hops of the bank's ramp-up
            prev = torch.randn((M, 2), device=dev,
                               generator=torch.Generator(dev).manual_seed(M))
            for parity in (0, 1):
                for planar in (False, True):
                    xi = xu.t().contiguous() if planar else xu
                    y = KA.analyze_block(xi, M, T, parity, planar, planar)
                    ry = KA.analyze_reference(xi, M, T, parity, planar,
                                              planar)
                    e1 = max(e1, (y - ry).abs().max().item())
                    xi = xf.t().contiguous() if planar else xf
                    d, last, pw = R.analyze_demod(xi, M, T, parity, prev)
                    rd, rlast, rpw = R.analyze_demod_reference(
                        xi, M, T, parity, prev)
                    if witness is not None:
                        fy = torch.view_as_real(analysis_f64(xu, M, T,
                                                             parity))
                        fd = demod_f64(analysis_f64(xf, M, T, parity), prev)
                        riq = (lambda a: a.permute(1, 2, 0)) if planar \
                            else (lambda a: a)
                        for k, got in (
                                ("analysis", [(riq(a).double() - fy).abs()
                                              .max().item() for a in (y, ry)]),
                                ("rx_front", [demod_err(
                                    a[:, skip:].double(), fd[:, skip:])[0]
                                    for a in (d, rd)])):
                            was = witness[k].get(M, (0.0, 0.0))
                            witness[k][M] = tuple(map(max, got, was))
                    e2 = max(e2, demod_err(d[:, skip:], rd[:, skip:])[0]
                             if seam else
                             (d - rd)[:, skip:].abs().max().item())
                    blk, rblk = (window_power_blocks([p[:, skip:]])
                                 for p in (pw, rpw))
                    assert ((blk - rblk).abs() / rblk).max().item() \
                        <= SERIES_RTOL, (M, T, parity, planar)
                    assert ((last - rlast).abs().max()
                            / rlast.pow(2).mean().sqrt()).item() <= LAST_RTOL
                    for dt, tol in ((torch.float32, PHASE_ATOL),
                                    (torch.bfloat16, BF16_ATOL)):
                        ph, cp, pb = K.analyze_phases(xi, M, T, 3, parity, dt)
                        rph, rcp, rpb = K.analyze_phases_reference(
                            xi, M, T, 3, parity)
                        js = -(-skip // 3)
                        err = (ph.float() - rph)[..., js:].abs()
                        e = err.max().item()
                        assert e <= tol or (
                            seam and e <= ATAN_SEAM / 3 + tol
                            and (err > tol).double().mean().item()
                            <= 3 * BRANCH_CUT_FRACTION), \
                            (M, T, parity, planar, dt, e)
                        if dt == torch.float32:
                            e3 = max(e3, e)
                        # past the first block (the ramp-up), or the one
                        # block of a short run
                        rel = ((pb - rpb).abs() / rpb)[
                            :, 1 if rpb.shape[1] > 1 else 0:].max().item()
                        assert rel <= POWER_RTOL, (M, T, rel)
            sync(dev)
            assert e1 <= ANALYSIS_ATOL and e2 <= PHASE_ATOL, (M, T, e1, e2)
            # chained = one: K1 and K2 bit for bit
            y = KA.analyze_block(xu, M, T, 0)
            ya = KA.analyze_block(xu[: (n1 + 2 * T - 1) * P].contiguous(), M,
                                  T, 0)
            yb = KA.analyze_block(xu[n1 * P:].contiguous(), M, T, n1 % 2)
            assert torch.equal(torch.cat([ya, yb], 1), y), (M, T)
            zero = torch.zeros_like(prev)
            d, last, pw = R.analyze_demod(xf, M, T, 0, zero)
            da, la, pa = R.analyze_demod(
                xf[: (n1 + 2 * T - 1) * P].contiguous(), M, T, 0, zero)
            db, lb, pb = R.analyze_demod(xf[n1 * P:].contiguous(), M, T,
                                         n1 % 2, la)
            assert torch.equal(torch.cat([da, db], 1), d) \
                and torch.equal(torch.cat([pa, pb], 1), pw) \
                and torch.equal(lb, last), (M, T)
            e4 = max(e4, compare_synth(
                S, M, T, Nh, dev, M + T,
                bounds["synth"] if bounds else SYNTH_RTOL,
                None if witness is None else witness["synth"]))
        for name, e in zip(errs, (e1, e2, e3, e4)):
            errs[name][M] = e
        assert bounds is None or (e1 <= bounds["analysis"]
                                  and e2 <= bounds["rx_front"]), (M, e1, e2)
        log(f"  M={M}: max|err| analysis {e1:.3e}, rx_front demod {e2:.3e}, "
            f"rx_phases {e3:.3e}, synth {e4:.3e}; K1 and K2 chained calls "
            f"equal one bit for bit")
    ms = {k: {} for k in errs}
    T, Nt = 8, 8192
    for M in widths if times else ():
        x = fsk_band(M, T, Nt, M, dev)
        prev = torch.zeros((M, 2), device=dev)
        Y = torch.randn((Nt, M, 2), device=dev,
                        generator=torch.Generator(dev).manual_seed(M))
        carry = torch.zeros((M * T - M // 2, 2), device=dev)
        t = timed({
            "analysis": lambda: KA.analyze_block(x, M, T, 0),
            "analysis_plain": lambda: KA.analyze_reference(x, M, T, 0),
            "rx_front": lambda: R.analyze_demod(x, M, T, 0, prev),
            "rx_front_plain": lambda: R.analyze_demod_reference(x, M, T, 0,
                                                                prev),
            "rx_phases": lambda: K.analyze_phases(x, M, T, 3, 0,
                                                  torch.bfloat16),
            "rx_phases_plain": lambda: K.analyze_phases_reference(
                x, M, T, 3, 0, torch.bfloat16),
            "synth": lambda: S.synthesize_block(Y, M, T, 0, carry),
            "synth_plain": lambda: S.synthesize_block_reference(Y, M, T, 0,
                                                                carry),
        }, 10, KERNEL_REPS)
        for k in ms:
            ms[k][M] = (t[k], t[k + "_plain"])
        log(f"  M={M}, Nh={Nt}, kernel / plain ms: " + ", ".join(
            f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in
            ((k, ms[k][M]) for k in ms)))
    # odd widths and M = 0: refused
    for M in (13, 16389, 32769, 0):
        try:
            KA.analyze_block(torch.zeros(((100 + 15) * (M // 2), 2),
                                         device=dev), M, 8)
        except ValueError:
            continue
        raise AssertionError(f"M={M} was not refused")
    return errs, ms


def loop_pairs(M, frames, seed=None):
    """Word pairs (M, frames, 2, 28) of a closed-loop run: the first
    ``frames`` frames of the steady-state FOCC superframe on every
    channel (tests/test_runtime.py's loopback: a forward control channel
    must not trigger the reverse channel's detector), or with a seed the
    random words of bench.py's closed-loop cell."""
    from amps_tpu_torch.tx.focc import superframe_word_pairs
    if seed is None:
        return np.broadcast_to(superframe_word_pairs()[:frames],
                               (M, frames, 2, 28)).copy()
    return np.random.default_rng(seed).integers(
        0, 2, (M, frames, 2, 28)).astype(np.uint8)


def phase_loop_checks(dev, M, T, nblocks=4, frames=2, witness=False):
    """Phase 13: the fused closed loop.  Graph = eager bit for bit; the
    kernel path against the plain path; a planted reverse burst across
    the boundary of blocks 1 and 2.  Past M = 4096 the forward band,
    FOCC on every channel, has a peak
    ~120x its RMS, and two correct f32 transforms of it differ by ~1e-6
    of that peak, which at M=8192 is 1.09e-4 of its RMS, past
    SYNTH_RTOL; so its synthesis is held as phase 7 holds the
    transmitter's, within TX_PEAK_RTOL of its peak, and the decoder's
    planes are compared, as its demod is, past block 0's ramp-up: a
    candidate whose trigger window reaches into the first hops after
    the zero history (angles of values under that floor) is left out.
    With ``witness`` the plain path synthesizes in float64
    (``synth_f64_f32``), as phase 7 then does.  The plain path searches
    with the plain version too.  Returns ((K4, K2, K5) launches of the
    graph run, {kernel: max abs error against the plain path's
    state})."""
    from amps_tpu_torch.dsp.fm import fm_modulate_symbols
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.kernels import trigger_search as KS
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime import streamer as st
    from amps_tpu_torch.rx.correlator import TRIGGER_SYMBOLS
    from amps_tpu_torch.tx import recc_ms
    coherent_floor = M > 4096
    ref_synth = synth_f64_f32 if witness else S.synthesize_block_reference
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    n_hops, block_samples, carry_hops = st.closed_loop_geometry(prod, frames)
    log(f"phase 13: make_closed_loop_stream, M={M}, production spec, "
        f"nblocks={nblocks}, frames={frames}: {n_hops} hops and "
        f"{block_samples} samples a block, carried overlap {carry_hops} hops")
    wp = loop_pairs(M, frames)
    graphed, bs = st.make_closed_loop_stream(prod, nblocks, frames)
    eager, _ = st.make_closed_loop_stream(prod, nblocks, frames, graph=False)
    assert bs == block_samples == n_hops * M // 2
    graphed(wp)                   # the closure's first run: warm-up, capture
    sync(dev)
    # A replay launches the kernels without passing through their
    # wrappers; run adds each replay's launches, as counted at capture
    # (one block a replay), to the wrappers' LAUNCHES.  Phase 14 holds
    # that count to the kernel spans the profiler sees in a graph run.
    S.LAUNCHES = R.LAUNCHES = KS.LAUNCHES = 0
    got = graphed(wp)
    sync(dev)
    launches = (S.LAUNCHES, R.LAUNCHES, KS.LAUNCHES)
    S.LAUNCHES = R.LAUNCHES = KS.LAUNCHES = 0
    want = eager(wp)
    sync(dev)
    C = S.chunk_launches(T)                  # synth launches a block
    eager_launches = (S.LAUNCHES, R.LAUNCHES, KS.LAUNCHES)
    assert launches == eager_launches == (C * nblocks, nblocks, nblocks), \
        (launches, eager_launches)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), (got, want)
    nv, q, wok = int(got[0]), float(got[1]), int(got[2])
    log(f"  graph (one block a replay) = eager, bit for bit: n_valid {nv}, "
        f"quality_max {q:.4f}, n_word_ok {wok}; synth, rx_front and "
        f"trigger search launches {launches}, {C}, one and one a block in "
        f"both")
    assert nv == 0 and np.isfinite(q) and q < 0.55, (nv, q)
    f32 = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank")
    kern = st.make_closed_loop_stream(f32, nblocks, frames, graph=False)[0](wp)
    S.LAUNCHES = R.LAUNCHES = KS.LAUNCHES = 0
    plain = st.make_closed_loop_stream(
        f32, nblocks, frames, graph=False, synthesize=ref_synth,
        front_end=R.analyze_demod_reference, search=plain_search)[0](wp)
    sync(dev)
    assert (S.LAUNCHES, R.LAUNCHES, KS.LAUNCHES) == (0, 0, 0)
    dq = abs(float(kern[1]) - float(plain[1]))
    log(f"  f32 spec, kernel path vs plain path (eager"
        + (", float64 synthesis" if witness else "") + "): n_valid "
        f"{int(kern[0])} / {int(plain[0])}, quality_max {float(kern[1]):.5f} "
        f"/ {float(plain[1]):.5f} (|diff| {dq:.2e}), n_word_ok "
        f"{int(kern[2])} / {int(plain[2])} (every candidate slot counts: "
        f"the periodic FOCC band ties its argmax)")
    assert int(kern[0]) == int(plain[0]) == 0
    assert float(kern[1]) < 0.55 and float(plain[1]) < 0.55
    # past 4096 the streams' maxima include block 0's ramp-up, compared
    # block by block below without it
    assert coherent_floor or dq <= LOOP_QUALITY_ATOL

    # the same two paths block by block, slot by slot and sample by sample
    from amps_tpu_torch.dsp.fm import fsk_manchester_baseband
    from amps_tpu_torch.tx.focc import focc_frame_bits
    Y0 = fsk_manchester_baseband(
        focc_frame_bits(torch.as_tensor(wp, device=dev)), prod.chan_sps,
        prod.fm_sensitivity)[0].transpose(0, 1).contiguous()
    sk, sp = (st.closed_loop_state0(f32, frames, dev) for _ in range(2))
    skip = 2 * T + 2                   # hops of the banks' ramp-up, block 0
    loop_err = {"synth": 0.0, "rx_front": 0.0}
    agree = differ = wok_k = wok_p = on_seam = ramp = 0
    tie = 0.0
    for b in range(nblocks):
        sk, pk = st.closed_loop_block(Y0, sk, f32)
        sp, pp = st.closed_loop_block(
            Y0, sp, f32, synthesize=ref_synth,
            front_end=R.analyze_demod_reference, search=plain_search)
        # hist is the tail of the synthesized band, carry the whole of the
        # block's demod plane (carry_hops = n_hops): every sample of both
        rms = sp["hist"].pow(2).mean().sqrt().item()
        peak = sp["hist"].abs().max().item()
        tol = TX_PEAK_RTOL * peak if coherent_floor else SYNTH_RTOL * rms
        for key in ("hist", "syn_carry"):
            e = (sk[key] - sp[key]).abs().max().item()
            loop_err["synth"] = max(loop_err["synth"], e)
            assert e <= tol, (b, key, e, rms)
        lo = skip if b == 0 else 0
        e, n = demod_err(sk["carry"][:, lo:], sp["carry"][:, lo:])
        loop_err["rx_front"] = max(loop_err["rx_front"], e)
        on_seam += n
        e = ((sk["prev"] - sp["prev"]).abs().max()
             / sp["prev"].pow(2).mean().sqrt()).item()
        assert e <= LAST_RTOL, (b, e)
        assert not pk["valid"].any() and not pp["valid"].any()
        # the candidates compared: past 4096 those of block 0 whose
        # trigger window starts past the ramp-up on both paths
        cmp = torch.ones_like(pk["valid"])
        if coherent_floor and b == 0:
            first = carry_hops + skip + TRIGGER_SYMBOLS * prod.chan_sps
            cmp = (pk["starts"] >= first) & (pp["starts"] >= first)
            ramp += int((~cmp).sum())
        same = (pk["starts"] == pp["starts"]) & cmp
        agree += int(same.sum())
        differ += int((~same & cmp).sum())
        # where both paths pick the same start, the slot is the same slot
        assert torch.equal(pk["word_ok"][same], pp["word_ok"][same]), b
        assert torch.equal(pk["words"][same], pp["words"][same]), b
        qk, qp = pk["quality"].float(), pp["quality"].float()
        assert ((qk - qp).abs()[same] <= LOOP_QUALITY_ATOL).all(), b
        # where they differ it is an argmax tie: the best candidate of a
        # channel (slot 0) has the same quality on both paths
        dq0 = (qk - qp).abs()[:, 0][~same[:, 0] & cmp[:, 0]]
        if dq0.numel():
            tie = max(tie, dq0.max().item())
        wok_k += int(pk["word_ok"].sum())
        wok_p += int(pp["word_ok"].sum())
    assert carry_hops == n_hops and tie <= LOOP_QUALITY_ATOL, tie
    assert (wok_k, wok_p) == (int(kern[2]), int(plain[2]))
    log(f"  the two paths block by block: the synthesized band's tail and "
        f"carry max|err| {loop_err['synth']:.3e} "
        + (f"({loop_err['synth'] / peak:.2e} of the peak <= {TX_PEAK_RTOL}, "
           f"{loop_err['synth'] / rms:.2e} of RMS), every " if coherent_floor
           else f"({loop_err['synth'] / rms:.2e} of RMS <= {SYNTH_RTOL}), "
           f"every ")
        + f"demod sample max|err| {loop_err['rx_front']:.3e} <= {PHASE_ATOL} "
        f"({on_seam} on fast_atan2's octant seam); starts agree on {agree} "
        f"of {agree + differ} "
        f"slots, and there words, word_ok are identical and quality within "
        f"{LOOP_QUALITY_ATOL}; they differ on {differ}, and where a "
        f"channel's best candidate does, its quality on the two paths "
        f"differs by at most {tie:.2e}: a tie between repeats of the "
        f"periodic FOCC pattern, so n_word_ok sums other slots"
        + (f"; {ramp} candidates of block 0 whose trigger window reaches "
           f"into the ramp-up left out" if coherent_floor else ""))

    # a reverse burst on one channel from block 1 into block 2, driven
    # through the loop's block body with a channel plane per block
    chan, start = M // 2 + 1, n_hops + 100
    words = recc_ms.registration_words("2135551212", esn=0xBEEF)
    syms = recc_ms.burst_symbols(words, dcc=0, sps=prod.chan_sps)
    bb, _ = fm_modulate_symbols(torch.as_tensor(syms.astype(np.int8),
                                                device=dev),
                                prod.fm_sensitivity)
    row = torch.zeros((nblocks * n_hops, 2), device=dev)
    row[start: start + bb.shape[0]] = bb
    assert n_hops < start and start + bb.shape[0] > 2 * n_hops
    state = st.closed_loop_state0(prod, frames, dev)
    S.LAUNCHES = R.LAUNCHES = KS.LAUNCHES = 0
    found = []
    for b in range(nblocks):
        Y = Y0.clone()
        Y[:, chan] = row[b * n_hops: (b + 1) * n_hops]
        state, planes = st.closed_loop_block(Y, state, prod)
        v = planes["valid"].cpu().numpy()
        for c, k in np.argwhere(v):
            found.append((b, int(c), int(planes["starts"][c, k]),
                          planes["word_ok"][c, k].cpu().numpy(),
                          planes["words"][c, k].cpu().numpy()))
    assert (S.LAUNCHES, R.LAUNCHES, KS.LAUNCHES) == \
        (C * nblocks, nblocks, nblocks)
    # The window of block b is block b-1 (the carried overlap, 5556 hops
    # at frames=2) and block b.  The burst starts 100 hops into block 1 and
    # ends in block 2: block 1's window cuts its capture (the whole-capture
    # gate), block 2's holds it whole, block 3's no longer holds its start.
    # So it is counted exactly once.
    assert len(found) == 1, [(f[0], f[1], f[2]) for f in found]
    b, c, s0, wok, w = found[0]
    nw = len(words)
    assert (b, c) == (2, chan) and wok[:nw].all()
    assert np.array_equal(w[:nw], np.stack([np.asarray(x) for x in words]))
    # trigger = 26 of the burst's 30 dotting bits + the word sync; the
    # capture starts 41 bits after the burst's start, a bank delay later
    want_start = start - n_hops + 41 * 2 * 3 + 2 * T - 1
    assert abs(s0 - want_start) <= 1, (s0, want_start)
    log(f"  planted reverse burst on channel {chan}, hops {start}.."
        f"{start + bb.shape[0]} (blocks 1|2): found whole once, in block 2's "
        f"window at sample {s0} (expected {want_start}), {nw} words exact "
        f"with word_ok; n_valid 1")
    return launches, loop_err


def phase_loop_times(dev, M, T, card, nblocks=32, frames=2, n_runs=5,
                     plain=None, plain_blocks=None):
    """Phase 14: the closed loop's times.  Graph against eager and the
    kernel path against the plain path, interleaved in one process, CUDA
    events around whole runs; a profiler window of one graph run.  Each
    kernel alone beside its plain version: 10 turns of KERNEL_REPS calls,
    or with ``plain`` = (turns, calls) the plain versions apart in that
    many (as ``width_rows``).  ``plain_blocks``: the plain path's runs
    take that many blocks (a depth cut where its dense transforms take
    seconds a block), its ms a block from them.  Returns a dict of the
    readings."""
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.kernels import trigger_search as KS
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime import streamer as st
    from amps_tpu_torch.rx.correlator import window_power_blocks
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    n_hops, block_samples, _ = st.closed_loop_geometry(prod, frames)
    wp = loop_pairs(M, frames, seed=0)
    band_msps = M * CHANNEL_MSPS            # the band's own real time
    log(f"phase 14: closed loop times, M={M}, nblocks={nblocks}, "
        f"frames={frames} ({nblocks * block_samples / 1e6:.1f} Msamples, "
        f"{nblocks * block_samples / band_msps / 1e6:.2f} s of band a "
        f"run at {band_msps:.2f} Msamples/s), median of {n_runs} runs, "
        f"CUDA events, on {card}")
    runs = {
        "graph": st.make_closed_loop_stream(prod, nblocks, frames)[0],
        "eager": st.make_closed_loop_stream(prod, nblocks, frames,
                                            graph=False)[0],
        "plain": st.make_closed_loop_stream(
            prod, plain_blocks or nblocks, frames, graph=False,
            synthesize=S.synthesize_block_reference,
            front_end=R.analyze_demod_reference, search=plain_search)[0],
    }
    S.LAUNCHES = R.LAUNCHES = KS.LAUNCHES = 0
    res = runs["graph"](wp)
    sync(dev)
    warm = (S.LAUNCHES, R.LAUNCHES, KS.LAUNCHES)   # + the warm-up block
    S.LAUNCHES = R.LAUNCHES = KS.LAUNCHES = 0
    res = runs["graph"](wp)
    sync(dev)
    launches = (S.LAUNCHES, R.LAUNCHES, KS.LAUNCHES)
    C = S.chunk_launches(T)                  # synth launches a block
    assert launches == (C * nblocks, nblocks, nblocks) \
        and warm == (C * (nblocks + 1), nblocks + 1, nblocks + 1), \
        (launches, warm)
    log(f"  launches of one graph run (synth, rx_front, trigger search): "
        f"{launches}; with the warm-up block {warm}")
    assert np.isfinite(float(res[1])) and 0 <= int(res[0]) <= 2 * M * nblocks
    log(f"  random word pairs on every channel: n_valid {int(res[0])}, "
        f"quality_max {float(res[1]):.4f}, n_word_ok {int(res[2])}")
    t = timed({k: (lambda f=f: f(wp)) for k, f in runs.items()}, n_runs)
    out = {"launches": launches}
    for k, ms in t.items():
        per = ms / (plain_blocks or nblocks if k == "plain" else nblocks)
        msps = block_samples / per / 1e3
        out[k] = per
        log(f"  {k}: {ms:.2f} ms a run, {per:.3f} ms a block, {msps:.1f} "
            f"Msamples/s, {msps / band_msps:.1f}x real time")
    log(f"  graph vs eager {out['eager'] / out['graph']:.3f}x, kernel path "
        f"vs plain path (eager) {out['plain'] / out['eager']:.3f}x")
    # the launches run adds for its replays, held to the kernel spans the
    # profiler saw on the card in one graph run.  A window whose trace
    # holds fewer spans than launches is taken again, up to PROFILE_TRIES
    # windows, each shortfall logged: the profiler drops records (on the
    # H100 the M=16384 loop's window has lost about 40 of its 5608 device
    # ops, one span of each kernel among them, while every block ran);
    # more spans than launches fail at once.  On the device-memory route a
    # call is chunks of kernels: its epilogue's spans (one a chunk) are
    # counted, its load or fold and epilogue timed as the kernel's own, the
    # passes the two share apart
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import route
    if KA.route_length(M):
        kernels = (("synth", "route_synth_out", ("route_load_kernel",)),
                   ("rx_front", "route_front_out", ("route_fold_kernel",)))
        per_call = (route.chunks(M, n_hops, 0), route.chunks(M, n_hops, 1))
    else:
        kernels = (("synth", "synth_kernel", ()),
                   ("rx_front", "rx_front_kernel", ()))
        per_call = (1, 1)
    want = [n * c for n, c in zip(out["launches"], per_call)]
    for attempt in range(PROFILE_TRIES):
        busy, wall, ops = profile_window(
            f"one run of the closed loop under the graph ({nblocks} blocks)",
            lambda: runs["graph"](wp), dev, top=8)
        spans = [sum(c for k, (_, c) in ops.items() if pat in k)
                 for _, pat, _ in kernels]
        if all(n >= w for n, w in zip(spans, want)) or \
                attempt + 1 == PROFILE_TRIES:
            break
        log(f"  the trace holds {spans} spans of "
            f"{[p for _, p, _ in kernels]} against {want} (try "
            f"{attempt + 1} of {PROFILE_TRIES})")
    out["busy"], out["wall"] = busy / nblocks, wall / nblocks
    for (key, pat, more), n in zip(kernels, want):
        ms = sum(v for k, (v, _) in ops.items()
                 if any(p in k for p in (pat, *more))) / nblocks
        calls = sum(c for k, (_, c) in ops.items() if pat in k)
        out[key + "_dev"], out[key + "_spans"] = ms, calls
        log(f"  {pat} inside the graph: {calls} spans in the run, {ms:.3f} "
            f"ms a block ({ms / (busy / nblocks):.1%} of the device time)")
        assert calls == n, (pat, calls, n)
    if KA.route_length(M):
        ms = sum(v for k, (v, _) in ops.items()
                 if "route_pass_kernel" in k) / nblocks
        out["route_passes_dev"] = ms
        log(f"  the route's passes (K4's and K2's) inside the graph: {ms:.3f} "
            f"ms a block ({ms / (busy / nblocks):.1%} of the device time)")
    # the two kernels alone at the loop's shape, element by element against
    # their plain versions (the front end on an all-channel FSK band: no
    # branch cut, so every demod sample is held), then their times
    P = M // 2
    g = torch.Generator(dev).manual_seed(2)
    Y = torch.randn((n_hops, M, 2), device=dev, generator=g)
    carry = torch.randn((M * T - P, 2), device=dev, generator=g)
    x_ext = torch.randn(((n_hops + 2 * T - 1) * P, 2), device=dev,
                        generator=g)
    prev = torch.randn((M, 2), device=dev, generator=g)
    x, c = S.synthesize_block(Y, M, T, 0, carry)
    rx, rc = S.synthesize_block_reference(Y, M, T, 0, carry)
    rms = rx.pow(2).mean().sqrt().item()
    out["synth_err"] = max((x - rx).abs().max().item(),
                           (c - rc).abs().max().item())
    assert out["synth_err"] <= SYNTH_RTOL * rms, (out["synth_err"], rms)
    xf = fsk_band(M, T, n_hops, 14, dev)
    skip = 2 * T + 2                     # hops of the bank's ramp-up
    d, last, pw = R.analyze_demod(xf, M, T, 0, prev)
    rd, rlast, rpw = R.analyze_demod_reference(xf, M, T, 0, prev)
    out["rx_front_err"], on_seam = demod_err(d[:, skip:], rd[:, skip:])
    blk, rblk = (window_power_blocks([p[:, skip:]]) for p in (pw, rpw))
    blk_rel = ((blk - rblk).abs() / rblk).max().item()
    last_e = ((last - rlast).abs().max() / rlast.pow(2).mean().sqrt()).item()
    log(f"  alone at Nh={n_hops} against the plain versions: synth max|err| "
        f"{out['synth_err']:.3e} ({out['synth_err'] / rms:.2e} of RMS, <= "
        f"{SYNTH_RTOL}); rx_front demod max|err| {out['rx_front_err']:.3e} "
        f"<= {PHASE_ATOL} ({on_seam} of {d.numel()} samples on fast_atan2's "
        f"octant seam, within its step of {ATAN_SEAM}), 384-hop power "
        f"means rel {blk_rel:.2e} <= "
        f"{SERIES_RTOL}, last {last_e:.2e} of RMS <= {LAST_RTOL}")
    assert blk_rel <= SERIES_RTOL and last_e <= LAST_RTOL
    del x, c, rx, rc, xf, d, rd, pw, rpw
    fns = {
        "synth": lambda: S.synthesize_block(Y, M, T, 0, carry),
        "synth_plain": lambda: S.synthesize_block_reference(Y, M, T, 0,
                                                            carry),
        "rx_front": lambda: R.analyze_demod(x_ext, M, T, 0, prev),
        "rx_front_plain": lambda: R.analyze_demod_reference(
            x_ext, M, T, 0, prev),
    }
    if plain is None:
        k = timed(fns, 10, KERNEL_REPS)
    else:
        k = timed({n: f for n, f in fns.items() if "plain" not in n}, 10,
                  KERNEL_REPS)
        k.update(timed({n: f for n, f in fns.items() if "plain" in n},
                       *plain))
    out.update(k)
    out["synth_bound"], _ = bound(
        M, T, n_hops, 2 * nbytes(carry) + nbytes(Y) + n_hops * P * 8)
    out["rx_front_bound"], _ = bound(
        M, T, n_hops, nbytes(x_ext, prev, *kernel_tables(M, T, dev))
        + 2 * M * n_hops * 4 + nbytes(prev))
    log(f"  alone at Nh={n_hops}: synth {k['synth']:.3f} ms (plain "
        f"{k['synth_plain']:.3f}, bound {out['synth_bound']:.3f}); rx_front "
        f"{k['rx_front']:.3f} ms (plain {k['rx_front_plain']:.3f}, bound "
        f"{out['rx_front_bound']:.3f})")
    return out


def phase_batched(dev, T, card, M=128, G=8, n=1 << 22, n_timed=10):
    """Phase 15: the batched small-bank block, 128 channels x 8 bands, n
    samples a band, planted bursts in each band.  Each band's result
    equals the single-band block on that band; rx_phases as one launch
    with a band axis against one launch a band.  Returns the readings."""
    from amps_tpu_torch.eval.traffic import BurstEvent, synthesize_reverse_band
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.rx.correlator import RSSI_BLOCK
    P, sps = M // 2, 3
    Nh = n // P
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    log(f"phase 15: rx_multichannel_block_batched, {M} channels x {G} bands, "
        f"n = {n} samples a band (Nh={Nh}), production spec, 3 planted "
        f"bursts a band (σ 0.001)")
    rng = np.random.default_rng(128)
    events, bands = [], []
    for g in range(G):
        evs = [BurstEvent(int(c), int(h), rng.integers(
            0, 2, (int(rng.integers(2, 8)), 36)).astype(np.uint8))
            for c, h in zip(rng.permutation(M)[:3],
                            (300 + 1000 * g, 20000 + 500 * g, 50000 - 700 * g))]
        events.append(evs)
        bands.append(synthesize_reverse_band(evs, prod, Nh, noise_sigma=0.001,
                                             seed=g + 1, device=dev))
    xs = torch.stack(bands)
    del bands
    K.LAUNCHES = 0
    out = pl.rx_multichannel_block_batched(xs, prod, max_bursts=2)
    sync(dev)
    launches = K.LAUNCHES
    assert launches == 1, launches
    ints = ("starts", "words", "word_ok", "dcc_bits", "bad_symbols")
    worst, idle_diff = 0.0, 0
    for g in range(G):
        one = pl.rx_multichannel_block(xs[g], prod, max_bursts=2)
        v = one["valid"]
        assert torch.equal(out["valid"][g], v), g
        for k in one:
            if k in ints:
                assert torch.equal(out[k][g][v], one[k][v]), (g, k)
            elif k != "valid":
                a, b = out[k][g].float(), one[k].float()
                if k != "chan_power":
                    a, b = a[v], b[v]
                d = (a - b).abs().max().item()
                worst = max(worst, d)
                assert d <= BATCH_ATOL, (g, k, d)
        idle_diff += int((out["starts"][g] != one["starts"]).sum().item())
        valid = out["valid"][g].cpu().numpy()
        expect = np.zeros_like(valid)
        for ev in events[g]:
            c, nw = ev.channel, len(ev.words)
            expect[c, 0] = True
            assert valid[c, 0], (g, c)
            assert out["word_ok"][g, c, 0, :nw].all(), (g, c)
            assert np.array_equal(out["words"][g, c, 0, :nw].cpu().numpy(),
                                  ev.words), (g, c)
        assert np.array_equal(valid, expect), (g, np.argwhere(valid != expect))
    log(f"  every band equals rx_multichannel_block on that band: valid "
        f"identical; starts, words, word_ok, dcc_bits, bad_symbols identical "
        f"on every valid slot, quality and rssi there and chan_power within "
        f"{worst:.1e} <= {BATCH_ATOL} (cuBLAS picks its kernels by shape, so "
        f"a batched and a single product sum in other orders); starts "
        f"differ on {idle_diff} of {G * M * 2} noise-only slots; all "
        f"{3 * G} bursts valid, word_ok, bit-exact, no other valid slot; "
        f"rx_phases launches {launches} (one, with the band as a grid axis)")

    def band_by_band(x_ext, M_, T_, sps_, hop0_parity, out_dtype):
        outs = [K.analyze_phases(x_ext[g], M_, T_, sps_, hop0_parity,
                                 out_dtype) for g in range(x_ext.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))

    hist = torch.zeros((G, M * T - P, 2), device=dev)
    x_ext = torch.cat([hist, xs], dim=1).contiguous()
    a = K.analyze_phases(x_ext, M, T, sps, 0, torch.bfloat16)
    b = band_by_band(x_ext, M, T, sps, 0, torch.bfloat16)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    # The band axis against the plain version, on the same bursts in noise
    # of BAND_SIGMA (idle channels at σ 0.001 sit below the bursts' f32
    # roundoff, so two summation orders disagree on them by more than the
    # bounds): noise-only samples under the branch-cut rule, every phase
    # inside the planted bursts held.
    loud = torch.cat([hist, torch.stack([
        synthesize_reverse_band(events[g], prod, Nh, noise_sigma=BAND_SIGMA,
                                seed=g + 1, device=dev)
        for g in range(G)])], dim=1).contiguous()
    kph, kcp, kpw = K.analyze_phases(loud, M, T, sps, 0, torch.bfloat16)
    rph, rcp, rpw = K.analyze_phases_reference(loud, M, T, sps, 0)
    assert kph.shape == rph.shape == (G, M, sps, (Nh - sps + 1) // sps)
    err = (kph.float() - rph).abs()
    beyond = (err > BF16_ATOL).double().mean().item()
    burst_err = 0.0
    for g in range(G):
        for ev in events[g]:
            j0 = -(-(ev.start_hop + 1) // sps)
            j1 = min(ev.start_hop + BURST_HOPS, rph.shape[-1] * sps) // sps - 1
            burst_err = max(burst_err,
                            err[g, ev.channel, :, j0:j1].max().item())
    rel = max(((u - v).abs() / v.abs().clamp(min=1e-30)).max().item()
              for u, v in ((kcp, rcp), (kpw, rpw)))
    log(f"  rx_phases with the band axis ({G}, {M}, Nh={Nh}) vs its plain "
        f"version (noise σ {BAND_SIGMA}): bf16 phases max|err| inside the "
        f"{3 * G} bursts "
        f"{burst_err:.3e} <= {BF16_ATOL}, share of all phases > {BF16_ATOL} "
        f"{beyond:.2e} <= {BRANCH_CUT_FRACTION}; chan_power, pw_blk max rel "
        f"{rel:.2e} <= {POWER_RTOL}")
    assert burst_err <= BF16_ATOL and beyond <= BRANCH_CUT_FRACTION
    assert rel <= POWER_RTOL
    del err, rph, kph, loud
    t = timed({
        "one_launch": lambda: K.analyze_phases(x_ext, M, T, sps, 0,
                                               torch.bfloat16),
        "g_launches": lambda: [K.analyze_phases(x_ext[g], M, T, sps, 0,
                                                torch.bfloat16)
                               for g in range(G)],
        "plain": lambda: K.analyze_phases_reference(x_ext, M, T, sps, 0,
                                                    torch.bfloat16),
    }, n_timed, 2)
    nsym = (Nh - sps + 1) // sps
    t["bound"], t["bound_by"] = bound(
        M, T, G * Nh, nbytes(x_ext, *K._tables(M, T, dev))
        + G * (M * sps * nsym * 2 + M * -(-Nh // RSSI_BLOCK) * 4))
    blk = timed({
        "kernel": lambda: pl.rx_multichannel_block_batched(xs, prod, 2),
        "g_launches": lambda: pl._rx_block(xs, prod, 2, 0.55, "first_ok",
                                           band_by_band),
        "plain": lambda: pl._rx_block(xs, prod, 2, 0.55, "first_ok",
                                      K.analyze_phases_reference,
                                      plain_search),
    }, max(3, n_timed // 2))
    log(f"  on {card}: rx_phases, {G} bands: one launch "
        f"{t['one_launch']:.3f} ms, {G} launches {t['g_launches']:.3f} ms "
        f"(bit-identical), plain {t['plain']:.3f} ms, bound "
        f"{t['bound']:.3f} ms ({t['bound_by']})")
    for k, ms in blk.items():
        log(f"  whole batched block, {k}: {ms:.3f} ms, "
            f"{G * n / ms / 1e3:.1f} Msamples/s")
    t["block"] = blk
    t["launches"] = launches
    t["err"] = burst_err
    return t


def phase_single_channel(dev):
    """Phase 16: the single-channel chains on the card.  TX: FoccStream ->
    tx.modulator.fm_modulate -> rx.frontend.rx_frontend -> integrate and
    dump at 10 samples a symbol -> frame bits exact, the paged words in
    frame 4.  RX: a tx.recc_ms burst -> fm_modulate -> rx_frontend ->
    find_and_extract -> decode_bursts -> words exact."""
    from amps_tpu_torch.codec import words as W
    from amps_tpu_torch.config import PipelineConfig
    from amps_tpu_torch.rx import correlator, decoder
    from amps_tpu_torch.rx.frontend import rx_frontend, rx_lpf_taps
    from amps_tpu_torch.tx import recc_ms
    from amps_tpu_torch.tx.focc import (_FRAME_SRC, FRAME_BITS, STREAM_BOTH,
                                        FoccStream, focc_frame_bits)
    from amps_tpu_torch.tx.modulator import fm_modulate, tx_interp_taps
    pipe = PipelineConfig()
    log("phase 16: the single-channel chains on the card (sym_rate 100k, "
        "tx/rx 400k, demod at 200k)")
    bs, mirror = FoccStream(sps=pipe.sps), FoccStream(sps=pipe.sps)
    page = [W.focc_word1(True, 0, 0x5A5A5A).numpy(),
            W.focc_word2_general(0x2D3, 0, 0, 0).numpy()]
    for s in (bs, mirror):
        s.push_words(STREAM_BOTH, page)
    nfr = 6
    n_sym = nfr * FRAME_BITS * 2 * pipe.sps
    syms = bs.next_superframe_symbols()[:n_sym].to(dev)
    iq, _ = fm_modulate(syms.to(torch.int8), pipe)
    demod, _ = rx_frontend(iq, pipe, center_freq=0.0)
    assert iq.device == demod.device == dev and iq.shape == (4 * n_sym, 2)
    # group delay of the two filters at 400k, halved at 200k; 10 samples a
    # Manchester symbol at 200k
    delay = ((len(tx_interp_taps()) - 1) // 2
             + (len(rx_lpf_taps()) - 1) // 2) // 2
    nb = (demod.shape[0] - delay) // 20 - 1
    sym = demod[delay: delay + nb * 20].reshape(nb, 2, 10).mean(-1)
    bits = (sym[:, 0] - sym[:, 1] < 0).to(torch.uint8).cpu()
    want = focc_frame_bits(torch.as_tensor(mirror.next_word_pairs()[:nfr]))
    assert torch.equal(bits, want[:nb]), int((bits != want[:nb]).sum())
    msg = bits[4 * FRAME_BITS: 5 * FRAME_BITS].numpy()[_FRAME_SRC >= 0]
    assert np.array_equal(msg[21:49], page[0])
    log(f"  TX: {nb} frame bits of {nfr} frames read back exactly; the "
        f"page word is frame 4's word A")
    words = recc_ms.page_response_words("5551234567")
    burst = recc_ms.burst_symbols(words, 0, pipe.sps)
    idle = np.tile(np.array([1, -1], np.int8), 400)
    stream = np.concatenate([idle, burst, np.tile(idle, 5)]).astype(np.int8)
    iq, _ = fm_modulate(torch.as_tensor(stream, device=dev), pipe)
    iq = torch.cat([torch.zeros((7, 2), device=dev), iq])   # any timing phase
    demod, _ = rx_frontend(iq[: iq.shape[0] // 2 * 2], pipe, center_freq=0.0)
    sps = 10
    pad = torch.zeros(correlator.CAPTURE_SYMBOLS * sps, device=dev)
    starts, valid, q, hard, _ = correlator.find_and_extract(
        torch.cat([demod, pad]), sps, 1, 0.5)
    dec = decoder.decode_bursts(hard[0])
    nw = len(words)
    assert bool(valid[0]) and dec.word_ok[:nw].all()
    assert np.array_equal(dec.words[:nw].cpu().numpy(),
                          np.stack([np.asarray(w) for w in words]))
    log(f"  RX: burst found (quality {float(q[0]):.3f}, start "
        f"{int(starts[0])}), {nw} words exact with word_ok")


def phase_supervision(dev, M, T, push_hops=8192, n_push=6):
    """Phase 17: MultichannelReceiver with two supervision slots at full
    width.  One slot carries voice + SAT (SCC 1, amplitude 0.05), then a
    10 kHz signaling tone burst; the other is idle (σ 0.001 wideband
    noise).  Levels per 10 ms frame against the transmitted amplitudes
    (times the two banks' prototype response at the tone's offset); the
    kernel and the plain front end agree."""
    from amps_tpu_torch.config import PipelineConfig, SystemConfig
    from amps_tpu_torch.dsp import channelizer as chz
    from amps_tpu_torch.dsp.fm import fm_modulate
    from amps_tpu_torch.dsp.polyphase import prototype_taps
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime.streamer import MultichannelReceiver
    from amps_tpu_torch.tx.voice import voice_channel_baseband
    pipe, P = PipelineConfig(), M // 2
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    voice, idle, st_amp = 700 % M, 333 % M, 0.3
    total = push_hops * n_push
    n_voice = 4 * push_hops                   # then the signaling tone
    t = np.arange(n_voice * 16000 // 60000 + 16) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * 700.0 * t)).astype(np.float32)
    bb, ph = voice_channel_baseband(audio, SystemConfig(scc=1), pipe)
    ts = torch.arange(total - n_voice, device=dev) / pipe.chan_rate
    tone, _ = fm_modulate(st_amp * torch.cos(2 * np.pi * 10_000.0 * ts),
                          prod.fm_sensitivity, float(ph))
    Y = torch.zeros((total, M, 2), device=dev)
    Y[:n_voice, voice] = bb[:n_voice]
    Y[n_voice:, voice] = tone
    x, _ = chz.synthesize(Y, prod.chz_spec, chz.synthesizer_init(prod.chz_spec))
    del Y
    x = x + 0.001 * torch.randn(x.shape, device=dev,
                                generator=torch.Generator(dev).manual_seed(5))
    log(f"phase 17: supervision_slots=({voice}, {idle}) at M={M}: voice + "
        f"SAT (SCC 1, 0.05) for {n_voice} hops, then a 10 kHz tone "
        f"({st_amp}); {n_push} pushes of {push_hops} hops")

    def run(front_end):
        calls = []
        rx = MultichannelReceiver(
            prod, supervision_slots=(voice, idle), front_end=front_end,
            on_supervision=lambda s, lv, pw: calls.append((s, lv, pw)))
        for i in range(n_push):
            rx.push(x[i * push_hops * P: (i + 1) * push_hops * P])
        return calls

    R.LAUNCHES = 0
    got = run(R.analyze_demod)
    sync(dev)
    assert R.LAUNCHES == n_push
    plain = run(R.analyze_demod_reference)
    assert [c[0] for c in got] == [c[0] for c in plain] \
        == [voice, idle] * n_push
    lv = {s: np.concatenate([c[1] for c in got if c[0] == s])
          for s in (voice, idle)}
    lp = {s: np.concatenate([c[1] for c in plain if c[0] == s])
          for s in (voice, idle)}
    nf = total // 600
    assert lv[voice].shape == lv[idle].shape == (nf, 5)
    fv = n_voice // 600                  # whole voice frames
    sat = lv[voice][12: fv - 12]
    st = lv[voice][fv + 2:]
    # a tone at f rides sidebands f off the carrier through the synthesis
    # and the analysis prototype: its level comes out times |H(f)/H(0)|²
    h = prototype_taps(M, T).astype(np.float64)
    k = np.arange(len(h)) / (M * 30e3)
    gain = {f: (abs(np.sum(h * np.exp(-2j * np.pi * f * k))) / h.sum()) ** 2
            for f in (6000.0, 10000.0)}
    want_sat, want_st = 0.05 * gain[6000.0], st_amp * gain[10000.0]
    e_sat = abs(np.median(sat[:, 1]) - want_sat)
    e_st = abs(np.median(st[:, 3]) - want_st)
    d = np.abs(lv[voice] - lp[voice]).max()
    log(f"  voice slot, medians over its 10 ms frames: SAT1 "
        f"{np.median(sat[:, 1]):.4f} (sent 0.05, {want_sat:.4f} after the "
        f"two banks' prototype), SAT0 "
        f"{np.median(sat[:, 0]):.4f}, SAT2 {np.median(sat[:, 2]):.4f}, ST "
        f"during voice {np.median(sat[:, 3]):.4f}; tone: ST "
        f"{np.median(st[:, 3]):.4f} (sent {st_amp}, {want_st:.4f} after "
        f"the prototype); kernel vs plain front "
        f"end max |diff| {d:.2e}")
    assert e_sat <= 0.005 and np.median(sat[:, [0, 2]], axis=0).max() <= 0.02
    assert np.median(sat[:, 3]) <= 0.02 and e_st <= 0.01
    assert d <= 2e-3
    # the idle slot demodulates noise: its tone bins sit at its guard
    # bins' level (the noise reference), far below any real tone's
    # dominance over them
    gi = np.median(lv[idle][:, 4])
    ratio = np.median(lv[idle][:, 3]) / gi
    log(f"  idle slot: median ST {np.median(lv[idle][:, 3]):.3f}, guard "
        f"{gi:.3f} (ratio {ratio:.2f}; the tone on the voice slot stands "
        f"{np.median(st[:, 3] / st[:, 4]):.0f}x over its guard)")
    assert 0.3 <= ratio <= 3.0 and np.median(st[:, 3] / st[:, 4]) >= 10
    return R.LAUNCHES


STATION_ARGS = ["--superframes", "2", "--no-server",
                "--voice-slot-map", "355:4,356:5",
                "--simulate", "origination:5551234567:5551230000",
                "--simulate", "registration:7735550000:0x77"]
CROSSOVER_SNRS = [3.0, 1.5, 0.0]


def quiet(fn):
    """``fn`` with its standard output discarded (the app's per-block
    lines under repeated runs)."""
    import contextlib
    import io

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()
    return run


def phase_station_app(dev, M, card, times):
    """Phase 18: the station as operators run it, ``python -m
    amps_tpu_torch bs`` in-process through the dispatcher at M: the
    synthesis kernel on the TX thread, the front-end kernel on the RX
    thread (with the voice slots' supervision rows), the control plane on
    this thread.  Two simulated mobiles on slot 3.  Then the front-end
    kernel against its plain version at the app's RX shape.  Returns the
    kernels' launches in the run (synth, rx_front) and that comparison's
    max abs demod error in bursts."""
    from amps_tpu_torch.__main__ import main as cli
    from amps_tpu_torch.eval.traffic import (MobileEvent,
                                             synthesize_reverse_band)
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.tx import recc_ms
    argv = ["bs", "--channels", str(M), *STATION_ARGS]
    log(f"phase 18: the station app, python -m amps_tpu_torch "
        f"{' '.join(argv)}, on {card}")
    result = {}
    S.LAUNCHES = R.LAUNCHES = 0
    sync(dev)
    t0 = time.perf_counter()
    cli(argv, _result=result)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = (S.LAUNCHES, R.LAUNCHES)
    stats, st, reps = result["stats"], result["station"], result["reports"]
    def key(words):                         # words A and B
        return np.asarray(words[:2], np.uint8).tobytes()

    want = {key(w): name for name, w in (
        ("origination", recc_ms.origination_words("5551234567",
                                                  "5551230000")),
        ("registration", recc_ms.registration_words("7735550000",
                                                    esn=0x77)))}
    got = sorted(want.get(key(r.words), "other") for r in reps)
    assert got == sorted(want.values()), got
    assert all(r.channel == 3 and r.word_ok[:2].all() for r in reps)
    kinds = [(e.kind, str(e.payload)) for e in st.events]
    assert ("command", "page 5551230000") in kinds, kinds
    i_reg = next(i for i, (k, p) in enumerate(kinds)
                 if k == "debug" and "registration from MIN=7735550000" in p)
    assert any(k == "focc_words" for k, _ in kinds[i_reg:]), kinds
    n_sf = 18 * 463 * 2 * 3
    assert stats.tx_samples == 2 * n_sf * (M // 2), stats
    assert launches[0] >= 2 and launches[1] >= stats.rx_blocks, launches
    log(f"  2 bursts reported once each on slot 3, words A and B good; "
        f"'page 5551230000' dispatched, the registration answered on the "
        f"FOCC; launches synth {launches[0]}, rx_front {launches[1]} "
        f"({stats.rx_blocks} RX blocks)")
    # throughput over the synced wall of the whole call (the app's set-up
    # included); the executor's own wall ends in join(), after the app's
    # 50 ms poll of the threads
    log(f"  wall {wall * 1e3:.1f} ms in-process, synced: TX "
        f"{stats.tx_samples / wall / 1e6:.1f}, RX "
        f"{stats.rx_samples / wall / 1e6:.1f} Msamples/s over it; executor "
        f"threads {stats.wall_s * 1e3:.1f} ms (up to 50 ms of the app's "
        f"poll in it), on {card}")
    tx_ms = 1e3 * np.asarray(result["tx_block_s"])
    rx_ms = 1e3 * np.asarray(result["rx_block_s"])
    rx_n = stats.rx_samples // max(stats.rx_blocks, 1)
    log(f"  TX thread, next_block per superframe: {np.round(tx_ms, 3).tolist()} "
        f"ms (phase 9 alone, production spec: "
        f"{times['next_block']['kernel']:.3f} ms)")
    log(f"  RX thread, push per block of {rx_n} samples: "
        f"{np.round(rx_ms, 3).tolist()} ms, "
        f"{rx_n / np.median(rx_ms) / 1e3:.1f} Msamples/s (phase 9 alone, "
        f"push of {RX_PUSH} samples at depth 1: {times['push']['kernel']:.3f}"
        f" ms, {RX_PUSH / times['push']['kernel'] / 1e3:.1f} Msamples/s)")
    profile_window("the station app, one run (2 superframes, 2 RX blocks)",
                   quiet(lambda: cli(argv)), dev, all_threads=True)
    # the front-end kernel at the shape the app hands it: one RX block
    # (rx_n samples) after the bank's history, the app's spec, the
    # simulated mobiles on slot 3 (where the app puts them) and on slot 5
    # (a supervision row) beside phase 6's planted bursts
    spec = pl.MultichannelSpec(num_channels=M)
    T, P = spec.taps_per_phase, M // 2
    Nh = rx_n // P
    events = plant_events(M, 18) + [
        MobileEvent.parse(STATION_ARGS[-3], channel=3, start_hop=1000),
        MobileEvent.parse(STATION_ARGS[-1], channel=5, start_hop=4000)]
    band = synthesize_reverse_band(events, spec, Nh, noise_sigma=BAND_SIGMA,
                                   device=dev)
    x_ext = torch.cat([torch.zeros(((2 * T - 1) * P, 2), device=dev),
                       band]).contiguous()
    err = compare_rx_front(R, x_ext, M, T,
                           f"rx_front at the app's block, M={M} Nh={Nh}",
                           events, dev)
    return launches, err


def phase_ring(dev, M, card, total_hops=32768, n_events=24):
    """Phase 19: a reverse band of ``random_events`` from a writer thread
    (the radio process) through ``RingIQSink`` into a native ring half
    the band's size, drained by the executor into a receiver at M; each
    event reported once, the FOCC responses under the station's capacity
    rule.  Then a FileIQSink round trip of one CUDA-tensor superframe.
    Returns the front-end kernel's launches on the ring run."""
    import tempfile
    import threading
    from amps_tpu_torch.control.station import BaseStation
    from amps_tpu_torch.eval.traffic import (random_events,
                                             synthesize_reverse_band)
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime.executor import ThreadedExecutor
    from amps_tpu_torch.runtime.native_rt import Ring
    from amps_tpu_torch.runtime.sdr import (FileIQSink, FileIQSource,
                                            RingIQSink, RingIQSource,
                                            source_reader)
    from amps_tpu_torch.runtime.streamer import (MultichannelReceiver,
                                                 MultichannelTransmitter)
    spec = pl.MultichannelSpec(num_channels=M)
    events = random_events(n_events, spec, total_hops, seed=7)
    x = synthesize_reverse_band(events, spec, total_hops, noise_sigma=0.02,
                                device=dev)
    log(f"phase 19: {len(events)} random_events over {total_hops} hops at "
        f"M={M} ({x.shape[0]} samples, {nbytes(x) / 2**20:.0f} MiB) through "
        f"a 64 MiB native ring into the executor, on {card}")
    st = BaseStation(sps=spec.chan_sps)
    rx = MultichannelReceiver(
        spec, on_burst=lambda r: st.handle_burst(r.words, r.word_ok),
        threshold=0.6, max_bursts=6, min_rssi=0.05)
    ring = Ring(1 << 26)
    src = RingIQSource(ring, timeout_s=5.0)
    errors = []

    def radio():
        try:
            RingIQSink(ring).write(x)
        except BaseException as e:
            errors.append(e)
        finally:
            src.mark_eof()

    R.LAUNCHES = 0
    t0 = time.perf_counter()
    writer = threading.Thread(target=radio)
    writer.start()
    stats = ThreadedExecutor(rx_source=source_reader(src, 1 << 22),
                             rx_push=rx.push).start().join(timeout=300)
    writer.join(60)
    rx.flush()
    sync(dev)
    wall = time.perf_counter() - t0
    launches = R.LAUNCHES
    assert not errors and not writer.is_alive(), errors
    assert stats.rx_samples == x.shape[0], (stats.rx_samples, x.shape)
    reps = rx.reports
    assert len(reps) == len(events), (len(reps), len(events))
    assert all(r.word_ok[:2].all() for r in reps)

    def event_of(r):                        # its channel, words A and B
        ab = np.asarray(r.words[:2], np.uint8)
        hits = [e for e in events if e.channel == r.channel and
                np.array_equal(np.stack(e.words()[:2]).astype(np.uint8), ab)]
        assert len(hits) == 1, (r.channel, len(hits))
        return hits[0]

    delivered = [event_of(r) for r in reps]
    assert len({id(e) for e in delivered}) == len(events)
    # the capacity rule of tests/test_traffic.py, in the order the
    # station heard the bursts (a block delivers its reports by channel):
    # a registration is answered (+1), a served page response +1, a
    # served origination +2 (assignment + loopback page), an intercept
    # origination +2 with no channel, one over capacity +0
    free, expect = set(st._vc_plan), 0
    for ev in delivered:
        if ev.kind == "registration":
            expect += 1
        elif ev.kind == "page_response":
            if free:
                free.pop()
                expect += 1
        elif ev.dialed[:1] == "0":
            expect += 2
        elif free:
            free.pop()
            expect += 2
    focc = sum(e.kind == "focc_words" for e in st.events)
    assert focc == expect, (focc, expect)
    log(f"  {len(reps)} reports, one per event on its channel with its "
        f"words A and B; {focc} FOCC responses as the capacity rule says; "
        f"{stats.rx_blocks} blocks in {wall * 1e3:.1f} ms "
        f"({stats.rx_samples / wall / 1e6:.1f} Msamples/s through the ring "
        f"and the receiver), rx_front launches {launches}")
    del x
    tx = MultichannelTransmitter(spec)
    blk = tx.next_block()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/superframe.f32"
        sink = FileIQSink(path)
        t0 = time.perf_counter()
        sink.write(blk)
        sink.close()
        t_write = time.perf_counter() - t0
        back = FileIQSource(path).read(blk.shape[0] + 1)
    assert np.array_equal(back, blk.cpu().numpy())
    log(f"  FileIQSink of one CUDA-tensor superframe ({blk.shape[0]} "
        f"samples, {nbytes(blk) / 1e6:.0f} MB): read back equal; write "
        f"{t_write * 1e3:.1f} ms")
    return launches


def phase_entry_points(dev, card):
    """Phase 20: the link-quality curve on the card at 128 trials a point
    inside the pinned crossover bounds, the capture monitor's self-test
    and the loopback demo, through the dispatcher."""
    import contextlib
    import io
    import tempfile
    from amps_tpu_torch.__main__ import main as cli
    from amps_tpu_torch.eval.ber import recc_link_curve
    log(f"phase 20: recc_link_curve at {CROSSOVER_SNRS} dB, 128 trials, "
        f"seed 1; the monitor; the demo; on {card}")
    sync(dev)
    t0 = time.perf_counter()
    first = recc_link_curve(CROSSOVER_SNRS, trials=128, seed=1)
    maj = recc_link_curve(CROSSOVER_SNRS, trials=128, seed=1,
                          policy="majority")
    t_curve = time.perf_counter() - t0
    for name, c in (("first_ok", first), ("majority", maj)):
        log(f"  {name}: " + ", ".join(
            f"{s:+.1f} dB detect {c[s]['detect_rate']:.3f} words "
            f"{c[s]['word_success_rate']:.3f}" for s in CROSSOVER_SNRS))
    d = [first[s]["detect_rate"] for s in CROSSOVER_SNRS]
    assert d[0] >= 0.85 and 0.45 <= d[1] <= 0.85 and d[2] <= 0.30, d
    assert all(d[i] - d[i + 1] < 0.65 for i in range(2)) and \
        d[0] > d[1] > d[2], d
    gain_mid = maj[1.5]["word_success_rate"] - first[1.5]["word_success_rate"]
    gain_floor = (maj[0.0]["word_success_rate"]
                  - first[0.0]["word_success_rate"])
    assert gain_mid >= 0.05 and gain_floor <= gain_mid, (gain_mid,
                                                         gain_floor)
    assert maj[1.5].get("majority_vote_fraction", 0.0) >= 0.5
    log(f"  inside the pinned crossover bounds; both curves "
        f"{t_curve * 1e3:.1f} ms")
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli(["monitor", "--synthesize", "page_response:5551234567",
                      f"{tmp}/cap.f32"])
    assert rc == 0 and "1 burst(s) decoded" in out.getvalue(), out.getvalue()
    log("  monitor --synthesize page_response:5551234567: 1 burst decoded, "
        "MIN 5551234567")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(["demo"])
    assert rc == 0, out.getvalue()
    log("  demo: origination dispatched, assignment and repeated page "
        "delivered")


MESH_ROW_HOPS = 12482      # 2x2 rows: each worker analyzes 6241 hops (odd)
MESH_FRAMES = 2            # 5556 TX hops: each worker synthesizes 1389 (odd)
MESH_STEP_BLOCKS = 3       # the step's blocks (phases 21, 27)
MESH_LOOP_BLOCKS = 8       # the loop's blocks (phases 22, 27)


def mesh_spec(M, T):
    """The sharded phases' spec: f32 planes, so that starts are exact."""
    from amps_tpu_torch.parallel import pipeline as pl
    return pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank")


def mesh_candidates(out, row0, row, hal):
    """(abs row, channel, slot, abs sample, quality, words, word_ok,
    dcc_bits) of each valid slot of a sharded step's output whose Word A
    decoded (the receivers' gate), in (row, channel, slot) order; the
    output's rows are the mesh rows from ``row0`` on."""
    o = {k: out[k].cpu().numpy() for k in
         ("valid", "starts", "quality", "words", "word_ok", "dcc_bits")}
    return [(int(row0 + r), int(c), int(k),
             int((row0 + r) * row - hal + o["starts"][r, c, k]),
             float(o["quality"][r, c, k]), o["words"][r, c, k],
             o["word_ok"][r, c, k], o["dcc_bits"][r, c, k])
            for r, c, k in sorted(zip(*np.nonzero(o["valid"]
                                                  & o["word_ok"][..., 0])))]


def mesh_dedup(cands, sps, found):
    """Add each candidate to ``found`` {(channel, abs): (quality, words,
    word_ok, dcc_bits)}, but not a re-find within half a capture of a
    burst already there (the receivers' dedup)."""
    from amps_tpu_torch.rx.correlator import CAPTURE_SYMBOLS
    for _, c, _, a, q, words, ok, dcc in cands:
        if any(ch == c and abs(a - pos) < CAPTURE_SYMBOLS * sps // 2
               for ch, pos in found):
            continue
        found[(c, a)] = (q, words, ok, dcc)


def mesh_reports(found, sps):
    """The sorted (channel, abs_symbol, words, word_ok) of ``found``, as
    the receivers' reports are compared."""
    return sorted((c, a // sps, v[1].tobytes(), v[2].tobytes())
                  for (c, a), v in found.items())


def mesh_step_traffic(M, spec, nblocks, dev):
    """Phase 21's reverse-band events and blocks: bursts mid-row, across
    the row boundary, across the block 1|2 boundary and in block 3."""
    from amps_tpu_torch.eval.traffic import (MobileEvent,
                                             synthesize_reverse_band)
    row, P = MESH_ROW_HOPS, M // 2
    block = 2 * row
    events = [MobileEvent("origination", 1, 700, "5551234567", "7025551000",
                          esn=777),
              MobileEvent("registration", M // 2, row - 5000, "9165554321",
                          esn=42),
              MobileEvent("page_response", M - 1, block - 4000,
                          "4155559876"),
              MobileEvent("registration", 5, 2 * block + 3000, "2125550000",
                          esn=5)]
    x = synthesize_reverse_band(events, spec, nblocks * block,
                                noise_sigma=1e-3, device=dev)
    return events, x, [x[b * block * P:(b + 1) * block * P]
                       for b in range(nblocks)]


def mesh_loop_traffic(M, spec, nblocks, dev):
    """Phase 22's reverse-band events and (nblocks, N_rx, 2) blocks."""
    from amps_tpu_torch.eval.traffic import (MobileEvent,
                                             synthesize_reverse_band)
    block = 2 * MESH_ROW_HOPS
    events = [MobileEvent("page_response", 2, 5000, "4155559876"),
              MobileEvent("registration", M // 3, 3 * block + 9000,
                          "9165554321", esn=9),
              MobileEvent("origination", M - 4, 5 * block - 5000,
                          "5551234567", "7025551000", esn=77)]
    x = synthesize_reverse_band(events, spec, nblocks * block,
                                noise_sigma=1e-3, device=dev)
    return events, x.reshape(nblocks, block * (M // 2), 2)


def phase_mesh_step(dev, M, T, card, nblocks=MESH_STEP_BLOCKS):
    """Phase 21: the sharded full-duplex step on a 2x2 mesh whose four
    workers share the card, at M, with rows of MESH_ROW_HOPS and
    MESH_FRAMES of FOCC a block: three blocks of reverse-band traffic with
    bursts mid-row, across the row boundary, across the block 1|2
    boundary and in block 3, the state restored from an .npz between
    blocks 1 and 2.  Every burst decodes bit-exactly once, and the
    reports are the single-device MultichannelReceiver's on the same
    stream.  The analysis (K1) and synthesis (K4) kernels launch once a
    worker a block, and each is held to its plain version at the
    workers' shapes.  Then the step's times and a profiler window of one
    step.  Returns a dict of the readings."""
    import os
    import tempfile
    from amps_tpu_torch.eval.traffic import unit_channel_band
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from amps_tpu_torch.runtime.streamer import MultichannelReceiver
    spec = mesh_spec(M, T)
    sps, P, row = spec.chan_sps, M // 2, MESH_ROW_HOPS
    block, hal = 2 * row, pl.full_demod_halo(spec)
    mesh = make_mesh(MeshSpec(2, 2), [dev])
    n_sub_rx, n_sub_tx = block // 4, MESH_FRAMES * 463 * 2 * sps // 4
    log(f"phase 21: the sharded full-duplex step, 2x2 mesh of workers "
        f"sharing {mesh.device} (one card: no multi-card scaling), M={M}, "
        f"{nblocks} blocks of {block} RX hops (rows of {row}, {n_sub_rx} "
        f"hops a worker's analysis) and {MESH_FRAMES} FOCC frames "
        f"({n_sub_tx} hops a worker's synthesis), on {card}")
    events, x, blocks = mesh_step_traffic(M, spec, nblocks, dev)
    wp = torch.as_tensor(loop_pairs(M, MESH_FRAMES), device=dev)
    step = pl.make_sharded_bs_stream_step(mesh, spec, hal, max_bursts=2,
                                          rx_external=True)
    st = pl.sharded_stream_state(spec, hal, dev)
    found = {}
    sync(dev)
    KA.LAUNCHES = S.LAUNCHES = 0
    for b in range(nblocks):
        if b == 1:
            # the state through the host and an .npz: the block-boundary
            # burst's head is in this carry
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "mesh_state.npz")
                np.savez(path, **{k: (v.cpu().numpy() if torch.is_tensor(v)
                                      else np.int32(v))
                                  for k, v in st.items()})
                with np.load(path) as z:
                    st = pl.sharded_state_from_arrays(z, dev)
        out, st = step(wp, st, blocks[b])
        assert torch.isfinite(out["tx_wideband"]).all()
        mesh_dedup(mesh_candidates(out, 2 * b, row, hal), sps, found)
    sync(dev)
    launches = (KA.LAUNCHES, S.LAUNCHES)
    assert launches == (4 * nblocks, 4 * nblocks * S.chunk_launches(T)), \
        launches
    assert len(found) == len(events), sorted(found)
    for ev in events:
        hits = [(a, v) for (c, a), v in found.items() if c == ev.channel]
        assert len(hits) == 1, (ev.channel, hits)
        want = np.stack(ev.words())
        _, words, ok, dcc = hits[0][1]
        assert ok[: len(want)].all() and np.array_equal(words[: len(want)],
                                                        want), ev.channel
        assert not dcc.any(), ev.channel
    for ev, boundary in ((events[1], row), (events[2], block)):
        a = next(a for (c, a) in found if c == ev.channel)
        assert a < boundary < a + 3374 * sps, (ev.channel, a, boundary)
    log(f"  {len(events)} bursts decoded bit-exact once each (across the row "
        f"boundary and the restored block boundary included); launches "
        f"analysis {launches[0]}, synth {launches[1]} ({nblocks} blocks x 4 "
        f"workers, synth x {S.chunk_launches(T)} chunk launches)")
    mr = MultichannelReceiver(spec, max_bursts=2, policy="first_ok",
                              device=dev)
    reps = []
    for i in range(2 * nblocks):
        reps += mr.push(x[i * row * P:(i + 1) * row * P])
    reps += mr.flush()
    mine = mesh_reports(found, sps)
    theirs = sorted((r.channel, r.abs_symbol, r.words.tobytes(),
                     r.word_ok.tobytes()) for r in reps)
    assert mine == theirs, ([m[:2] for m in mine], [t[:2] for t in theirs])
    log(f"  = the single-device MultichannelReceiver's {len(reps)} reports "
        f"(channel, abs_symbol, words, word_ok) on the same stream in "
        f"row-sized pushes")
    # the kernels alone at the workers' shapes, against their plain versions
    res = {"launches": launches, "reports": mine}
    xa = unit_channel_band(M, T, n_sub_rx, 21, dev)
    err = 0.0
    for parity in (0, 1):
        y = KA.analyze_block(xa, M, T, parity, planar=True)
        ry = KA.analyze_reference(xa, M, T, parity, planar=True)
        sync(dev)
        err = max(err, (y - ry).abs().max().item())
    assert err <= ANALYSIS_ATOL, err
    g = torch.Generator(dev).manual_seed(21)
    Y = torch.randn((n_sub_tx, M, 2), device=dev, generator=g)
    zero = torch.zeros((M * T - P, 2), device=dev)
    serr, srel = 0.0, 0.0
    for parity in (0, 1):
        xs, cs = S.synthesize_block(Y, M, T, parity, zero)
        rxs, rcs = S.synthesize_block_reference(Y, M, T, parity, zero)
        sync(dev)
        rms = rxs.pow(2).mean().sqrt().item()
        e = max((xs - rxs).abs().max().item(), (cs - rcs).abs().max().item())
        serr, srel = max(serr, e), max(srel, e / rms)
    assert srel <= SYNTH_RTOL, srel
    res["analysis_err"], res["synth_err"] = err, serr
    t = timed({
        "analysis": lambda: KA.analyze_block(xa, M, T, 1, planar=True),
        "analysis_plain": lambda: KA.analyze_reference(xa, M, T, 1,
                                                       planar=True),
        "synth": lambda: S.synthesize_block(Y, M, T, 1, zero),
        "synth_plain": lambda: S.synthesize_block_reference(Y, M, T, 1,
                                                            zero),
    }, 10, KERNEL_REPS)
    res.update(t)
    res["analysis_bound"], _ = bound(
        M, T, n_sub_rx, nbytes(xa, *KA._tables(M, T, dev)) + M * n_sub_rx * 8)
    res["synth_bound"], _ = bound(M, T, n_sub_tx, 2 * nbytes(zero)
                                  + nbytes(Y) + n_sub_tx * P * 8)
    log(f"  at the workers' shapes: analysis Nh={n_sub_rx} planar, max|err| "
        f"{err:.3e} <= {ANALYSIS_ATOL} over both parities, {t['analysis']:.3f}"
        f" ms (plain {t['analysis_plain']:.3f}, bound "
        f"{res['analysis_bound']:.3f}); synth Nh={n_sub_tx} from a zero "
        f"carry, max|err| {serr:.3e} ({srel:.2e} of RMS <= {SYNTH_RTOL}), "
        f"{t['synth']:.3f} ms (plain {t['synth_plain']:.3f}, bound "
        f"{res['synth_bound']:.3f})")
    st0 = pl.sharded_stream_state(spec, hal, dev)
    ms = timed({"step": lambda: step(wp, st0, blocks[1])}, 10)["step"]
    rx_n, tx_n = block * P, MESH_FRAMES * 2778 * P
    res["step_ms"] = ms
    log(f"  one step: {ms:.3f} ms a block (median of 10, CUDA events): RX "
        f"{rx_n / ms / 1e3:.1f} Msamples/s ({rx_n} samples), TX "
        f"{tx_n / ms / 1e3:.1f} Msamples/s ({tx_n} samples), on {card}")
    busy, wall, _ = profile_window("one sharded full-duplex step (2x2, "
                                   "workers sharing the card)",
                                   lambda: step(wp, st0, blocks[1]), dev,
                                   top=8)
    res["step_idle"] = 1 - busy / wall
    return res


def phase_mesh_loop(dev, M, T, card, nblocks=MESH_LOOP_BLOCKS, n_runs=3):
    """Phase 22: ``make_sharded_closed_loop_stream`` on the 2x2 mesh,
    ``nblocks`` blocks of MESH_FRAMES frames with external traffic (rows
    of MESH_ROW_HOPS; bursts in several blocks, one across a block
    boundary): its per-block counts equal the manual steps', the bursts
    decode; then its ms a block beside the single-device closed loop
    (phase 14's function, same spec and frames) in this process."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from amps_tpu_torch.runtime import streamer as st
    spec = mesh_spec(M, T)
    P, block = M // 2, 2 * MESH_ROW_HOPS
    mesh = make_mesh(MeshSpec(2, 2), [dev])
    log(f"phase 22: the sharded closed loop, 2x2 mesh on {mesh.device}, M={M},"
        f" {nblocks} blocks of {MESH_FRAMES} frames TX and {block} hops RX "
        f"traffic, on {card}")
    events, x_rx = mesh_loop_traffic(M, spec, nblocks, dev)
    wp = torch.as_tensor(loop_pairs(M, MESH_FRAMES), device=dev)
    run, block_samples = pl.make_sharded_closed_loop_stream(
        mesh, spec, nblocks, frames=MESH_FRAMES, max_bursts=2,
        rx_external=True)
    sync(dev)
    KA.LAUNCHES = S.LAUNCHES = 0
    n_valid, q_max, n_ok = (v.cpu().numpy() for v in run(wp, x_rx))
    launches = (KA.LAUNCHES, S.LAUNCHES)
    assert launches == (4 * nblocks, 4 * nblocks), launches
    step = pl.make_sharded_bs_stream_step(mesh, spec, max_bursts=2,
                                          rx_external=True)
    s = pl.sharded_stream_state(spec, pl.full_demod_halo(spec), dev)
    for b in range(nblocks):
        out, s = step(wp, s, x_rx[b])
        assert int(out["valid"].sum()) == n_valid[b]
        assert int(out["word_ok"].sum()) == n_ok[b]
        assert float(out["quality"].max()) == q_max[b]
    words = sum(len(ev.words()) for ev in events)
    assert int(n_valid.sum()) >= len(events) and int(n_ok.sum()) >= words
    log(f"  n_valid {n_valid.tolist()}, n_word_ok {n_ok.tolist()} (>= "
        f"{len(events)} bursts, {words} words), each block equal to the "
        f"manual step; launches analysis {launches[0]}, synth {launches[1]}")
    single = st.make_closed_loop_stream(spec, nblocks, MESH_FRAMES)[0]
    eager = st.make_closed_loop_stream(spec, nblocks, MESH_FRAMES,
                                       graph=False)[0]
    wp_np = loop_pairs(M, MESH_FRAMES)
    t = timed({"sharded": lambda: run(wp, x_rx),
               "single_graph": lambda: single(wp_np),
               "single_eager": lambda: eager(wp_np)}, n_runs)
    out = {k: v / nblocks for k, v in t.items()}
    out["launches"] = launches
    out["sums"] = (n_valid, q_max, n_ok)
    log(f"  ms a block (median of {n_runs} runs, CUDA events): sharded "
        f"{out['sharded']:.3f} ({block * P / out['sharded'] / 1e3:.1f} "
        f"Msamples/s RX + {block_samples / out['sharded'] / 1e3:.1f} TX); "
        f"single-device loop (TX -> RX loopback of the same {MESH_FRAMES} "
        f"frames) graph {out['single_graph']:.3f}, eager "
        f"{out['single_eager']:.3f}; on {card}")
    return out


def phase_mesh_app(dev, M, card, max_blocks=30):
    """Phase 23: ``python -m amps_tpu_torch bs --mesh 2x2`` at M through
    the dispatcher, a scripted mobile on the reverse band, the operator's
    page through the command server's socket: page -> response ->
    assignment -> alert -> answer -> conversation -> the mobile's ST
    release, within ``max_blocks`` blocks.  Each block launches K1 and K4
    once a worker and K1 once more for the mobile's ear.  Returns the
    launches (analysis, synth)."""
    import socket
    import threading
    from amps_tpu_torch.__main__ import main as cli
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import synth as S
    argv = ["bs", "--mesh", "2x2", "--channels", str(M), "--port", "0",
            "--simulate", "mobile:5551234567", "--voice-slot-map",
            "355:4,356:5", "--sup-timers", "3.0:0.8", "--blocks",
            str(max_blocks)]
    log(f"phase 23: python -m amps_tpu_torch {' '.join(argv)}, the page "
        f"through the socket, on {card}")
    result = {}
    sync(dev)
    KA.LAUNCHES = S.LAUNCHES = 0
    th = threading.Thread(target=quiet(lambda: cli(argv, _result=result)))
    th.start()
    # the app binds a free port and reports it once its server is up
    deadline = time.time() + 120
    while "port" not in result and time.time() < deadline and th.is_alive():
        time.sleep(0.1)
    assert "port" in result, "command server never came up"
    sock = socket.create_connection(("127.0.0.1", result["port"]), timeout=5)
    sock.sendall(b"page 5551234567\n")
    sock.close()
    th.join(timeout=600)
    assert not th.is_alive(), "the mesh station did not finish"
    sync(dev)
    launches = (KA.LAUNCHES, S.LAUNCHES)
    mob, station, n = result["mob"], result["station"], len(result["block_s"])
    assert mob.log[:4] == ["paged", "assigned 355", "ringing", "answered"], \
        mob.log
    assert "hang_up" in mob.log and not station.supervisors, mob.log
    rel = [e.payload for e in station.events
           if e.kind == "supervision_event" and e.payload.kind == "release"]
    assert len(rel) == 1 and "ST" in rel[0].reason, rel
    assert launches == (5 * n, 4 * n), (launches, n)
    ms = 1e3 * np.asarray(result["block_s"])
    tx_n, rx_n = 50004 * (M // 2), result["rx_samples"]
    log(f"  mobile log {mob.log}; timeline {result['timeline']}; {n} blocks;"
        f" launches analysis {launches[0]} (4 workers + the ear a block), "
        f"synth {launches[1]}")
    log(f"  per block (host, synced, the mobile's ear and the reverse-band "
        f"synthesis included): median {np.median(ms):.1f} ms, min "
        f"{ms.min():.1f}, max {ms.max():.1f}; TX {tx_n / np.median(ms) / 1e3:.1f}"
        f" and RX {rx_n / np.median(ms) / 1e3:.1f} Msamples/s at the median, "
        f"on {card}")
    return launches


def phase_mesh_dryrun(card, M, T):
    """Phase 24: ``dryrun_multichip(4)`` (2x2, M=32) and ``weak_scaling``
    at 1, 2 and 4 workers at M, the workers sharing the one card."""
    from amps_tpu_torch.dryrun import dryrun_multichip
    from amps_tpu_torch.eval.scaling import weak_scaling
    log(f"phase 24: dryrun_multichip(4) and weak_scaling at 1, 2, 4 workers "
        f"(all sharing one card: this measures that each size runs, not "
        f"multi-card scaling), on {card}")
    s = dryrun_multichip(4)
    assert s["bursts"] == 4 and len(s["devices"]) == 1, s
    res = weak_scaling((1, 2, 4), spec=mesh_spec(M, T), frames_per_device=2,
                       iters=3)
    for size, r in res.items():
        assert r["devices"] == 1
        log(f"  {size} worker(s) on {r['devices']} card, M={M}: "
            f"{r['samples_per_sec'] / 1e6:.1f} Msamples/s, "
            f"{r['per_worker'] / 1e6:.1f} a worker, efficiency "
            f"{r['efficiency']:.3f}")
    return res


SOAK_SHARDED_1024 = 1024    # the sharded soak also runs at the full bank
PACING_SECONDS = {"rx": 20.0, "fdx": 10.0, "fdx1": 10.0}


def launched(counts: dict, path: str) -> None:
    """A path that ran none of its kernels was not the ported path."""
    assert any(counts.values()), (path, counts)


def phase_soaks(dev, card, sizes=None):
    """Phase 25: every certification soak of ``eval/soak.py`` at its JAX
    artifact's size (the sharded soak also at M=1024), each family's
    verdict held to its bar; the clean soak's reports with the kernel
    front end against those with the plain front end.  ``sizes``: keyword
    overrides a family (a smaller rehearsal)."""
    from amps_tpu_torch.eval import soak
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_front as KR
    from amps_tpu_torch.kernels.rx_front import analyze_demod_reference
    from amps_tpu_torch.parallel.pipeline import MultichannelSpec
    sizes = sizes or {}
    log(f"phase 25: the certification soaks at full size on {card}")

    def emit(**kw):
        if kw["event"] in ("done", "verdict", "checkpoint_restore"):
            log(json.dumps(kw, default=soak._jsonable))

    runs = [(name, name, {}) for name in soak.FAMILIES]
    runs.insert(6, ("sharded_1024", "sharded", {"spec": MultichannelSpec(
        num_channels=SOAK_SHARDED_1024, taps_per_phase=8)}))
    out, launches, clean_reports = {}, {}, []
    for label, family, kw in runs:
        kw = dict(kw, **sizes.get(label, {}))
        if family == "clean":
            kw["reports"] = clean_reports
        sync(dev)
        KR.LAUNCHES = KA.LAUNCHES = 0
        v = getattr(soak, family)(dev, emit=emit, **kw)
        sync(dev)
        launches[label] = {"rx_front": KR.LAUNCHES, "analysis": KA.LAUNCHES}
        launched(launches[label], f"soak {label}")
        out[label] = v
        log(f"  {label}: ok {v['ok']}, {v['wall_s']:.3f} s streaming, "
            f"{v['streaming_msps']:.1f} Msamples/s; launches "
            f"{launches[label]}")
        assert v["ok"], (label, v)
    plain = []
    soak.clean(dev, front_end=analyze_demod_reference, reports=plain,
               emit=emit, **sizes.get("clean", {}))
    assert [report_key(r) for r in plain] == \
        [report_key(r) for r in clean_reports]
    log(f"  clean soak: {len(plain)} reports with the plain front end, "
        f"identical to the kernel's")
    log(json.dumps({"soaks": {k: {f: v[f] for f in (
        "ok", "n_events", "found", "exact", "dcc_ok", "exactly_once",
        "duplicates", "ghosts", "misdecodes", "recoveries", "snapshot_ms",
        "wall_s", "samples", "streaming_msps", "realtime_factor",
        "host_us_per_call_block", "timeline") if f in v}
        for k, v in out.items()}, "card": card}, default=soak._jsonable))
    return launches


def phase_pacing(dev, card, seconds=None, **kw):
    """Phase 26: the paced legs of ``eval/pacing.py``, shortened: rx 20
    s (zero deadline misses, every burst exactly once a period), then
    full duplex 10 s threaded and 10 s in one thread (every block
    received; misses recorded, not held)."""
    from amps_tpu_torch.eval import pacing
    from amps_tpu_torch.kernels import rx_front as KR
    from amps_tpu_torch.kernels import synth as KS
    seconds = seconds or PACING_SECONDS
    log(f"phase 26: the paced legs at {pacing.CHANNEL_RATE * 1024 / 1e6} "
        f"Msamples/s, rx {seconds['rx']} s, fdx and fdx1 {seconds['fdx']} s "
        f"each, on {card}")
    launches, res = {}, {}
    for leg in ("rx", "fdx", "fdx1"):
        sync(dev)
        KR.LAUNCHES = KS.LAUNCHES = 0
        r = pacing.LEGS[leg](seconds[leg], dev, **kw)
        sync(dev)
        launches[leg] = {"rx_front": KR.LAUNCHES, "synth": KS.LAUNCHES}
        launched(launches[leg], f"pacing {leg}")
        res[leg] = r
        log(json.dumps(dict(r, card=card, launches=launches[leg])))
        if leg == "rx":
            assert r["deadline_misses"] == 0, r
            assert r["exactly_once_per_period"], r
        else:
            launched({"synth": launches[leg]["synth"]}, f"pacing {leg} TX")
            assert r["tx_blocks"] == r["rx_blocks"] == r["blocks"], r
    return launches, res


XPROC_TIMEOUT_S = 420      # each child process of phase 27


def xproc_worker(pid, address, device="cuda:0", M=1024, T=8, n_timed=10,
                 n_runs=3) -> int:
    """Process ``pid`` of phase 27's two-process job: join the job at
    ``address`` (host:port; port 0 for process 0, which binds one) over
    ``initialize`` (the backend it picks), take one time row of the
    global {time: 2, chan: 2} mesh (two workers on ``device``), run
    phase 21's step traffic and phase 22's loop, then both timed in step
    with the other process and a profiler window, and leave through
    ``shutdown``; print one ``XPROC`` JSON line of what the parent
    checks."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.parallel import distributed as D
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime.streamer import MultichannelTransmitter
    dev = torch.device(device)
    D.initialize(address, 2, pid)
    mesh = D.global_mesh(devices=[dev, dev])
    assert mesh.shape == {"time": 2, "chan": 2} and mesh.rows == 1
    spec = mesh_spec(M, T)
    sps, P, row = spec.chan_sps, M // 2, MESH_ROW_HOPS
    hal = pl.full_demod_halo(spec)
    res = {"pid": pid, "backend": D.backend(), "device": str(dev)}
    log(f"process {pid} of 2: backend {res['backend']}, time row {mesh.row0}"
        f" of the {mesh.shape} mesh, workers on {mesh.devices}")
    _, _, blocks = mesh_step_traffic(M, spec, MESH_STEP_BLOCKS, dev)
    wp = torch.as_tensor(loop_pairs(M, MESH_FRAMES), device=dev)
    step = pl.make_sharded_bs_stream_step(mesh, spec, hal, max_bursts=2,
                                          rx_external=True)
    st = pl.sharded_stream_state(spec, hal, dev)
    cands = []
    sync(dev)
    KA.LAUNCHES = S.LAUNCHES = 0
    for b in range(MESH_STEP_BLOCKS):
        out, st = step(wp, st, blocks[b])
        assert torch.isfinite(out["tx_wideband"]).all()
        if b == 0:
            tx0 = out["tx_wideband"]
        cands += mesh_candidates(out, 2 * b + mesh.row0, row, hal)
    sync(dev)
    res["step_launches"] = (KA.LAUNCHES, S.LAUNCHES)
    res["candidates"] = [(r, c, k, a, q, w.tolist(), ok.tolist(),
                          dcc.tolist())
                         for r, c, k, a, q, w, ok, dcc in cands]
    # this process's share of the first block's TX against the
    # single-device transmitter's first MESH_FRAMES frames
    single = MultichannelTransmitter(spec, device=dev).next_block()
    share = tx0.shape[0]
    want = single[pid * share:(pid + 1) * share]
    err = (tx0 - want).abs().max().item()
    res["tx_rel_err"] = err / want.pow(2).mean().sqrt().item()
    res["tx_peak_rel_err"] = err / want.abs().max().item()
    _, x_rx = mesh_loop_traffic(M, spec, MESH_LOOP_BLOCKS, dev)
    run, _ = pl.make_sharded_closed_loop_stream(
        mesh, spec, MESH_LOOP_BLOCKS, frames=MESH_FRAMES, max_bursts=2,
        rx_external=True)
    sync(dev)
    KA.LAUNCHES = S.LAUNCHES = 0
    sums = run(wp, x_rx)
    sync(dev)
    res["loop_launches"] = (KA.LAUNCHES, S.LAUNCHES)
    res["loop_sums"] = [v.cpu().tolist() for v in sums]
    # both processes make the same calls in the same order: every step
    # exchanges with the other process
    st0 = pl.sharded_stream_state(spec, hal, dev)
    res["step_ms"] = timed({"step": lambda: step(wp, st0, blocks[1])},
                           n_timed)["step"]
    res["loop_ms"] = timed({"loop": lambda: run(wp, x_rx)},
                           n_runs)["loop"] / MESH_LOOP_BLOCKS
    res["block_samples"] = (2 * row * P, MESH_FRAMES * 2778 * P)
    busy, wall, _ = profile_window(
        f"one cross-process step, process {pid}",
        lambda: step(wp, st0, blocks[1]), dev, top=8)
    res["busy_ms"], res["wall_ms"] = busy, wall
    res["idle"] = 1 - busy / wall
    D.shutdown()
    print("XPROC " + json.dumps(res), flush=True)
    return 0


def phase_xproc(card, step_reports, loop_sums, device="cuda:0", M=1024,
                T=8, timeout=XPROC_TIMEOUT_S):
    """Phase 27: the cross-process station on one card.  Two processes
    (this script in ``--xproc-worker`` mode, started by
    ``distributed.launch``, each with a timeout of its own) join through
    ``distributed.initialize`` into the global
    {time: 2, chan: 2} mesh, a time row and two workers each, all four
    on ``device``.  Their step's union of reports equals phase 21's
    (``step_reports``), every planted burst decoded bit-exact with DCC
    0 exactly once (across the process and the block boundary included);
    each process's TX share equals the single-device transmitter's; the
    loop's per-block sums equal phase 22's (``loop_sums``).  Returns the
    analysis and synth launches of both processes together, in the step
    and in the loop."""
    import os
    from amps_tpu_torch.parallel import distributed as D
    log(f"phase 27: the cross-process station, 2 processes x 2 workers on "
        f"{device}, M={M}: the step ({MESH_STEP_BLOCKS} blocks) and the "
        f"loop ({MESH_LOOP_BLOCKS} blocks) of phases 21-22, on {card}")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    cmd = [sys.executable, os.path.abspath(__file__), "--xproc-worker"]
    done = D.launch(lambda pid, address: cmd + [str(pid), address, device,
                                                str(M)], timeout=timeout)
    res = []
    for pid, (code, out) in enumerate(done):
        for line in out.splitlines():
            if not line.startswith("XPROC "):
                log(f"  [process {pid}] {line}")
        if code != 0:
            raise RuntimeError(f"phase 27: process {pid} exited {code}")
        res.append(json.loads(next(line[6:] for line in out.splitlines()
                                   if line.startswith("XPROC "))))
    spec = mesh_spec(M, T)
    sps = spec.chan_sps
    for r in res:
        # both processes hold one card (or the CPU): never NCCL
        assert r["backend"] == "gloo", r["backend"]
        for k, n in (("step_launches", MESH_STEP_BLOCKS),
                     ("loop_launches", MESH_LOOP_BLOCKS)):
            assert tuple(r[k]) == (2 * n, 2 * n), (k, r[k])
        assert r["tx_rel_err"] <= SYNTH_RTOL, r["tx_rel_err"]
    cands = sorted(
        (row, c, k, a, q, np.asarray(w, np.uint8), np.asarray(ok, bool),
         np.asarray(dcc, np.uint8))
        for r in res for row, c, k, a, q, w, ok, dcc in r["candidates"])
    found = {}
    mesh_dedup(cands, sps, found)
    assert mesh_reports(found, sps) == step_reports, (
        sorted(found), [m[:2] for m in step_reports])
    for (c, a), (_, _, ok, dcc) in found.items():
        assert ok[0] and not dcc.any(), (c, a)
    row, block = MESH_ROW_HOPS, 2 * MESH_ROW_HOPS
    spans = {b: [c for (c, a) in found if a < b < a + 3374 * sps]
             for b in (row, block)}
    assert spans[row] and spans[block], spans
    n_valid = np.sum([r["loop_sums"][0] for r in res], axis=0)
    q_max = np.max([r["loop_sums"][1] for r in res], axis=0)
    n_ok = np.sum([r["loop_sums"][2] for r in res], axis=0)
    assert np.array_equal(n_valid, loop_sums[0]), (n_valid, loop_sums[0])
    assert np.array_equal(q_max, loop_sums[1]), (q_max, loop_sums[1])
    assert np.array_equal(n_ok, loop_sums[2]), (n_ok, loop_sums[2])
    rx_n, tx_n = res[0]["block_samples"]
    log(f"  backend {res[0]['backend']} in both processes (two processes "
        f"on one card); {len(found)} bursts decoded bit-exact with DCC 0, "
        f"once each, the union of both processes' reports = phase 21's "
        f"single-process reports (bursts across the process boundary on "
        f"channels {spans[row]} and across the block boundary on "
        f"{spans[block]}); the loop's per-block n_valid "
        f"{n_valid.tolist()}, n_word_ok {n_ok.tolist()} and quality max = "
        f"phase 22's")
    for r in res:
        log(f"  process {r['pid']}: TX share max|err| {r['tx_rel_err']:.2e} "
            f"of RMS ({r['tx_peak_rel_err']:.2e} of peak) <= {SYNTH_RTOL}; "
            f"launches step analysis/synth {r['step_launches']}, loop "
            f"{r['loop_launches']}; step {r['step_ms']:.3f} ms a block (RX "
            f"{rx_n / r['step_ms'] / 1e3:.1f} Msamples/s of the whole band), "
            f"loop {r['loop_ms']:.3f} ms a block; profiler window: busy "
            f"{r['busy_ms']:.3f} ms of {r['wall_ms']:.3f}, idle share "
            f"{r['idle']:.1%}; on {card}")
    log(json.dumps({"xproc": [{k: r[k] for k in (
        "pid", "backend", "step_ms", "loop_ms", "busy_ms", "wall_ms", "idle",
        "tx_rel_err", "step_launches", "loop_launches")} for r in res],
        "card": card}))
    return {k: tuple(int(sum(r[k][i] for r in res)) for i in (0, 1))
            for k in ("step_launches", "loop_launches")}


def phase_entry(dev, card):
    """Phase 28: ``dryrun.entry()``, the counterpart of
    ``__graft_entry__.entry``, on the card: its input lands on the current
    CUDA device, its forward (``rx_multichannel_block`` at M=16) launches
    the rx_phases kernel once, and it agrees with the plain path on the
    same input: valid identical, quality within LOOP_QUALITY_ATOL and
    words, word_ok and bad symbols identical on every slot whose start
    agrees, chan_power within POWER_RTOL."""
    from amps_tpu_torch.dryrun import entry
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.parallel import pipeline as pl
    fn, (x,) = entry()
    assert x.device == dev and tuple(x.shape) == (8192, 2), x.device
    log(f"phase 28: entry() on {x.device}: rx_multichannel_block, M=16, "
        f"T=8, {x.shape[0]} samples of N(0, 0.1) IQ, on {card}")
    sync(dev)
    K.LAUNCHES = 0
    got = fn(x)
    sync(dev)
    launches = K.LAUNCHES
    assert launches == 1, launches
    spec = pl.MultichannelSpec(num_channels=16, taps_per_phase=8)
    ref = pl._rx_block(x, spec, 2, 0.55, "first_ok",
                       K.analyze_phases_reference,
                       plain_search)
    g = {k: v.cpu().numpy() for k, v in got.items()}
    r = {k: v.cpu().numpy() for k, v in ref.items()}
    assert g["words"].shape == (16, 2, 7, 36)
    assert np.array_equal(g["valid"], r["valid"])
    same = g["starts"] == r["starts"]
    for key in ("words", "word_ok", "bad_symbols", "dcc_bits"):
        assert np.array_equal(g[key][same], r[key][same]), key
    q_err = np.abs(np.where(np.isfinite(g["quality"]), g["quality"], 0)
                   - np.where(np.isfinite(r["quality"]), r["quality"], 0))
    assert np.array_equal(np.isfinite(g["quality"]),
                          np.isfinite(r["quality"]))
    assert q_err[same].max() <= LOOP_QUALITY_ATOL, q_err[same].max()
    p_rel = np.abs(g["chan_power"] / r["chan_power"] - 1).max()
    assert p_rel <= POWER_RTOL, p_rel
    t = timed({"kernel": lambda: fn(x),
               "plain": lambda: pl._rx_block(x, spec, 2, 0.55, "first_ok",
                                             K.analyze_phases_reference,
                                             plain_search)},
              10)
    log(f"  rx_phases launches {launches}; kernel path vs plain path: valid "
        f"identical ({int(g['valid'].sum())} valid on noise), starts equal "
        f"on {int(same.sum())} of {same.size} slots, words / word_ok / bad "
        f"symbols / DCC identical there, quality max|err| "
        f"{q_err[same].max():.2e} <= {LOOP_QUALITY_ATOL}, chan_power max "
        f"rel {p_rel:.2e}; {t['kernel']:.3f} ms (plain {t['plain']:.3f}), "
        f"median of 10, CUDA events, on {card}")
    return launches, t


# phase 29: widths that are not powers of two.  WIDTH_CHECKS holds each
# kernel to its plain version (radices 3, 5 and 7, the station's 768, a
# seven-pass plan, the generic prime pass); WIDTH_TIMES times them beside
# M=1024; STATION_M is a 23.04 Msps station, whose main path runs end to
# end
WIDTH_CHECKS = (24, 160, 448, 768, 1458, 2038)
WIDTH_TIMES = (768, 1024, 1536, 2038)
STATION_M = 768
# phase 30: banks past 2048 channels, whose twiddles the passes read from
# device memory and whose K4 splits its columns into groups.  WIDE_CHECKS
# holds each kernel to its plain version (radix 3 at 2304 = 2^8·3² and
# 3072 = 3·1024, radix 5 past 3840 at 4000 = 2^5·5³, the generic pass
# past 2048 at 4094 = 2·23·89, the power of two 4096); WIDE_TIMES times
# them beside M=1024; WIDE_M is a 122.88 Msps station (the master clock
# of a USRP N310/N320), whose main path runs end to end
WIDE_CHECKS = (2304, 3072, 4000, 4094, 4096)
WIDE_TIMES = (1024, 2048, 3072, 4096)
WIDE_M = 4096
# the station app's short call at WIDE_M and WIDEST_M: one superframe,
# one mobile
WIDE_APP_ARGS = ["--superframes", "1", "--no-server",
                 "--simulate", "origination:5551234567:5551230000"]
# phase 31: banks past 4096 channels, whose hops a cluster of two thread
# blocks shares over distributed shared memory.  WIDEST_CHECKS holds
# each kernel to its plain version (an odd half width with the generic
# pass at 4098 = 2·3·683, 4100 = 4·5²·41, radix 3 at 6144 = 2·3072,
# 8190 = 2·3²·5·7·13, the power of two 8192); WIDEST_TIMES times them
# beside M=1024 and 4096; WIDEST_M is a 245.76 Msps station (a USRP
# X410's native rate), whose main path runs end to end
WIDEST_CHECKS = (4098, 4100, 6144, 8190, 8192)
WIDEST_TIMES = (1024, 4096, 6144, 8192)
WIDEST_M = 8192


def width_libraries():
    """The widths of phases 12 and 29-34 that build a library of their
    own."""
    from amps_tpu_torch.kernels import analysis as KA
    return sorted(set(SMALL_WIDTHS + WIDTH_CHECKS + WIDTH_TIMES + WIDE_CHECKS
                      + WIDE_TIMES + WIDEST_CHECKS + WIDEST_TIMES
                      + WIDER_CHECKS + WIDER_TIMES + BLUESTEIN_CHECKS)
                  - set(KA.LIBRARY_WIDTHS))


def width_rows(dev, M, T, Nh, sps=3, plain=None):
    """Each kernel alone at width M, Nh hops, T taps, on one FSK band
    (K1-K3) and random channel basebands (K4), timed with its plain
    version (median of 10 turns of KERNEL_REPS calls, CUDA events, in
    turns with the kernels; or, with ``plain`` = (turns, calls), the
    kernels so and then the plain versions apart in that many turns of
    that many calls, where a dense plain version takes a large share of
    a second; ``plain`` False: the kernels alone, plain None), with its
    bound and the cuFFT time of the (Nh, M) transform.  Returns {kernel: {"kernel", "plain", "bound",
    "bound_by"}, "fft": ms}."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import synth as S
    P = M // 2
    x = fsk_band(M, T, Nh, M, dev)
    prev = torch.zeros((M, 2), device=dev)
    Y = torch.randn((Nh, M, 2), device=dev,
                    generator=torch.Generator(dev).manual_seed(M))
    carry = torch.zeros((M * T - P, 2), device=dev)
    bf = torch.bfloat16
    fns = {
        "analysis": lambda: KA.analyze_block(x, M, T, 0),
        "analysis_plain": lambda: KA.analyze_reference(x, M, T, 0),
        "rx_front": lambda: R.analyze_demod(x, M, T, 0, prev),
        "rx_front_plain": lambda: R.analyze_demod_reference(x, M, T, 0,
                                                            prev),
        "rx_phases": lambda: K.analyze_phases(x, M, T, sps, 0, bf),
        "rx_phases_plain": lambda: K.analyze_phases_reference(x, M, T, sps,
                                                              0, bf),
        "synth": lambda: S.synthesize_block(Y, M, T, 0, carry),
        "synth_plain": lambda: S.synthesize_block_reference(Y, M, T, 0,
                                                            carry),
    }
    if plain is None:
        t = timed(fns, 10, KERNEL_REPS)
    else:
        t = timed({k: f for k, f in fns.items() if "plain" not in k}, 10,
                  KERNEL_REPS)
        if plain:
            t.update(timed({k: f for k, f in fns.items() if "plain" in k},
                           *plain))
    tables = nbytes(*kernel_tables(M, T, dev))
    nsym = (Nh - sps + 1) // sps
    moved = {"analysis": nbytes(x) + tables + M * Nh * 8,
             "rx_front": nbytes(x, prev) + tables + 2 * M * Nh * 4 + M * 8,
             "rx_phases": nbytes(x) + tables + M * sps * nsym * 2
             + M * -(-Nh // 384) * 4,
             "synth": nbytes(Y) + 2 * nbytes(carry) + Nh * P * 8 + tables}
    rows = {"fft": fft_ms(M, Nh, dev)}
    for k, b in moved.items():
        rows[k] = {"kernel": t[k], "plain": t.get(k + "_plain")}
        rows[k]["bound"], rows[k]["bound_by"] = bound(M, T, Nh, b)
    return rows


def kernel_tables(M, T, dev):
    """The tables a kernel at width M reads: the FFT tile's (``_tables``),
    or on the device-memory route the fold coefficients and the route's
    (W_L, the tile tables, and in the Bluestein mode the chirp and B̂)."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import route
    if KA.route_length(M):
        return [KA.fold_coef(M, T, dev)] + [
            t for t in route.tables(M, dev)[1:] if t is not None]
    return list(KA._tables(M, T, dev))


def width_times(dev, card, widths, T, base=1024, plain=None):
    """width_rows at each of ``widths`` (Nh=8192), each kernel's time also
    as a multiple of its time at ``base`` once that has run."""
    rows = {}
    for M in widths:
        r = rows[M] = width_rows(dev, M, T, 8192, plain=plain)
        log(f"  M={M}, Nh=8192, kernel / plain / bound ms (x the M={base} "
            f"kernel), cuFFT {r['fft']:.3f} ms, on {card}: " + "; ".join(
                f"{k} {v['kernel']:.3f} / {v['plain']:.3f} / "
                f"{v['bound']:.3f}"
                + (f" ({v['kernel'] / rows[base][k]['kernel']:.2f}x)"
                   if base in rows else "")
                for k, v in r.items() if k != "fft"))
    return rows


def station_paths(dev, card, M, T=8, sps=3, loop_runs=3, witness=False,
                  loop_plain=None, push=None, ear_hops=50004,
                  plain_blocks=None):
    """The station's main path at width M through the entry points -- the
    one-shot block (K3, n = Nh·M/2 at Nh=8192, 8 planted bursts), the
    streaming receiver (K2, phase 8's stream in pushes of at least 8192
    hops), the transmitter read back through K3 (K4, phase 7), the
    closed loop (K4 + K2 under the CUDA graph: phase 13's checks at 4
    blocks, phase 14's times at 32) and the mobile's analysis (K1,
    ``dsp.channelizer.analyze``) -- each path with its kernel's count set
    to 0 just before it and read just after; the loop's times are the
    median of ``loop_runs`` runs (its plain kernels timed as
    ``loop_plain`` says, ``phase_loop_times``); ``witness`` goes to
    phases 7 and 13.  The depth of each path: the block's plain path
    timed in ``loop_plain``'s turns where that is given, the receiver's ``push`` (default max(RX_PUSH, 8192·M/2)), the ear's
    ``ear_hops`` (a superframe), the loop's plain path timed on
    ``plain_blocks`` blocks (default the loop's).  Returns the readings."""
    from amps_tpu_torch.dsp import channelizer as chz
    from amps_tpu_torch.eval.traffic import (synthesize_reverse_band,
                                             unit_channel_band)
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.parallel import pipeline as pl
    out, launches = {}, {}

    # the one-shot block (K3)
    Nh = 8192
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    # 2..4 words from hops 100..1799: every burst ends inside the block,
    # the banks' delay (2T - 1 hops through synthesis and analysis)
    # included
    events = plant_events(M, 768, max_words=4)
    assert max(ev.start_hop + (48 + 240 * len(ev.words)) * 2 * sps
               for ev in events) + 2 * T - 1 <= Nh
    x = synthesize_reverse_band(events, prod, Nh, noise_sigma=0.001,
                                device=dev)
    log(f"  M={M}: rx_multichannel_block, production spec, Nh={Nh} "
        f"({Nh * M // 2} samples), {len(events)} planted bursts of 2..4 "
        f"words")
    K.LAUNCHES = 0
    got = pl.rx_multichannel_block(x, prod, max_bursts=2)
    sync(dev)
    launches["block"] = K.LAUNCHES
    assert launches["block"] == 1, launches
    check_planted(got, events)
    block_fns = {
        "kernel": lambda: pl.rx_multichannel_block(x, prod, max_bursts=2),
        "plain": lambda: pl._rx_block(x, prod, 2, 0.55, "first_ok",
                                      K.analyze_phases_reference,
                                      plain_search)}
    if loop_plain is None:
        out["block"] = timed(block_fns, 10)
    else:
        out["block"] = timed({"kernel": block_fns["kernel"]}, 10)
        out["block"].update(timed({"plain": block_fns["plain"]},
                                  *loop_plain))
    busy, wall, _ = profile_window(
        f"rx_multichannel_block at M={M}, {Nh * M // 2} samples", lambda:
        pl.rx_multichannel_block(x, prod, max_bursts=2), dev)
    out["block"]["idle"] = 1 - busy / wall
    log(f"  the block at M={M}: {out['block']['kernel']:.3f} ms (plain path "
        f"{out['block']['plain']:.3f}), median of 10, CUDA events, on {card}")
    del x, got
    torch.cuda.empty_cache()

    # the streaming receiver (K2), the transmitter (K4), the closed loop
    stamp(f"  M={M}: the receiver")
    launches["receiver"], _ = phase_rx(
        dev, M, T, push=push or max(RX_PUSH, 8192 * (M // 2)))
    free_dense_tables()         # the plain front end's; the loop rebuilds them
    stamp(f"  M={M}: the transmitter")
    launches["transmitter"] = phase_tx(dev, M, T, witness=witness)
    torch.cuda.empty_cache()
    stamp(f"  M={M}: the closed loop")
    launches["loop_checks"], out["loop_err"] = phase_loop_checks(
        dev, M, T, witness=witness)
    out["loop"] = phase_loop_times(dev, M, T, card, n_runs=loop_runs,
                                   plain=loop_plain,
                                   plain_blocks=plain_blocks)
    launches["loop"] = out["loop"]["launches"]
    torch.cuda.empty_cache()
    stamp(f"  M={M}: the mobile's analysis")

    # the mobile's analysis (K1): dsp.channelizer.analyze on a CUDA state
    spec = chz.ChannelizerSpec(M, T)
    xs = unit_channel_band(M, T, ear_hops, M, dev)[M * T - M // 2:]
    KA.LAUNCHES = 0
    y, st = chz.analyze(xs, spec, chz.analyzer_init(spec, device=dev),
                        chmajor=True)
    sync(dev)
    launches["analysis"] = KA.LAUNCHES
    yr, _ = chz.analyze(xs, spec, chz.analyzer_init(spec, device=dev),
                        chmajor=True, block=KA.analyze_reference)
    sync(dev)
    out["analysis_err"] = (y - yr).abs().max().item()
    del yr
    n1 = ((ear_hops // 2 - 1) | 1) * (M // 2)      # an odd first block
    ya, sa = chz.analyze(xs[:n1], spec, chz.analyzer_init(spec, device=dev),
                         chmajor=True)
    yb, sb = chz.analyze(xs[n1:], spec, sa, chmajor=True)
    sync(dev)
    assert launches["analysis"] == 1 and out["analysis_err"] <= ANALYSIS_ATOL
    assert torch.equal(torch.cat([ya, yb], 1), y) and sb.hop_idx == st.hop_idx
    log(f"  M={M}: dsp.channelizer.analyze of {ear_hops} hops on "
        f"the card: analysis launches {launches['analysis']}, max|err| vs "
        f"the plain block analysis {out['analysis_err']:.3e}; two chained "
        f"calls (odd first block) equal one bit for bit")
    del xs, y, ya, yb
    torch.cuda.empty_cache()
    for k, n in launches.items():
        assert (n > 0) if isinstance(n, int) else all(n), (k, n)
    log(f"  launches on the M={M} paths (each count set to 0 just before "
        f"its path): {launches}")
    out["launches"] = launches
    return out


def phase_widths(dev, card, T=8, sps=3):
    """Phase 29: the FFT tile at widths that are not powers of two.  Finds
    every width's own library (built in phase 1); holds each kernel to
    its plain version at WIDTH_CHECKS (phase 12's checks, T=8); times
    each kernel at WIDTH_TIMES beside M=1024; then runs the station's
    main path at STATION_M (``station_paths``).  Returns the readings."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import build
    widths = width_libraries()
    t0 = time.perf_counter()
    build.build(widths=widths)        # built in phase 1: a lookup here
    out = {"build_s": time.perf_counter() - t0}
    log(f"phase 29: widths that are not powers of two, each in its own "
        f"library (built in phase 1; {out['build_s']:.3f} s to find them)")
    for M in widths:
        log(f"  M={M}: radices {KA.fft_radices(M)}, hops a block "
            f"{KA.FFT_TILE_HOPS[M]} (K1) / {KA.FFT_WIDE_HOPS[M]}")
    # M=4096: K3 at sps=3 needs six hops a block; their plane fits the
    # card's shared memory only with the twiddle table in device memory
    M = 4096
    plane = 8 * 6 * KA.fft_hop_stride(M)
    table = 8 * len(KA.fft_twiddle_exponents(M))
    have = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    log(f"  M={M}: K3's plane at six hops a block takes {plane} bytes of "
        f"shared memory, {plane + table} with the twiddle table beside it; "
        f"the card lets a block have {have}: the table stays in device "
        f"memory past M=2048")
    assert plane == KA.fft_smem_bytes(M, 6) <= have < plane + table
    out["errs"], _ = phase_small_widths(
        dev, Nh=2001, widths=WIDTH_CHECKS, Ts=(T,),
        label="phase 29: each kernel vs plain", times=False, seam=True)
    out["rows"] = width_times(dev, card, WIDTH_TIMES, T)
    out.update(station_paths(dev, card, STATION_M, T, sps))
    return out


def assert_refused(dev, widths, T=8, sps=3):
    """Every wrapper raises ValueError on the card at each of ``widths``,
    before it launches anything."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import synth as S
    for M in widths:
        x = torch.zeros(((100 + 2 * T - 1) * max(M // 2, 1), 2), device=dev)
        Y = torch.zeros((4, M, 2), device=dev)
        calls = (lambda: KA.analyze_block(x, M, T),
                 lambda: R.analyze_demod(x, M, T, 0, torch.zeros(
                     (M, 2), device=dev)),
                 lambda: K.analyze_phases(x, M, T, sps),
                 lambda: S.synthesize_block(Y, M, T, 0, torch.zeros(
                     (M * T - M // 2, 2), device=dev)))
        for call in calls:
            try:
                call()
            except ValueError:
                continue
            raise AssertionError(f"M={M} was not refused")
        del x, Y


def phase_wide(dev, card, T=8, sps=3):
    """Phase 30: banks past 2048 channels.  Every wrapper refuses the odd
    M = 4095, 8193 and 32769 and M = 0 on the card; each kernel is held
    to its plain version at WIDE_CHECKS (phase 12's checks, T=8) and
    timed at WIDE_TIMES beside M=1024; the station's main path runs at WIDE_M
    (``station_paths``), then the station app's short call (``bs
    --channels WIDE_M``, K4 on its TX thread, K2 on its RX thread).
    Returns the readings."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import synth as S
    log(f"phase 30: banks past 2048 channels (the twiddles read from device "
        f"memory, K4's columns in groups), on {card}")
    for M in sorted(set(WIDE_CHECKS + WIDE_TIMES)):
        H = KA.FFT_WIDE_HOPS[M]
        log(f"  M={M}: radices {KA.fft_radices(M)}, hops a block "
            f"{KA.FFT_TILE_HOPS[M]} (K1) / {H}, {KA.fft_smem_bytes(M, H)} "
            f"bytes of shared memory a K2-K4 block, K3 owns "
            f"{K.run_hops(M, sps)} hops a block at sps={sps}, K4 in "
            f"{S.column_groups(M, T)} column groups of at most "
            f"{S.thread_columns(M, T)} columns a thread")
    assert_refused(dev, (4095, 8193, 32769, 0), T, sps)
    log("  M = 4095, 8193, 32769 and 0 raise ValueError in all four "
        "wrappers")
    out = {}
    out["errs"], _ = phase_small_widths(
        dev, Nh=2001, widths=WIDE_CHECKS, Ts=(T,),
        label="phase 30: each kernel vs plain", times=False, seam=True)
    out["rows"] = width_times(dev, card, WIDE_TIMES, T)
    torch.cuda.empty_cache()
    out.update(station_paths(dev, card, WIDE_M, T, sps))
    out["app"] = station_app_call(dev, card, WIDE_M)
    out["launches"]["app"] = out["app"]["launches"]
    return out


def station_app_call(dev, card, M):
    """The station app's short call at width M, one superframe in-process
    (``bs --channels M``, K4 on its TX thread, K2 on its RX thread): the
    origination reported once on slot 3.  Returns {"launches": (synth,
    rx_front), "wall_s"}."""
    from amps_tpu_torch.__main__ import main as cli
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.tx import recc_ms
    argv = ["bs", "--channels", str(M), *WIDE_APP_ARGS]
    log(f"  the station app, python -m amps_tpu_torch {' '.join(argv)} "
        f"(card memory before it: {torch.cuda.memory_allocated(dev) / 1e9:.2f}"
        f" GB allocated, {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB "
        f"reserved)")
    result = {}
    S.LAUNCHES = R.LAUNCHES = 0
    sync(dev)
    t0 = time.perf_counter()
    quiet(lambda: cli(argv, _result=result))()
    sync(dev)
    wall = time.perf_counter() - t0
    stats, reps = result["stats"], result["reports"]
    want = recc_ms.origination_words("5551234567", "5551230000")
    assert len(reps) == 1 and reps[0].channel == 3, reps
    assert np.array_equal(np.asarray(reps[0].words[:2], np.uint8),
                          np.asarray(want[:2], np.uint8))
    assert stats.tx_samples == 18 * 463 * 2 * 3 * (M // 2), stats
    assert S.LAUNCHES >= 1 and R.LAUNCHES >= stats.rx_blocks >= 1
    log(f"  the origination reported once on slot 3, words A and B right; "
        f"launches synth {S.LAUNCHES}, rx_front {R.LAUNCHES} "
        f"({stats.rx_blocks} RX blocks); {wall:.2f} s in-process, synced, "
        f"on {card}")
    return {"launches": (S.LAUNCHES, R.LAUNCHES), "wall_s": wall}


def phase_widest(dev, card, T=8, sps=3):
    """Phase 31: banks past 4096 channels, each hop shared by a cluster of
    two thread blocks over distributed shared memory.  Prints each
    width's half-width plan, hops, shared memory, K3's run, K4's groups
    and the clusters the card holds at once (cudaOccupancyMaxActive-
    Clusters, each kernel); holds each kernel to its plain version at
    WIDEST_CHECKS (phase 12's checks, T=8: both parities, riq and planar,
    chained = one bit for bit); times each kernel at WIDEST_TIMES beside
    M=4096 and 1024 (the dense plain versions in WIDER_PLAIN_TURNS); runs
    the station's main path at WIDEST_M (``station_paths``, the loop's
    times from one run) and the station app's short call there, with the
    peak device memory of the paths.  Returns the readings."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import synth as S
    log(f"phase 31: banks past 4096 channels (a cluster of two blocks a hop, "
        f"distributed shared memory), on {card}")
    out = {"clusters": {}}
    for M in WIDEST_CHECKS:
        N, H = KA.fft_plan_width(M), KA.FFT_WIDE_HOPS[M]
        n = out["clusters"][M] = {
            p: KA.max_clusters(p, M)
            for p in ("analysis", "rx_front", "rx_phases", "synth")}
        assert KA.fft_cluster_size(M) == 2 and min(n.values()) > 0, (M, n)
        log(f"  M={M}: clusters of {KA.fft_cluster_size(M)} blocks, each "
            f"block's plan {KA.fft_radices(N)} at N={N}, hops a block "
            f"{KA.FFT_TILE_HOPS[M]} (K1) / {H}, {KA.fft_smem_bytes(M, H)} "
            f"bytes of shared memory a K2-K4 block, K3 owns "
            f"{K.run_hops(M, sps)} hops a cluster at sps={sps}, K4 in "
            f"{S.column_groups(M, T)} column groups of two blocks, at most "
            f"{S.thread_columns(M, T)} columns a thread; clusters the card "
            f"holds at once {n}")
    out["errs"], _ = phase_small_widths(
        dev, Nh=2001, widths=WIDEST_CHECKS, Ts=(T,),
        label="phase 31: each kernel vs plain", times=False, seam=True)
    out["rows"] = width_times(dev, card, WIDEST_TIMES, T, base=4096,
                              plain=WIDER_PLAIN_TURNS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out.update(station_paths(dev, card, WIDEST_M, T, sps, loop_runs=1))
    out["app"] = station_app_call(dev, card, WIDEST_M)
    out["launches"]["app"] = out["app"]["launches"]
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  peak device memory of the M={WIDEST_M} paths: "
        f"{out['peak_gb']:.2f} GB (torch.cuda.max_memory_allocated)")
    return out


# phase 32: prototype filters longer than 16 taps a phase (K1-K3 fold in
# chunks, K4 sums one launch a chunk of 16 gain rows).  TAPS_CHECKS holds
# each kernel to its plain version at TAPS_WIDTHS (the smallest bank, a
# mixed radix width, 1024, a generic prime pass at 2038, the
# device-memory twiddles at 4096, the cluster at 8192) within TAPS_TOL
# (K1: max |err| on unit-modulus channels, K2: demod radians off the
# seam, as phase 31 reports them; K4: the share of the output's RMS; K3 as
# phases 29-31 hold it); TAPS_TIMES times each kernel at TAPS_M
# beside T=8; TAPS_T is the sharp filter of an operator whose near and
# far mobiles sit on adjacent channels, on the station's main path at
# TAPS_M
TAPS_CHECKS = (17, 24, 32, 33, 64)
TAPS_WIDTHS = (8, 768, 1024, 2038, 4096, 8192)
TAPS_TIMES = (8, 16, 24, 32, 64)
TAPS_M, TAPS_T = 1024, 32
TAPS_TOL = {"analysis": 5e-6, "rx_front": 1e-5, "synth": 2e-5}


def phase_taps(dev, card, sps=3):
    """Phase 32: filters of T > 16 taps a phase.  Holds each kernel to its
    plain version at TAPS_CHECKS x TAPS_WIDTHS (phase 12's checks: both
    parities, riq and planar, chained = one, K1 and K2 bit for bit, within
    TAPS_TOL); times each kernel at TAPS_M, Nh=8192, for each of
    TAPS_TIMES beside its plain version, its bound and cuFFT; runs the
    station's main path at TAPS_M, TAPS_T (``station_paths``) and one
    sharded step there (phase 21's checks), K4 launching
    ``chunk_launches(T)`` times a call on every path.  Returns the
    readings."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import synth as S
    log(f"phase 32: filters longer than {KA.CHUNK_TAPS} taps a phase (K1-K3 "
        f"fold in chunks of {KA.CHUNK_TAPS} taps, K4 sums one launch a "
        f"chunk), on {card}")
    out = {}
    out["errs"], _ = phase_small_widths(
        dev, Nh=2001, widths=TAPS_WIDTHS, Ts=TAPS_CHECKS,
        label="phase 32: each kernel vs plain", times=False, seam=True,
        bounds=TAPS_TOL)
    rows = out["rows"] = {}
    for T in TAPS_TIMES:
        r = rows[T] = width_rows(dev, TAPS_M, T, 8192)
        log(f"  M={TAPS_M}, T={T}, Nh=8192, kernel / plain / bound ms (x the "
            f"T=8 kernel), cuFFT {r['fft']:.3f} ms, on {card}: " + "; ".join(
                f"{k} {v['kernel']:.3f} / {v['plain']:.3f} / "
                f"{v['bound']:.3f} ({v['bound_by']}, "
                f"{v['kernel'] / rows[8][k]['kernel']:.2f}x)"
                for k, v in r.items() if k != "fft"))
    torch.cuda.empty_cache()
    out.update(station_paths(dev, card, TAPS_M, TAPS_T, sps))
    out["block_by_t"] = block_by_taps(dev, card, TAPS_M, (8, TAPS_T))
    # K4's chunk launches a call (the loop's are held in phases 13-14's
    # own checks, a block's per replay)
    C = S.chunk_launches(TAPS_T)
    n = out["launches"]
    assert n["transmitter"] == 2 * C, n
    mesh = phase_mesh_step(dev, TAPS_M, TAPS_T, card)
    n["sharded_step"] = mesh["launches"]
    log(f"  launches at T={TAPS_T} (K4 {C} a call): {n}")
    return out


def block_by_taps(dev, card, M, Ts, Nh=8192):
    """The one-shot block on one band (station_paths' 8 bursts,
    synthesized at the longest of ``Ts``) with each of ``Ts`` taps,
    interleaved (median of N_TIMED, CUDA events), each with its profiler
    window's device busy time.  Returns {T: (ms, busy ms)}."""
    from amps_tpu_torch.eval.traffic import synthesize_reverse_band
    from amps_tpu_torch.parallel import pipeline as pl
    specs = {T: pl.MultichannelSpec(num_channels=M, taps_per_phase=T,
                                    fold="bank", io_bf16=True,
                                    corr_bf16=True, transform_bf16=True)
             for T in Ts}
    events = plant_events(M, 768, max_words=4)
    x = synthesize_reverse_band(events, specs[max(Ts)], Nh,
                                noise_sigma=0.001, device=dev)
    for T in Ts:
        check_planted(pl.rx_multichannel_block(x, specs[T], max_bursts=2),
                      events)
    t = timed({T: (lambda T=T: pl.rx_multichannel_block(x, specs[T],
                                                        max_bursts=2))
               for T in Ts})
    out = {}
    for T in Ts:
        busy, _, _ = profile_window(
            f"rx_multichannel_block at M={M}, T={T}", lambda: (
                pl.rx_multichannel_block(x, specs[T], max_bursts=2)), dev)
        out[T] = (t[T], busy)
    log(f"  the block at M={M} on one band, by taps (ms, device busy ms), "
        f"interleaved, median of {N_TIMED}, on {card}: {out}")
    return out


# phase 33: banks past 8192 channels, whose hops a cluster of C = 3 .. 8
# thread blocks shares, with a radix-C pass across it over distributed
# shared memory (C the smallest divisor of M from 2 to 8 with M/C <=
# 4096).  WIDER_REFUSED is an odd width, one with no such C and one past
# the widest; WIDER_CHECKS holds each kernel to its plain version at one
# width a cluster size (3: 8196 = 3·2732, the generic pass, and 12288; 4:
# 16384; 5: 20480; 6: 12294 = 6·2049, an odd block width; 7: 28672; 8:
# 32768, and 16424 = 8·2053, a prime block width whose ranges of K4's
# columns do not divide P evenly) on WIDER_NH hops (the plain versions
# are dense: 8.6 GB of matrices at 32768); WIDER_TIMES times them beside
# 8192; WIDER_M is a 491.52 Msps station (a USRP X410's top master clock
# rate), whose main path runs end to end
WIDER_REFUSED = (8195, 16389, 32769)
WIDER_CHECKS = (8196, 12288, 16384, 20480, 12294, 28672, 32768, 16424)
WIDER_NH = 501
WIDER_TIMES = (8192, 12288, 16384)
WIDER_PLAIN_TURNS = (3, 1)    # turns and calls of the dense plain versions
# blocks of the closed loop's plain path in phases 33-35 (its dense
# transforms take a large share of a second a block past 8192)
WIDER_PLAIN_BLOCKS = 4
WIDER_M = 16384


def wider_bounds(M):
    """The kernel-vs-plain bounds at width M: phase 32's TAPS_TOL up to
    8192, and past it TAPS_TOL x sqrt(M / 8192).  Past 8192 the plain
    versions' dense f32 sums (cuBLAS SGEMM over M/2 terms a product) set
    the difference, which grows as the square root of their length;
    phase 33 shows which side it is by holding both to float64
    references (``analysis_f64``, ``demod_f64``, ``synth_f64``), the
    kernels within TAPS_TOL itself at every width."""
    return {k: v * max(1.0, math.sqrt(M / 8192)) for k, v in TAPS_TOL.items()}


def free_dense_tables():
    """Drop the plain analysis's cached dense DFT matrices
    (``_analysis_consts``, on the card) and release the allocator's
    cache, after a garbage collection (a closed loop's CUDA graph and its
    memory pool go with their stream): phase 33 holds one width's tables
    at a time, and ``station_paths`` none while the transmitter runs."""
    import gc
    from amps_tpu_torch.dsp import polyphase as pp
    pp._analysis_consts.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase_wider(dev, card, T=8, sps=3):
    """Phase 33: banks past 8192 channels.  Every wrapper refuses
    WIDER_REFUSED; prints each width's cluster, block plan, hops, shared
    memory, K3's run, K4's groups and the clusters the card holds at once
    (cudaOccupancyMaxActiveClusters, each kernel); holds each kernel to
    its plain version at WIDER_CHECKS (phase 12's checks, T=8: both
    parities, riq and planar, chained = one bit for bit) within
    ``wider_bounds``, and K1, K2 and K4 to float64 references of their
    functions within TAPS_TOL (their plain versions' errors there
    beside them); times each kernel at WIDER_TIMES beside 8192; runs
    the station's main path at WIDER_M (``station_paths``) and the
    station app's short call there, with the peak device memory of the
    paths.  Returns the readings."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import synth as S
    t0 = time.perf_counter()
    log(f"phase 33: banks past 8192 channels (a cluster of up to 8 blocks a "
        f"hop, a radix-C pass across it), on {card}")
    assert_refused(dev, WIDER_REFUSED, T, sps)
    log(f"  M = {', '.join(map(str, WIDER_REFUSED))} (odd) raise "
        f"ValueError in all four wrappers")
    out = {"clusters": {}, "errs": {
        k: {} for k in ("analysis", "rx_front", "rx_phases", "synth")},
        "f64": {k: {} for k in TAPS_TOL}}
    for M in WIDER_CHECKS:
        C, N, H = (KA.fft_cluster_size(M), KA.fft_plan_width(M),
                   KA.FFT_WIDE_HOPS[M])
        n = out["clusters"][M] = {
            p: KA.max_clusters(p, M)
            for p in ("analysis", "rx_front", "rx_phases", "synth")}
        assert C > 2 and min(n.values()) > 0, (M, C, n)
        log(f"  M={M}: clusters of {C} blocks, each block's plan "
            f"{KA.fft_radices(N)} at N={N}, hops a block "
            f"{KA.FFT_TILE_HOPS[M]} (K1) / {H}, {KA.fft_smem_bytes(M, H)} "
            f"bytes of shared memory a K1-K3 block, K3 owns "
            f"{K.run_hops(M, sps)} hops a cluster at sps={sps}, K4 in "
            f"{S.column_groups(M, T)} column groups of {C} blocks, "
            f"{S.SYNTH_HOPS[M]} hops a pass, at most "
            f"{S.thread_columns(M, T)} columns a thread; clusters the card "
            f"holds at once {n}")
    for M in WIDER_CHECKS:
        b = wider_bounds(M)
        errs, _ = phase_small_widths(
            dev, Nh=WIDER_NH, widths=(M,), Ts=(T,),
            label=f"phase 33: each kernel vs plain (bounds K1 "
                  f"{b['analysis']:.2e}, K2 {b['rx_front']:.2e} rad, K4 "
                  f"{b['synth']:.2e} of RMS)",
            times=False, seam=True, bounds=b, witness=out["f64"])
        for k, v in errs.items():
            out["errs"][k].update(v)
        f = {k: out["f64"][k][M] for k in TAPS_TOL}
        log(f"  M={M} against float64 (both parities, riq and planar), "
            f"kernel | plain: K1 "
            f"{f['analysis'][0]:.3e} | {f['analysis'][1]:.3e}, K2 "
            f"{f['rx_front'][0]:.3e} | {f['rx_front'][1]:.3e} rad, K4 "
            f"{f['synth'][0]:.2e} | {f['synth'][1]:.2e} of RMS (kernels' "
            f"bounds K1 {TAPS_TOL['analysis']:.0e}, K2 "
            f"{TAPS_TOL['rx_front']:.0e}, K4 {TAPS_TOL['synth']:.0e})")
        assert all(f[k][0] <= TAPS_TOL[k] for k in TAPS_TOL), (M, f)
        free_dense_tables()
    log(f"  checks done at {time.perf_counter() - t0:.1f} s into the phase")
    out["rows"] = width_times(dev, card, WIDER_TIMES, T, base=8192,
                              plain=WIDER_PLAIN_TURNS)
    free_dense_tables()
    log(f"  times done at {time.perf_counter() - t0:.1f} s into the phase "
        f"(plain versions: median of {WIDER_PLAIN_TURNS[0]} turns of "
        f"{WIDER_PLAIN_TURNS[1]} call)")
    torch.cuda.reset_peak_memory_stats(dev)
    out.update(station_paths(dev, card, WIDER_M, T, sps, loop_runs=1,
                             loop_plain=WIDER_PLAIN_TURNS,
                             plain_blocks=WIDER_PLAIN_BLOCKS))
    free_dense_tables()
    out["app"] = station_app_call(dev, card, WIDER_M)
    out["launches"]["app"] = out["app"]["launches"]
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  peak device memory of the M={WIDER_M} paths: "
        f"{out['peak_gb']:.2f} GB (torch.cuda.max_memory_allocated); phase "
        f"33 took {time.perf_counter() - t0:.1f} s")
    return out


# phase 34: the even widths in (8192, 16384] that no cluster of at most 8
# blocks splits (937 of the 4096), each computed as Bluestein's chirp
# convolution of length 32768 on a cluster of 8 blocks of 4096 points.
# BLUESTEIN_REFUSED stay refused (past 16384 unsplit, past 32768, odd).
# BLUESTEIN_CHECKS holds each kernel to its plain version and to float64
# (8194 = 2·17·241 and 8198 = 2·4099, the first two, whose blocks hold
# 1025 or 1024 channels; 13334 = 2·59·113; 16378 = 2·19·431, whose last
# position holds a channel in two ranks of eight; 16382 = 2·8191, the
# widest, in six), and BLUESTEIN_LONG does so at T = 32 (the chunked fold
# and K4's chunk launches); BLUESTEIN_TIMES times them beside phase 33's
# 8192 and 16384 (``BLUESTEIN_BESIDE``); BLUESTEIN_M is a 491.46 Msps
# station, whose main path runs end to end; BLUESTEIN_PROBE is the
# cluster a chirp transform of 65536 points would have needed on the
# clusters' route (the unsplit widths past 16384, which phase 35 runs
# through device memory instead), whose count the card holds is read, not
# launched
BLUESTEIN_REFUSED = (8193, 16383, 32769, 0)
BLUESTEIN_CHECKS = (8194, 8198, 13334, 16378, 16382)
BLUESTEIN_LONG = ((8194,), 32)
BLUESTEIN_TIMES = (8194, 16382)
BLUESTEIN_BESIDE = {8194: 8192, 16382: 16384}
BLUESTEIN_M = 16382
BLUESTEIN_PROBE = 16


def bluestein_bounds(M):
    """The kernel-vs-plain bounds of phase 34 at width M: TAPS_TOL plus
    ``wider_bounds(M)``.  Each kernel is held to float64 within TAPS_TOL
    itself; the plain versions' dense f32 sums at these widths (no
    multiple of 128) stray from float64 by up to about ``wider_bounds``
    (K1 3.7e-6, K4 1.7e-5 of RMS at 8194 on the H100), so by the triangle
    inequality the two differ by at most the sum."""
    return {k: TAPS_TOL[k] + v for k, v in wider_bounds(M).items()}


def phase_bluestein(dev, card, wider_rows, T=8, sps=3):
    """Phase 34: the unsplit widths past 8192 (Bluestein's chirp
    transform).  Every wrapper refuses BLUESTEIN_REFUSED; prints each
    checked width's mode, length, cluster, block plan, channels a block,
    hops, shared memory, K4's groups and the clusters the card holds at
    once (each kernel), and the clusters of BLUESTEIN_PROBE it would hold
    (``probe_clusters``); holds each kernel to its plain version at
    BLUESTEIN_CHECKS (phase 12's checks, T=8: both parities, riq and
    planar, chained = one bit for bit) within ``bluestein_bounds``, and K1,
    K2 and K4 to float64 within TAPS_TOL, then the same at
    BLUESTEIN_LONG; times each kernel at BLUESTEIN_TIMES beside phase
    33's ``wider_rows`` at BLUESTEIN_BESIDE; runs the station's main path
    at BLUESTEIN_M (``station_paths``) and the station app's short call
    there, with the peak device memory of the paths.  Returns the
    readings."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import synth as S
    t0 = time.perf_counter()
    log(f"phase 34: the unsplit widths past 8192 (Bluestein's chirp "
        f"transform of length 32768 on a cluster of 8 blocks), on {card}")
    assert_refused(dev, BLUESTEIN_REFUSED, T, sps)
    log(f"  M = {', '.join(map(str, BLUESTEIN_REFUSED))} (odd, 0) raise "
        f"ValueError in all four wrappers")
    out = {"clusters": {}, "errs": {
        k: {} for k in ("analysis", "rx_front", "rx_phases", "synth")},
        "f64": {k: {} for k in TAPS_TOL},
        "f64_long": {k: {} for k in TAPS_TOL}}
    for M in BLUESTEIN_CHECKS:
        L, C, N, H = (KA.bluestein_length(M), KA.cluster_blocks(M),
                      KA.fft_plan_width(M), KA.FFT_WIDE_HOPS[M])
        n = out["clusters"][M] = {
            p: KA.max_clusters(p, M)
            for p in ("analysis", "rx_front", "rx_phases", "synth")}
        assert L == 32768 and C == 8 and min(n.values()) > 0, (M, L, C, n)
        log(f"  M={M}: Bluestein, L={L} on clusters of {C} blocks, each "
            f"block's plan {KA.fft_radices(N)} at N={N} (twice a hop), "
            f"{KA.fft_block_channels(M)} channels a block, hops a block "
            f"{KA.FFT_TILE_HOPS[M]} (K1) / {H}, {KA.fft_smem_bytes(M, H)} "
            f"bytes of shared memory a K1-K3 block, K3 owns "
            f"{K.run_hops(M, sps)} hops a cluster at sps={sps}, K4 in "
            f"{S.column_groups(M, T)} column groups of {C} blocks, "
            f"{S.SYNTH_HOPS[M]} hops a pass, at most "
            f"{S.thread_columns(M, T)} columns a thread; clusters the card "
            f"holds at once {n}")
    probe = out["probe"] = {b: KA.probe_clusters(BLUESTEIN_M, b)
                            for b in (8, BLUESTEIN_PROBE)}
    assert probe[8] > 0, probe
    log(f"  clusters of the analysis kernel at M={BLUESTEIN_M} the card "
        f"holds at once with non-portable sizes allowed (a probe, nothing "
        f"launched): {probe}")
    for widths, Tc, key in ([((M,), T, "f64") for M in BLUESTEIN_CHECKS]
                            + [BLUESTEIN_LONG + ("f64_long",)]):
        M = widths[0]
        b = bluestein_bounds(M)
        errs, _ = phase_small_widths(
            dev, Nh=WIDER_NH, widths=widths, Ts=(Tc,),
            label=f"phase 34: each kernel vs plain (bounds K1 "
                  f"{b['analysis']:.2e}, K2 {b['rx_front']:.2e} rad, K4 "
                  f"{b['synth']:.2e} of RMS)",
            times=False, seam=True, bounds=b, witness=out[key])
        if Tc == T:
            for k, v in errs.items():
                out["errs"][k].update(v)
        f = {k: out[key][k][M] for k in TAPS_TOL}
        log(f"  M={M}, T={Tc} against float64 (both parities, riq and "
            f"planar), kernel | plain: K1 "
            f"{f['analysis'][0]:.3e} | {f['analysis'][1]:.3e}, K2 "
            f"{f['rx_front'][0]:.3e} | {f['rx_front'][1]:.3e} rad, K4 "
            f"{f['synth'][0]:.2e} | {f['synth'][1]:.2e} of RMS (kernels' "
            f"bounds K1 {TAPS_TOL['analysis']:.0e}, K2 "
            f"{TAPS_TOL['rx_front']:.0e}, K4 {TAPS_TOL['synth']:.0e})")
        assert all(f[k][0] <= TAPS_TOL[k] for k in TAPS_TOL), (M, Tc, f)
        free_dense_tables()
    log(f"  checks done at {time.perf_counter() - t0:.1f} s into the phase")
    out["rows"] = width_times(dev, card, BLUESTEIN_TIMES, T,
                              base=BLUESTEIN_TIMES[0],
                              plain=WIDER_PLAIN_TURNS)
    free_dense_tables()
    for M, base in BLUESTEIN_BESIDE.items():
        r, w = out["rows"][M], wider_rows[base]
        log(f"  M={M} against M={base} (phase 33), kernel ms: " + "; ".join(
            f"{k} {r[k]['kernel']:.3f} vs {w[k]['kernel']:.3f} "
            f"({r[k]['kernel'] / w[k]['kernel']:.2f}x, bound "
            f"{r[k]['bound']:.3f})" for k in r if k != "fft"))
    log(f"  times done at {time.perf_counter() - t0:.1f} s into the phase")
    torch.cuda.reset_peak_memory_stats(dev)
    out.update(station_paths(dev, card, BLUESTEIN_M, T, sps, loop_runs=1,
                             witness=True, loop_plain=WIDER_PLAIN_TURNS,
                             plain_blocks=WIDER_PLAIN_BLOCKS))
    free_dense_tables()
    out["app"] = station_app_call(dev, card, BLUESTEIN_M)
    out["launches"]["app"] = out["app"]["launches"]
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"  peak device memory of the M={BLUESTEIN_M} paths: "
        f"{out['peak_gb']:.2f} GB (torch.cuda.max_memory_allocated); phase "
        f"34 took {time.perf_counter() - t0:.1f} s")
    return out


# phase 35: every other even width, through device memory (the route of
# csrc/route.cu: the hops of a chunk folded or loaded into a scratch
# plane, a Stockham FFT of length L = 2^k as passes of radix 256 .. 4096
# between two planes, directly where M is a power of two, Bluestein's
# chirp convolution elsewhere, and each kernel's epilogue).  ROUTE_REFUSED
# stay refused (odd, 0).  ROUTE_CHECKS holds each kernel to its plain
# version and to float64 at ROUTE_NH hops (16388 = 4·17·241 the first
# unsplit width past 16384 and 32766 = 2·3·43·127 the last, L = 65536;
# 32770 the first past 32768, L = 131072; 65536 a power of two, direct),
# ROUTE_FAR at a few hops (1048574 = 2·524287, L = 2^21; 8388610 = 2^23 +
# 2, L = 2^25, three passes a transform), ROUTE_LONG at T = 32;
# ROUTE_TIMES times them beside the split cluster of 8 at ROUTE_BESIDE;
# ROUTE_M is a 982.98 Msps station, whose main path runs end to end with
# the receiver's pushes of
# ROUTE_PUSH_HOPS (the plain synthesis of its six pushes' band at 8192
# hops a push ran out of the card's memory), the ear at ROUTE_EAR_HOPS
# and the loop's plain path timed on WIDER_PLAIN_BLOCKS blocks
ROUTE_REFUSED = (8193, 32769, 0)
ROUTE_CHECKS = (16388, 32766, 32770, 65536)
ROUTE_NH = 501
ROUTE_FAR = ((1048574, 41), (8388610, 25))
ROUTE_LONG = ((16388,), 32)
ROUTE_TIMES = (32766, 65536)
ROUTE_BESIDE = 32768
ROUTE_M = 32766
ROUTE_PUSH_HOPS = 4096
ROUTE_EAR_HOPS = 16670
# the plain versions' own error past 32768 (a float64 FFT between f32
# folds or overlap-adds, cast once to f32), added to TAPS_TOL there
ROUTE_PLAIN_F32 = {"analysis": 1e-6, "rx_front": 2e-6, "synth": 2e-6}


def route_bounds(M):
    """The kernel-vs-plain bounds of phase 35 at width M: up to 32768,
    where the plain versions are dense f32 sums, phase 34's
    ``bluestein_bounds``; past it TAPS_TOL plus ROUTE_PLAIN_F32, the
    plain versions there being float64 inside.  Each kernel is held to
    float64 within TAPS_TOL itself."""
    if M <= 32768:
        return bluestein_bounds(M)
    return {k: TAPS_TOL[k] + ROUTE_PLAIN_F32[k] for k in TAPS_TOL}


# the hop behind a chunk that each wrapper's route keeps (route.launches)
ROUTE_BEHIND = {"analysis": 0, "rx_front": 1, "rx_phases": 1, "synth": 0}


def route_geometry(M):
    """The route's layout at width M: mode, L, the radices of a transform,
    the passes a call runs a chunk, the scratch's rows a plane and
    bytes."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import route
    L = KA.route_length(M)
    rad = KA.route_radices(L)
    rows = route.scratch_rows(L)
    return {"mode": "direct" if L == M else "bluestein", "L": L,
            "radices": list(rad), "passes": len(rad) * (1 if L == M else 2),
            "rows": rows, "scratch_bytes": 2 * rows * L * 8}


def route_launches_seen(dev, M, Nh, T=8, sps=3):
    """The CUDA launches of one call of each wrapper on the route at width
    M over Nh hops, as the profiler sees them: the spans of csrc/route.cu's
    kernels (``route_*``) that start in a window around the one call, on
    zero inputs.  Each count is held to ``route.launches(M, Nh, behind)``
    (fold or load, the passes, the epilogue, a chunk); a window short of
    it is taken again, up to PROFILE_TRIES windows, each shortfall logged
    (the profiler drops records: ``phase_loop_times``), and one past it
    fails at once.  Returns {kernel: launches seen}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import route
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import synth as S
    P = M // 2
    x = torch.zeros(((Nh + 2 * T - 1) * P, 2), device=dev)
    prev = torch.zeros((M, 2), device=dev)
    Y = torch.zeros((Nh, M, 2), device=dev)
    carry = torch.zeros((M * T - P, 2), device=dev)
    calls = {"analysis": lambda: KA.analyze_block(x, M, T, 0),
             "rx_front": lambda: R.analyze_demod(x, M, T, 0, prev),
             "rx_phases": lambda: K.analyze_phases(x, M, T, sps, 0,
                                                   torch.bfloat16),
             "synth": lambda: S.synthesize_block(Y, M, T, 0, carry)}
    seen = {}
    for name, fn in calls.items():
        want = route.launches(M, Nh, ROUTE_BEHIND[name])
        for attempt in range(PROFILE_TRIES):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.zeros(1, device=dev)      # the window's first launch
                sync(dev)
                with record_function("route_window"):
                    fn()
                    sync(dev)
            t_win = min(e.time_range.start for e in prof.events()
                        if e.name == "route_window")
            n = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and e.time_range.start >= t_win
                    and not e.is_user_annotation and "route_" in e.name)
            assert n <= want, (M, Nh, name, n, want)
            if n == want:
                break
            log(f"  M={M}, Nh={Nh}: {n} route spans of {name} in the trace "
                f"against {want} (try {attempt + 1} of {PROFILE_TRIES})")
        assert n == want, (M, Nh, name, n, want)
        seen[name] = n
    del x, prev, Y, carry
    torch.cuda.empty_cache()
    log(f"  M={M}, Nh={Nh}: route kernels launched by one call (profiler "
        f"spans, each = route.launches): {seen} in "
        f"{route.chunks(M, Nh, 0)} / {route.chunks(M, Nh, 1)} chunks "
        f"(K1, K4 / K2, K3)")
    return seen


def phase_route(dev, card, T=8, sps=3):
    """Phase 35: every even width that no in-shared-memory mode takes,
    through device memory.  Every wrapper refuses ROUTE_REFUSED; prints
    each width's route (``route_geometry``); holds each kernel to its
    plain version at ROUTE_CHECKS and ROUTE_FAR (phase 12's checks: both
    parities, riq and planar, chained = one, K1 and K2 bit for bit) within
    ``route_bounds`` and K1, K2 and K4 to float64 within TAPS_TOL, then
    the same at ROUTE_LONG; times each kernel at ROUTE_TIMES (Nh=8192)
    beside the split cluster at ROUTE_BESIDE (kernels alone); counts each
    wrapper's CUDA launches in one call at each checked width and at
    ROUTE_TIMES (``route_launches_seen``); runs the station's main path
    at ROUTE_M (``station_paths``, phases 7 and 13 against float64) and
    the station app's short call there, with the peak device memory of
    each.  Returns the readings."""
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import route
    t0 = time.perf_counter()
    log(f"phase 35: every other even width, through device memory (a "
        f"Stockham FFT of passes of radix 256-4096 between scratch planes, "
        f"direct at a power of two, Bluestein elsewhere), on {card}")
    assert_refused(dev, ROUTE_REFUSED, T, sps)
    log(f"  M = {', '.join(map(str, ROUTE_REFUSED))} (odd, 0) raise "
        f"ValueError in all four wrappers")
    out = {"geometry": {}, "errs": {
        k: {} for k in ("analysis", "rx_front", "rx_phases", "synth")},
        "f64": {k: {} for k in TAPS_TOL},
        "f64_long": {k: {} for k in TAPS_TOL}}
    for M in sorted(set(ROUTE_CHECKS + ROUTE_TIMES
                        + tuple(M for M, _ in ROUTE_FAR))):
        g = out["geometry"][M] = route_geometry(M)
        assert g["L"] and M not in KA.FFT_WIDTHS, M
        log(f"  M={M}: {g['mode']}, L={g['L']}, radices {g['radices']}, "
            f"{g['passes']} passes a chunk, scratch of 2 x {g['rows']} rows "
            f"({g['scratch_bytes'] / 2 ** 30:.2f} GiB)")
    out["launches_seen"] = {}
    checks = ([((M,), T, ROUTE_NH, "f64") for M in ROUTE_CHECKS]
              + [((M,), T, nh, "f64") for M, nh in ROUTE_FAR]
              + [ROUTE_LONG + (ROUTE_NH, "f64_long")])
    for widths, Tc, nh, key in checks:
        M = widths[0]
        b = route_bounds(M)
        t1 = time.perf_counter()
        errs, _ = phase_small_widths(
            dev, Nh=nh, widths=widths, Ts=(Tc,),
            label=f"phase 35: each kernel vs plain (bounds K1 "
                  f"{b['analysis']:.2e}, K2 {b['rx_front']:.2e} rad, K4 "
                  f"{b['synth']:.2e} of RMS)",
            times=False, seam=True, bounds=b, witness=out[key])
        if Tc == T:
            for k, v in errs.items():
                out["errs"][k].update(v)
        f = {k: out[key][k][M] for k in TAPS_TOL}
        log(f"  M={M}, T={Tc}, Nh={nh} against float64 (both parities, riq "
            f"and planar), kernel | plain: K1 "
            f"{f['analysis'][0]:.3e} | {f['analysis'][1]:.3e}, K2 "
            f"{f['rx_front'][0]:.3e} | {f['rx_front'][1]:.3e} rad, K4 "
            f"{f['synth'][0]:.2e} | {f['synth'][1]:.2e} of RMS (kernels' "
            f"bounds K1 {TAPS_TOL['analysis']:.0e}, K2 "
            f"{TAPS_TOL['rx_front']:.0e}, K4 {TAPS_TOL['synth']:.0e}); "
            f"{time.perf_counter() - t1:.1f} s")
        assert all(f[k][0] <= TAPS_TOL[k] for k in TAPS_TOL), (M, Tc, f)
        free_dense_tables()
        if Tc == T:
            out["launches_seen"][M, nh] = route_launches_seen(dev, M, nh, T,
                                                              sps)
        route.tables.cache_clear()
        torch.cuda.empty_cache()
    log(f"  checks done at {time.perf_counter() - t0:.1f} s into the phase")
    out["rows"] = width_times(dev, card, ROUTE_TIMES, T,
                              base=ROUTE_TIMES[0], plain=WIDER_PLAIN_TURNS)
    free_dense_tables()
    out["beside"] = width_rows(dev, ROUTE_BESIDE, T, 8192, plain=False)
    for M, r in out["rows"].items():
        w = out["beside"]
        log(f"  M={M} against M={ROUTE_BESIDE} (the split cluster of 8), "
            f"kernel ms: " + "; ".join(
                f"{k} {r[k]['kernel']:.3f} vs {w[k]['kernel']:.3f} "
                f"({r[k]['kernel'] / w[k]['kernel']:.2f}x, bound "
                f"{r[k]['bound']:.3f})" for k in r if k != "fft"))
    for M in ROUTE_TIMES:
        out["launches_seen"][M, 8192] = route_launches_seen(dev, M, 8192, T,
                                                            sps)
    log(f"  times and launches done at {time.perf_counter() - t0:.1f} s into "
        f"the phase")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out.update(station_paths(dev, card, ROUTE_M, T, sps, loop_runs=1,
                             witness=True, loop_plain=WIDER_PLAIN_TURNS,
                             push=ROUTE_PUSH_HOPS * (ROUTE_M // 2),
                             ear_hops=ROUTE_EAR_HOPS,
                             plain_blocks=WIDER_PLAIN_BLOCKS))
    out["paths_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    free_dense_tables()
    torch.cuda.reset_peak_memory_stats(dev)
    out["app"] = station_app_call(dev, card, ROUTE_M)
    out["app"]["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["app"]["reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
    out["launches"]["app"] = out["app"]["launches"]
    out["peak_gb"] = max(out["paths_peak_gb"], out["app"]["peak_gb"])
    log(f"  peak device memory at M={ROUTE_M} (torch.cuda.max_memory_"
        f"allocated): the paths {out['paths_peak_gb']:.2f} GB, the app's "
        f"call {out['app']['peak_gb']:.2f} GB ("
        f"{out['app']['reserved_gb']:.2f} GB reserved at most, the "
        f"allocator's default segments); phase 35 took "
        f"{time.perf_counter() - t0:.1f} s")
    return out


DIGEST_WIDTHS = (8, 1024, 2038, 4098, 8192, 16382, 16384, 32768)


def digest(tree, widths=DIGEST_WIDTHS, Ts=(8, 32)):
    """``--digest TREE``: builds the port of source tree TREE (its own
    ``kernels.build``, with ``-Xptxas -v``, whose register and spill lines
    it prints as ``PTXAS`` lines) and prints ``DIGEST`` and a JSON object:
    the sha256 of each kernel's outputs, by kernel, M and T, on inputs made
    from seeds with numpy (riq and planar, both parities, bf16 and f32
    phases, a carry-in).  Run it on two trees in one call to show that a
    change leaves the kernels' outputs as they were, bit for bit."""
    import hashlib
    sys.path.insert(0, tree)
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import build
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import synth as S
    _, nvcc_log = build.build(("-Xptxas", "-v"), widths=[
        M for M in widths if M not in KA.LIBRARY_WIDTHS])
    for name, usage in ptxas_usage(nvcc_log):
        print(f"PTXAS {name}: {usage}")
    dev, Nh, out = torch.device("cuda", 0), 501, {}
    for M in widths:
        for T in Ts:
            P = M // 2
            rng = np.random.default_rng(M * 1000 + T)

            def rand(*shape):
                return torch.as_tensor(rng.normal(0, 0.5, shape).astype(
                    np.float32), device=dev)

            x, prev = rand((Nh + 2 * T - 1) * P, 2), rand(M, 2)
            Y, carry = rand(Nh, M, 2), rand(M * T - P, 2)
            xp = x.t().contiguous()
            res = {"analysis": [KA.analyze_block(x, M, T, 0),
                                KA.analyze_block(xp, M, T, 1, True, True)],
                   "rx_front": [*R.analyze_demod(x, M, T, 1, prev),
                                *R.analyze_demod(xp, M, T, 0, prev)],
                   "rx_phases": [*K.analyze_phases(x, M, T, 3, 0,
                                                   torch.float32),
                                 *K.analyze_phases(xp, M, T, 3, 1,
                                                   torch.bfloat16)],
                   "synth": [*S.synthesize_block(Y, M, T, 0, carry),
                             *S.synthesize_block(Y, M, T, 1, carry)]}
            torch.cuda.synchronize()
            for k, ts in res.items():
                h = hashlib.sha256()
                for a in ts:
                    h.update(a.float().cpu().numpy().tobytes())
                out[f"{k}/{M}/{T}"] = h.hexdigest()
    print("DIGEST " + json.dumps(out), flush=True)
    return 0


def search_rows(M, sps, nsym, seed):
    """The duplex loop's rows for the trigger search: (M, sps, nsym) bf16
    phase streams of gaussian noise, with one trigger of amplitude 0.8
    added at a random phase and offset of every channel."""
    from amps_tpu_torch.rx.correlator import trigger_template
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.3, (M, sps, nsym)).astype(np.float32)
    tmpl = trigger_template(1)
    p = rng.integers(0, sps, M)
    s0 = rng.integers(0, nsym - len(tmpl) + 1, M)
    for c in range(M):
        x[c, p[c], s0[c]:s0[c] + len(tmpl)] += 0.8 * tmpl
    return torch.as_tensor(x).to(torch.bfloat16)


def search_bound(M, sps, nsym, K):
    """(least ms, what sets it) of the trigger search over M rows: with
    each pair of neighbouring symbols added as one sum or difference (and
    their squares as one sum), each (channel, phase, lag) takes 37 adds
    for the correlation and 37 for the energies, and each symbol 4 more
    (its square and its pair's sum, difference and sum of squares), one
    instruction each at half the f32 flop rate; against the bf16 phases
    read once and the picks written once at 3.35 TB/s."""
    ops = M * sps * ((nsym - 73) * 74 + nsym * 4)
    t_ops = ops / (F32_FLOPS / 2)
    t_bytes = (M * sps * nsym * 2 + M * K * 9) / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# the trigger search's rows (label, M, nsym, K, bf16 quality): the duplex
# loop's at M = 1024 and 16384; the receiver's window of a 1<<22-sample
# push at M = 1024 (its overlap of 10344 hops and 8192 new: 6178
# symbols), with the production spec's bf16 quality and with f32; the
# station app's window of 8388608 samples (8909 symbols)
SEARCH_ROWS = (("loop", 1024, 3703, 2, True), ("loop", 16384, 3703, 2, True),
               ("receiver", 1024, 6178, 4, True),
               ("receiver_f32", 1024, 6178, 4, False),
               ("station_app", 1024, 8909, 4, True))


def phase_trigger_search(dev, card, rows=SEARCH_ROWS, n_timed=10):
    """Phase 36: the trigger search kernel (K5, ``csrc/trigger_search.cu``)
    alone on the rows of its callers (``SEARCH_ROWS``: M channels x 3
    phases, threshold 0.55), on the path ``plan`` takes for them: one
    launch a call, the first pick of every row equal to the plain
    version's (each row's trigger decides it), and its time (CUDA events,
    median of ``n_timed`` turns of KERNEL_REPS calls) beside the plain
    version's and its bound."""
    from amps_tpu_torch.kernels import trigger_search as KS
    from amps_tpu_torch.rx import correlator as cor
    sps, thr = 3, 0.55
    out = {}
    for label, M, nsym, K, bf16 in rows:
        ph = search_rows(M, sps, nsym, seed=M + nsym).to(dev)
        resident, nb = KS.plan(sps, nsym, 128, K, bf16)

        def kernel():
            return cor.find_bursts_phases(ph, sps, K, thr, out_bf16=bf16)

        def plain():
            return cor.find_bursts_phases_reference(ph, sps, K, thr,
                                                    out_bf16=bf16)

        KS.LAUNCHES = 0
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        assert KS.LAUNCHES == 1, KS.LAUNCHES
        first = int((got[0][:, 0] == want[0][:, 0]).sum().item())
        valid = int((got[1] == want[1]).sum().item())
        qerr = (got[2] - want[2]).abs()[want[1]].max().item()
        name = f"{label}_M{M}"
        path = "resident" if resident else f"tiles of {nb} blocks"
        log(f"  {name}: {M} x {sps} x {nsym} symbols, K={K}, "
            f"{'bf16' if bf16 else 'f32'} quality, {path}: first picks "
            f"equal on {first} of {M} rows, valid on {valid} of {M * K}, "
            f"max |quality err| {qerr:.3e} on valid picks")
        assert first == M and valid == M * K and qerr <= 2 ** -8
        t = timed({"kernel": kernel, "plain": plain}, n=n_timed,
                  reps=KERNEL_REPS)
        b, by = search_bound(M, sps, nsym, K)
        log(f"  {name}: kernel {t['kernel']:.4f} ms, plain "
            f"{t['plain']:.4f} ms, bound {b:.4f} ms ({by}): "
            f"{b / t['kernel'] * 100:.1f}% of the bound, on {card}")
        out[name] = {"ms": t["kernel"], "plain_ms": t["plain"],
                     "bound_ms": b, "bound_by": by, "path": path,
                     "first_picks_equal": first, "valid_equal": valid,
                     "max_quality_err": qerr}
        del ph, got, want
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU",
              file=sys.stderr)
        return 1
    from amps_tpu_torch.eval.traffic import synthesize_reverse_band
    from amps_tpu_torch.kernels import build
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import trigger_search as KS
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.rx.correlator import RSSI_BLOCK

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # -- phase 1: build -------------------------------------------------
    stamp("phase 1: build")
    # the main library and phases 12 and 29-33's single-width libraries,
    # one nvcc a source and library, all at once
    t0 = time.perf_counter()
    path, nvcc_log = build.build(("-Xptxas", "-v"), widths=width_libraries())
    log(f"phase 1: built {path.name} and the single-width libraries of M = "
        f"{width_libraries()} in {time.perf_counter() - t0:.1f} s (set-up)")
    for name, usage in ptxas_usage(nvcc_log):
        log(f"  nvcc: {name}: {usage}")

    # -- phase 2: kernel against its plain version ------------------------
    stamp("phase 2: kernel against its plain version")
    T, sps = 8, 3
    log("phase 2: kernel vs plain version (f32, bf16 output)")
    max_err = None
    for M in (1024, 256):
        P = M // 2
        Nh = (1 << 22) // P if M == 1024 else 8192
        n_ext = (Nh + 2 * T - 1) * P
        rng = np.random.default_rng(M)
        noise = torch.as_tensor(
            rng.normal(0, 0.5, (n_ext, 2)).astype(np.float32), device=dev)
        compare_front_end(K, noise, M, T, sps, f"M={M} Nh={Nh} random IQ")
        spec = pl.MultichannelSpec(num_channels=M, taps_per_phase=T,
                                   fold="bank")
        planted = plant_events(M, 7)
        band = synthesize_reverse_band(planted, spec, Nh,
                                       noise_sigma=BAND_SIGMA, device=dev)
        x_ext = torch.cat([torch.zeros((n_ext - Nh * P, 2), device=dev),
                           band]).contiguous()
        err = compare_front_end(K, x_ext, M, T, sps,
                                f"M={M} Nh={Nh} planted band", planted)
        if M == 1024:
            max_err = err
        planar = x_ext.t().contiguous()
        pph, pcp, ppw = K.analyze_phases(planar, M, T, sps, hop0_parity=1)
        rph, rcp, rpw = K.analyze_phases_reference(planar, M, T, sps,
                                                   hop0_parity=1)
        torch.cuda.synchronize()
        perr = (pph - rph).abs()
        prel = max(((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()
                   for a, b in ((ppw, rpw), (pcp, rcp)))
        log(f"  M={M} planar input, odd parity: max|err| "
            f"{perr.max().item():.3e}; pw_blk, chan_power max rel "
            f"{prel:.3e}")
        assert (perr > PHASE_ATOL).double().mean().item() <= \
            BRANCH_CUT_FRACTION
        assert prel <= POWER_RTOL

    # -- phase 3: the slice at full width ----------------------------------
    stamp("phase 3: the slice at full width")
    M, Nh = 1024, 12288
    log(f"phase 3: rx_multichannel_block, M={M}, Nh={Nh} "
        f"({Nh * M // 2} samples), 8 planted bursts")
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    events = plant_events(M, 553)
    x = synthesize_reverse_band(events, prod, Nh, noise_sigma=0.001,
                                device=dev)
    K.LAUNCHES = KS.LAUNCHES = 0
    out = pl.rx_multichannel_block(x, prod, max_bursts=2)
    torch.cuda.synchronize()
    launches, block_search = K.LAUNCHES, KS.LAUNCHES
    log(f"  kernel launches on the main path: {launches}, trigger search "
        f"kernel launches {block_search}")
    assert launches >= 1 and block_search == 1
    expect = check_planted(out, events)

    f32 = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank")
    got = pl.rx_multichannel_block(x, f32, max_bursts=2)
    ref = pl._rx_block(x, f32, 2, 0.55, "first_ok",
                       K.analyze_phases_reference,
                       plain_search)
    torch.cuda.synchronize()
    gv, rv = got["valid"].cpu().numpy(), ref["valid"].cpu().numpy()
    assert np.array_equal(gv, rv) and np.array_equal(gv, expect)
    for key in ("starts", "words", "word_ok", "dcc_bits", "bad_symbols"):
        a, b = got[key].cpu().numpy(), ref[key].cpu().numpy()
        assert np.array_equal(a[gv], b[gv]), key
    idle_diff = int((got["starts"] != ref["starts"]).sum().item())
    log(f"  f32 spec, kernel path vs plain path: valid identical; starts, "
        f"words, word_ok, dcc_bits, bad_symbols identical on every valid "
        f"slot; starts differ on {idle_diff} of {gv.size} noise-only slots")

    # -- phase 4: times -----------------------------------------------------
    stamp("phase 4: times")
    n = 1 << 22
    Nh = n // (M // 2)
    log(f"phase 4: times, n = {n} samples (Nh={Nh}), median of {N_TIMED}, "
        f"CUDA events, on {card}")
    xb = synthesize_reverse_band(plant_events(M, 11), prod, Nh,
                                 noise_sigma=0.001, device=dev)
    blk = timed({
        "kernel": lambda: pl.rx_multichannel_block(xb, prod, max_bursts=2),
        "plain": lambda: pl._rx_block(xb, prod, 2, 0.55, "first_ok",
                                      K.analyze_phases_reference,
                                      plain_search),
    })
    for k, ms in blk.items():
        log(f"  whole block M={M} production spec, {k} path: {ms:.3f} ms, "
            f"{n / ms / 1e3:.1f} Msamples/s")
    profile_window(f"rx_multichannel_block of {n} samples, rx_phases kernel",
                   lambda: pl.rx_multichannel_block(xb, prod, max_bursts=2),
                   dev)
    kernel_ms = {}
    for Mk in (1024, 256):
        P = Mk // 2
        Nhk = n // P
        xe = torch.cat([torch.zeros(((2 * T - 1) * P, 2), device=dev),
                        xb[: Nhk * P]]).contiguous() if Mk == M else \
            torch.randn(((Nhk + 2 * T - 1) * P, 2), device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        fe = timed({
            "kernel": lambda: K.analyze_phases(xe, Mk, T, sps,
                                               out_dtype=torch.bfloat16),
            "plain": lambda: K.analyze_phases_reference(
                xe, Mk, T, sps, out_dtype=torch.bfloat16),
        }, reps=KERNEL_REPS)
        kernel_ms[Mk] = fe
        for k, ms in fe.items():
            log(f"  stages 1-3 M={Mk}, {k}: {ms:.3f} ms, "
                f"{n / ms / 1e3:.1f} Msamples/s")
        # reads the block and its tables; writes the bf16 phases and the
        # 384-hop power means
        nsym = (Nhk - sps + 1) // sps
        fe["bound"], fe["bound_by"] = bound(
            Mk, T, Nhk, nbytes(xe, *K._tables(Mk, T, dev))
            + Mk * sps * nsym * 2 + Mk * -(-Nhk // RSSI_BLOCK) * 4)
        fe["fft"] = fft_ms(Mk, Nhk, dev)
        log(f"  stages 1-3 M={Mk}: bound {fe['bound']:.3f} ms "
            f"({fe['bound_by']}), cuFFT of the plane {fe['fft']:.3f} ms")

    # -- phases 5-9: the streaming duplex ----------------------------------
    stamp("phases 5-9: the streaming duplex")
    synth_err = phase_synth(dev, (1024, 256), T)
    front_err = phase_rx_front(dev, (1024, 256), T)
    tx_launches = phase_tx(dev, M, T)
    assert tx_launches >= 2
    rx_launches, pushes = phase_rx(dev, M, T)
    assert rx_launches == pushes + 1
    times = phase_times(dev, M, T, card)

    # -- phases 10-11: the mobile's ear and the whole call -----------------
    stamp("phases 10-11: the mobile's ear and the whole call")
    from amps_tpu_torch.kernels import analysis as KA
    ana_err, ana_times = phase_analysis(dev, T, card)
    log(f"phase 11: the whole call over channelized RF, M={M}, production "
        f"spec, FOCC on every slot but 3-5, the mobile on reverse slot 3")
    log_k, heard_k, call_launches, _ = phase_call(dev, M, T, profile=True)
    assert call_launches["analysis"] >= 3 and call_launches["synth"] >= 3 \
        and call_launches["rx_front"] >= 1, call_launches
    log_p, heard_p, plain_launches, _ = phase_call(
        dev, M, T, analysis_block=KA.analyze_reference, label="plain ear")
    assert plain_launches["analysis"] == 0
    assert log_p == log_k and heard_p == heard_k
    assert all(len(f) >= 17 for f, _ in heard_k) and heard_k[1][1], \
        [(len(f), len(w)) for f, w in heard_k]
    log(f"  the kernel ear and the plain ear give the identical mob.log, "
        f"decoded FOCC frames and FVC words; analysis kernel launches "
        f"{call_launches['analysis']} on the call")

    # -- phases 12-17: small banks, the closed loop, the batched block, the
    # -- single-channel chains, supervision ---------------------------------
    stamp("phases 12-17: small banks, the closed loop, the batched block, "
          "the single-channel chains, supervision")
    small_err, small_ms = phase_small_widths(dev)
    loop_launches, loop_err = phase_loop_checks(dev, M, T)
    loop = phase_loop_times(dev, M, T, card)
    batched = phase_batched(dev, T, card)
    phase_single_channel(dev)
    sup_launches = phase_supervision(dev, M, T)

    # -- phases 18-20: the station as operators run it ----------------------
    stamp("phases 18-20: the station as operators run it")
    app_launches, app_front_err = phase_station_app(dev, M, card, times)
    phase_ring(dev, M, card)
    phase_entry_points(dev, card)

    # -- phases 21-24: the multi-device station on one card ----------------
    stamp("phases 21-24: the multi-device station on one card")
    mesh = phase_mesh_step(dev, M, T, card)
    mesh_loop = phase_mesh_loop(dev, M, T, card)
    mesh_app = phase_mesh_app(dev, M, card)
    phase_mesh_dryrun(card, M, T)

    # -- phases 25-26: the certification soaks and the paced legs ----------
    stamp("phases 25-26: the certification soaks and the paced legs")
    soak_launches = phase_soaks(dev, card)
    pace_launches, _ = phase_pacing(dev, card)

    # -- phases 27-28: the cross-process station, the entry forward ---------
    stamp("phases 27-28: the cross-process station, the entry forward")
    xl = phase_xproc(card, mesh["reports"], mesh_loop["sums"])
    entry_launches, entry_t = phase_entry(dev, card)

    # -- phase 29: every even width, the station's main path at M=768 -----
    stamp("phase 29: every even width, the station's main path at M=768")
    wd = phase_widths(dev, card)

    # -- phase 30: banks past 2048 channels, the main path at M=4096 ------
    stamp("phase 30: banks past 2048 channels, the main path at M=4096")
    wide = phase_wide(dev, card)

    # -- phase 31: banks past 4096 channels, the main path at M=8192 ------
    stamp("phase 31: banks past 4096 channels, the main path at M=8192")
    widest = phase_widest(dev, card)

    # -- phase 32: filters longer than 16 taps, the main path at T=32 -----
    stamp("phase 32: filters longer than 16 taps, the main path at T=32")
    taps = phase_taps(dev, card)

    # -- phase 33: banks past 8192 channels, the main path at M=16384 -----
    stamp("phase 33: banks past 8192 channels, the main path at M=16384")
    wider = phase_wider(dev, card)

    # -- phase 34: the unsplit widths past 8192, the main path at 16382 ---
    stamp("phase 34: the unsplit widths past 8192 (Bluestein), the main "
          "path at M=16382")
    blue = phase_bluestein(dev, card, wider["rows"])

    # -- phase 35: every other even width, the main path at M=32766 -------
    stamp("phase 35: every other even width through device memory, the "
          "main path at M=32766")
    rt = phase_route(dev, card)

    # -- phase 36: the trigger search kernel alone ------------------------
    stamp("phase 36: the trigger search kernel on the loop's rows")
    search = phase_trigger_search(dev, card)
    log(json.dumps({"trigger_search": {
        "source": "amps_tpu_torch/csrc/trigger_search.cu",
        "replaces": "amps_tpu/rx/correlator.py::find_bursts_phases "
                    "(no Pallas kernel: the banded Toeplitz matmul)",
        # each path driven with the count set to 0 just before it; the
        # loop's are those of one graph run of 32 blocks
        "launches_by_path": {"block": block_search,
                             "receiver": rx_launches,
                             "loop_checks": loop_launches[2],
                             "closed_loop": loop["launches"][2]},
        **search}}))

    def entry(name, replaces, launches, err, t, **more):
        return {"name": name, "route": "cuda",
                "source": f"amps_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["kernel"],
                "plain_ms": t["plain"], "bound_ms": t["bound"],
                "bound_by": t["bound_by"], "library_ms": None,
                "transform": "fft", "fft_ms": t["fft"],
                "small_width_max_abs_err": {
                    str(m): e for m, e in small_err[name].items()},
                "small_width_ms": {
                    str(m): t[0] for m, t in small_ms[name].items()},
                "small_width_plain_ms": {
                    str(m): t[1] for m, t in small_ms[name].items()},
                "widths_max_abs_err": {
                    str(m): e for m, e in wd["errs"][name].items()},
                **{f"widths_{key}_ms": {
                    str(m): r[name][key] for m, r in wd["rows"].items()}
                   for key in ("kernel", "plain", "bound")},
                "widths_fft_ms": {
                    str(m): r["fft"] for m, r in wd["rows"].items()},
                "widths_build_s": wd["build_s"],
                "wide_max_abs_err": {
                    str(m): e for m, e in wide["errs"][name].items()},
                **{f"wide_{key}_ms": {
                    str(m): r[name][key] for m, r in wide["rows"].items()}
                   for key in ("kernel", "plain", "bound")},
                "wide_fft_ms": {
                    str(m): r["fft"] for m, r in wide["rows"].items()},
                "widest_max_abs_err": {
                    str(m): e for m, e in widest["errs"][name].items()},
                **{f"widest_{key}_ms": {
                    str(m): r[name][key] for m, r in widest["rows"].items()}
                   for key in ("kernel", "plain", "bound")},
                "widest_fft_ms": {
                    str(m): r["fft"] for m, r in widest["rows"].items()},
                "widest_max_clusters": {
                    str(m): n[name] for m, n in widest["clusters"].items()},
                "widest_peak_memory_gb": widest["peak_gb"],
                "taps_max_abs_err": {
                    str(m): e for m, e in taps["errs"][name].items()},
                **{f"taps_{key}_ms": {
                    str(t): r[name][key] for t, r in taps["rows"].items()}
                   for key in ("kernel", "plain", "bound")},
                "taps_bound_by": {
                    str(t): r[name]["bound_by"]
                    for t, r in taps["rows"].items()},
                "taps_fft_ms": {
                    str(t): r["fft"] for t, r in taps["rows"].items()},
                "wider_max_abs_err": {
                    str(m): e for m, e in wider["errs"][name].items()},
                "wider_vs_float64": {
                    str(m): {"kernel": e[0], "plain": e[1]}
                    for m, e in wider["f64"].get(name, {}).items()},
                **{f"wider_{key}_ms": {
                    str(m): r[name][key] for m, r in wider["rows"].items()}
                   for key in ("kernel", "plain", "bound")},
                "wider_fft_ms": {
                    str(m): r["fft"] for m, r in wider["rows"].items()},
                "wider_max_clusters": {
                    str(m): n[name] for m, n in wider["clusters"].items()},
                "wider_peak_memory_gb": wider["peak_gb"],
                "bluestein_max_abs_err": {
                    str(m): e for m, e in blue["errs"][name].items()},
                "bluestein_vs_float64": {
                    f"{m}/T{t}": {"kernel": e[0], "plain": e[1]}
                    for key, t in (("f64", 8), ("f64_long",
                                                BLUESTEIN_LONG[1]))
                    for m, e in blue[key].get(name, {}).items()},
                **{f"bluestein_{key}_ms": {
                    str(m): r[name][key] for m, r in blue["rows"].items()}
                   for key in ("kernel", "plain", "bound")},
                "bluestein_fft_ms": {
                    str(m): r["fft"] for m, r in blue["rows"].items()},
                "bluestein_max_clusters": {
                    str(m): n[name] for m, n in blue["clusters"].items()},
                "bluestein_peak_memory_gb": blue["peak_gb"],
                "route_source": "amps_tpu_torch/csrc/route.cu",
                "route_max_abs_err": {
                    str(m): e for m, e in rt["errs"][name].items()},
                "route_vs_float64": {
                    f"{m}/T{t}": {"kernel": e[0], "plain": e[1]}
                    for key, t in (("f64", 8), ("f64_long", ROUTE_LONG[1]))
                    for m, e in rt[key].get(name, {}).items()},
                **{f"route_{key}_ms": {
                    str(m): r[name][key] for m, r in rt["rows"].items()}
                   for key in ("kernel", "plain", "bound")},
                "route_fft_ms": {
                    str(m): r["fft"] for m, r in rt["rows"].items()},
                "route_beside_ms": {
                    str(ROUTE_BESIDE): rt["beside"][name]["kernel"]},
                "route_launches_per_call": {
                    f"M={m},Nh={nh}": n[name]
                    for (m, nh), n in rt["launches_seen"].items()},
                "route_peak_memory_gb": rt["peak_gb"],
                **more}

    # the one-shot block (K3) at T=8 and T=32 on one band
    k3_more = {"taps_block_ms": {str(t): v[0] for t, v in
                                 taps["block_by_t"].items()},
               "taps_block_busy_ms": {str(t): v[1] for t, v in
                                      taps["block_by_t"].items()}}

    assert loop_launches == (4, 4, 4) and loop["launches"] == (32, 32, 32)

    # each at the shape its main path hands it: a superframe for the
    # analysis (the ear) and synth (next_block) kernels, a 1<<22-sample
    # block for rx_phases and rx_front
    print(json.dumps({"kernels": [
        entry("analysis", "amps_tpu/pallas/channelizer_kernel.py:151",
              call_launches["analysis"], max(ana_err.values()),
              ana_times[M, 50004],
              launches_by_path={"call": call_launches["analysis"],
                                "sharded_step": mesh["launches"][0],
                                "sharded_loop": mesh_loop["launches"][0],
                                "mesh_app": mesh_app[0],
                                "xproc_step": xl["step_launches"][0],
                                "xproc_loop": xl["loop_launches"][0],
                                "m768_analyze": wd["launches"]["analysis"],
                                "m4096_analyze":
                                    wide["launches"]["analysis"],
                                "m8192_analyze":
                                    widest["launches"]["analysis"],
                                "m16384_analyze":
                                    wider["launches"]["analysis"],
                                "m16382_analyze":
                                    blue["launches"]["analysis"],
                                "m32766_analyze":
                                    rt["launches"]["analysis"],
                                "t32_analyze": taps["launches"]["analysis"],
                                "t32_sharded_step":
                                    taps["launches"]["sharded_step"][0],
                                **{f"soak_{k}": n["analysis"]
                                   for k, n in soak_launches.items()
                                   if n["analysis"]}},
              sharded_max_abs_err=mesh["analysis_err"],
              sharded_ms=mesh["analysis"],
              sharded_plain_ms=mesh["analysis_plain"],
              sharded_bound_ms=mesh["analysis_bound"],
              bluestein_probe_clusters={
                  str(b): n for b, n in blue["probe"].items()}),
        # launches_by_path: each path driven with the count set to 0 just
        # before it; the loop's are those of one graph run of 32 blocks,
        # loop_graph_spans the kernel's spans the profiler saw in such a run
        entry("rx_phases", "amps_tpu/pallas/rx_phases_kernel.py:223",
              launches, max_err, kernel_ms[1024],
              launches_by_path={"block": launches,
                                "batched_block": batched["launches"],
                                "entry": entry_launches,
                                "m768_block": wd["launches"]["block"],
                                "m4096_block": wide["launches"]["block"],
                                "m8192_block": widest["launches"]["block"],
                                "m16384_block": wider["launches"]["block"],
                                "m16382_block": blue["launches"]["block"],
                                "m32766_block": rt["launches"]["block"],
                                "t32_block": taps["launches"]["block"]},
              entry_ms=entry_t["kernel"], entry_plain_ms=entry_t["plain"],
              **k3_more,
              batched_max_abs_err=batched["err"],
              batched_ms=batched["one_launch"],
              batched_g_launches_ms=batched["g_launches"],
              batched_plain_ms=batched["plain"],
              batched_bound_ms=batched["bound"]),
        entry("rx_front", "amps_tpu/pallas/rx_front_kernel.py:184",
              rx_launches, front_err[1024], times["rx_front"],
              launches_by_path={"receiver": rx_launches,
                                "closed_loop": loop["launches"][1],
                                "m768_receiver": wd["launches"]["receiver"],
                                "m768_closed_loop": wd["launches"]["loop"][1],
                                "m4096_receiver":
                                    wide["launches"]["receiver"],
                                "m4096_closed_loop":
                                    wide["launches"]["loop"][1],
                                "m4096_station_app":
                                    wide["launches"]["app"][1],
                                "m8192_receiver":
                                    widest["launches"]["receiver"],
                                "m8192_closed_loop":
                                    widest["launches"]["loop"][1],
                                "m8192_station_app":
                                    widest["launches"]["app"][1],
                                "m16384_receiver":
                                    wider["launches"]["receiver"],
                                "m16384_closed_loop":
                                    wider["launches"]["loop"][1],
                                "m16384_station_app":
                                    wider["launches"]["app"][1],
                                "m16382_receiver":
                                    blue["launches"]["receiver"],
                                "m16382_closed_loop":
                                    blue["launches"]["loop"][1],
                                "m16382_station_app":
                                    blue["launches"]["app"][1],
                                "m32766_receiver":
                                    rt["launches"]["receiver"],
                                "m32766_closed_loop":
                                    rt["launches"]["loop"][1],
                                "m32766_station_app":
                                    rt["launches"]["app"][1],
                                "t32_receiver": taps["launches"]["receiver"],
                                "t32_loop": taps["launches"]["loop"][1],
                                "supervision": sup_launches,
                                "station_app": app_launches[1],
                                **{f"soak_{k}": n["rx_front"]
                                   for k, n in soak_launches.items()
                                   if n["rx_front"]},
                                **{f"pacing_{k}": n["rx_front"]
                                   for k, n in pace_launches.items()}},
              station_app_max_abs_err=app_front_err,
              loop_graph_spans=loop["rx_front_spans"],
              loop_max_abs_err=max(loop["rx_front_err"],
                                   loop_err["rx_front"]),
              loop_ms=loop["rx_front"], loop_in_graph_ms=loop["rx_front_dev"],
              loop_block_ms=loop["graph"],
              loop_plain_ms=loop["rx_front_plain"],
              loop_bound_ms=loop["rx_front_bound"]),
        entry("synth", "amps_tpu/pallas/synthesizer_kernel.py:128",
              tx_launches, synth_err[1024], times["synth_sf"],
              launches_by_path={"transmitter": tx_launches,
                                "closed_loop": loop["launches"][0],
                                "m768_transmitter":
                                    wd["launches"]["transmitter"],
                                "m768_closed_loop": wd["launches"]["loop"][0],
                                "m4096_transmitter":
                                    wide["launches"]["transmitter"],
                                "m4096_closed_loop":
                                    wide["launches"]["loop"][0],
                                "m4096_station_app":
                                    wide["launches"]["app"][0],
                                "m8192_transmitter":
                                    widest["launches"]["transmitter"],
                                "m8192_closed_loop":
                                    widest["launches"]["loop"][0],
                                "m8192_station_app":
                                    widest["launches"]["app"][0],
                                "m16384_transmitter":
                                    wider["launches"]["transmitter"],
                                "m16384_closed_loop":
                                    wider["launches"]["loop"][0],
                                "m16384_station_app":
                                    wider["launches"]["app"][0],
                                "m16382_transmitter":
                                    blue["launches"]["transmitter"],
                                "m16382_closed_loop":
                                    blue["launches"]["loop"][0],
                                "m16382_station_app":
                                    blue["launches"]["app"][0],
                                "m32766_transmitter":
                                    rt["launches"]["transmitter"],
                                "m32766_closed_loop":
                                    rt["launches"]["loop"][0],
                                "m32766_station_app":
                                    rt["launches"]["app"][0],
                                "t32_transmitter":
                                    taps["launches"]["transmitter"],
                                "t32_loop": taps["launches"]["loop"][0],
                                "t32_sharded_step":
                                    taps["launches"]["sharded_step"][1],
                                "station_app": app_launches[0],
                                "sharded_step": mesh["launches"][1],
                                "sharded_loop": mesh_loop["launches"][1],
                                "mesh_app": mesh_app[1],
                                "xproc_step": xl["step_launches"][1],
                                "xproc_loop": xl["loop_launches"][1],
                                "pacing_fdx": pace_launches["fdx"]["synth"],
                                "pacing_fdx1": pace_launches["fdx1"]["synth"]},
              sharded_max_abs_err=mesh["synth_err"],
              sharded_ms=mesh["synth"], sharded_plain_ms=mesh["synth_plain"],
              sharded_bound_ms=mesh["synth_bound"],
              loop_graph_spans=loop["synth_spans"],
              loop_max_abs_err=max(loop["synth_err"], loop_err["synth"]),
              loop_ms=loop["synth"], loop_in_graph_ms=loop["synth_dev"],
              loop_plain_ms=loop["synth_plain"],
              loop_bound_ms=loop["synth_bound"]),
    ]}), flush=True)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--digest"]:
        sys.exit(digest(sys.argv[2]))
    if sys.argv[1:2] == ["--xproc-worker"]:
        sys.exit(xproc_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                              int(sys.argv[5])))
    sys.exit(main())
