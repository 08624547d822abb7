"""GPU smoke run of the PyTorch/CUDA port.  It builds the four CUDA
kernels of the ported paths (rx_phases, rx_front, synth, analysis),
holds each against its plain PyTorch version at M=1024 and 256 and at
the small banks M=8, 16 and 32, drives the 1024-channel receive block,
the station's streaming duplex -- MultichannelTransmitter superframes
read back through the rx_phases kernel, and planted bursts streamed
through MultichannelReceiver --, a whole call over channelized RF
(BaseStation, the transmitter, the mobile simulator's ear on the
analysis kernel, its RECC bursts through the receiver), the fused TX->RX
closed loop under a CUDA graph (synth + rx_front once a block), the
batched small-bank block (rx_phases with a band axis), the
single-channel TX and RX chains and the receiver's voice supervision,
and the station as operators run it -- the BS-in-a-box app through the
CLI (synth on its TX thread, rx_front on its RX thread), the executor
over the native ring, the link-quality curve, the capture monitor and
the demo; and times kernels and paths against their plain versions,
their bounds and a cuFFT yardstick, with profiler windows of one
one-shot block, one receiver push, one transmitter superframe, one
superframe of the ear, one run of the closed loop and one run of the
app.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Every check raises on failure.  The last line of standard output is a
JSON object naming the device; the line before it lists each kernel of
the paths with its launches on its main path, its error against the
plain version, both times, its bound (the least time of the function:
an FFT-sized transform and the fold or overlap-add against the bytes
moved), its transform ("fft": all four run the all-channel FFT tile),
the cuFFT time of its transform alone, its error at the small banks and
its launches and times on the closed loop or the batched block.  Without
a CUDA card it exits non-zero.
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


def log(*a):
    print(*a, flush=True)


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


def plant_events(M: int, seed: int):
    """8 bursts: channels 0, 1, 2 (adjacent), M/2-1, M/2, M-1 and two
    more, 2..7 random 36-bit info words each, DCC 0."""
    from amps_tpu_torch.eval.traffic import BurstEvent
    rng = np.random.default_rng(seed)
    chans = [0, 1, 2, M // 2 - 1, M // 2, M - 1, M // 4 + 3, 3 * M // 4 - 5]
    events = []
    for c in chans:
        nw = int(rng.integers(2, 8))
        words = rng.integers(0, 2, (nw, 36)).astype(np.uint8)
        events.append(BurstEvent(c, int(rng.integers(100, 1800)), words))
    return events


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


def compare_synth(S, M, T, Nh, dev, seed):
    """Synthesis kernel vs plain version on random channel basebands
    with a nonzero carry-in, both hop parities, and two chained calls vs
    one; errors relative to the output RMS.  Returns the max abs error."""
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
        log(f"  synth M={M} Nh={Nh} parity {parity}: max|err| {ex:.3e} "
            f"({ex / rms:.2e} of RMS), carry {ec:.3e} ({ec / rms:.2e})")
        assert torch.isfinite(x).all() and torch.isfinite(c).all()
        assert ex <= SYNTH_RTOL * rms and ec <= SYNTH_RTOL * rms
        max_abs = max(max_abs, ex, ec)
    h = Nh // 2 + 1
    xa, ca = S.synthesize_block(Y[:h].contiguous(), M, T, 0, carry)
    xb, cb = S.synthesize_block(Y[h:].contiguous(), M, T, h % 2, ca)
    x, c = S.synthesize_block(Y, M, T, 0, carry)
    sync(dev)
    e = max((torch.cat([xa, xb]) - x).abs().max().item(),
            (cb - c).abs().max().item()) / x.pow(2).mean().sqrt().item()
    log(f"  synth M={M}: two chained calls vs one, max|err| {e:.2e} of RMS")
    assert e <= SYNTH_RTOL
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
    stream does."""
    from amps_tpu_torch.eval.traffic import BurstEvent
    rng = np.random.default_rng(seed)
    chans = [0, 1, M // 2 - 1, M // 2, M - 1, 200 % M, 700 % M, 3, 900 % M,
             64 % M]
    starts = [300, 5000, 9001, 12002, 15000, 20001, 26002, 30000, 34001,
              total_hops - 4 - BURST_HOPS]
    return [BurstEvent(c, h, rng.integers(0, 2, (int(rng.integers(2, 8)),
                                                 36)).astype(np.uint8))
            for c, h in zip(chans, starts)]


def stream_reports(MR, spec, blocks, front_end=None, depth=2,
                   pad_tail=True):
    """Report list of one receiver over the blocks, flushed.  The
    receiver is built without a device, so it lives on the card, where
    the blocks are."""
    kw = {} if front_end is None else {"front_end": front_end}
    rx = MR(spec, pipeline_depth=depth, **kw)
    reps = []
    for b in blocks:
        reps += rx.push(b)
    assert rx.device == blocks[0].device, (rx.device, blocks[0].device)
    return reps + rx.flush(pad_tail=pad_tail)


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


def phase_tx(dev, M, T, n_random=60):
    """Phase 7: MultichannelTransmitter, all M channels FOCC, a page on
    channel 1; two superframes through the synth kernel, held against
    the plain synthesis and read back through the rx_phases kernel.
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
    tx_plain = MultichannelTransmitter(
        prod, device=dev, synthesize=S.synthesize_block_reference)
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
        log(f"  superframe {i}: {tuple(x.shape)}, max|err| vs plain "
            f"synthesis {e:.3e} ({e / peak:.2e} of the peak, {e / rms:.2e} "
            f"of RMS)")
        assert torch.isfinite(x).all() and e <= TX_PEAK_RTOL * peak
    mirror.next_word_pairs()
    want = {c: focc_frame_bits(FoccStream(sps=sps).next_word_pairs())
            for c in range(M)}
    want[1] = focc_frame_bits(mirror.next_word_pairs())
    rng = np.random.default_rng(M)
    fixed = [0, 1, M // 2 - 1, M // 2, M - 1]
    others = [int(c) for c in rng.permutation(M) if c not in fixed]
    chans = fixed + others[:n_random]
    band = torch.cat(xs + [tx._state.carry])
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
    multiple of M/2; flush(pad_tail=True) completes the last burst.
    Returns (rx_front launches, pushes)."""
    from amps_tpu_torch.eval.traffic import synthesize_reverse_band
    from amps_tpu_torch.kernels import rx_front as R
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
    R.LAUNCHES = 0
    reps = stream_reports(MultichannelReceiver, prod, blocks)
    sync(dev)
    launches = R.LAUNCHES
    log(f"  rx_front kernel launches on the main path: {launches} "
        f"({len(blocks)} pushes + the pad_tail push)")
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
                           front_end=R.analyze_demod_reference)
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
               prod, device=dev, front_end=R.analyze_demod_reference)}
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=config) as prof:
        # the first launch after the profiler starts may go unrecorded (a
        # window that opens on a hand-written kernel lost its span in some
        # runs): spend it on a fill, and count what starts in the window
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
        f"profiler), idle share {1 - busy / wall:.1%}")
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
                                  block=analysis_block)
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


REAL_TIME_MSPS = 30.72      # a 1024-channel band, Msamples/s
BATCH_ATOL = 1e-2           # batched vs single band: bf16 quality (one
                            # bf16 step near 1 is 4e-3), f32 rssi, chan_power
LOOP_QUALITY_ATOL = 2e-3    # quality_max, kernel path vs plain path (f32
                            # planes; bf16 planes round it to ~4e-3 steps)


ATAN_SEAM = 0.0417          # fast_atan2's step where |im| = |re|: its
                            # polynomial reads 0.76457 at z = 1, pi/4 - 0.02083


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


def phase_small_widths(dev, Nh=4001):
    """Phase 12: the four kernels against their plain versions at the
    small banks M = 8, 16, 32 (the station app's default bank is 8
    channels), T = 4 and 8, both parities, riq and planar where the
    kernel takes both, two chained calls against one, at the bounds the
    wide widths meet; then each kernel's time at these widths, Nh=8192,
    T=8.  Returns ({kernel: {M: max abs error}}, {kernel: {M: (kernel ms,
    plain ms)}})."""
    from amps_tpu_torch.eval.traffic import unit_channel_band
    from amps_tpu_torch.kernels import analysis as KA
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.rx.correlator import window_power_blocks
    log(f"phase 12: the small banks, M = 8, 16, 32 (T = 4 and 8, both "
        f"parities, riq and planar, chained = one), Nh={Nh}")
    errs = {k: {} for k in ("analysis", "rx_front", "rx_phases", "synth")}
    n1 = Nh // 2 + 1
    for M in (8, 16, 32):
        P = M // 2
        e1 = e2 = e3 = e4 = 0.0
        for T in (4, 8):
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
                    e2 = max(e2, (d - rd)[:, skip:].abs().max().item())
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
                        e = (ph.float() - rph)[..., js:].abs().max().item()
                        assert e <= tol, (M, T, parity, planar, dt, e)
                        if dt == torch.float32:
                            e3 = max(e3, e)
                        rel = ((pb - rpb).abs() / rpb)[:, 1:].max().item()
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
            e4 = max(e4, compare_synth(S, M, T, Nh, dev, M + T))
        for name, e in zip(errs, (e1, e2, e3, e4)):
            errs[name][M] = e
        log(f"  M={M}: max|err| analysis {e1:.3e}, rx_front demod {e2:.3e}, "
            f"rx_phases {e3:.3e}, synth {e4:.3e}; K1 and K2 chained calls "
            f"equal one bit for bit")
    ms = {k: {} for k in errs}
    T, Nt = 8, 8192
    for M in (8, 16, 32):
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
    for M in (12, 48):       # not a power of two: still refused
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


def phase_loop_checks(dev, M, T, nblocks=4, frames=2):
    """Phase 13: the fused closed loop.  Graph = eager bit for bit; the
    kernel path against the plain path; a planted reverse burst across
    the boundary of blocks 1 and 2.  Returns ((K4, K2) launches of the
    graph run, {kernel: max abs error against the plain path's state})."""
    from amps_tpu_torch.dsp.fm import fm_modulate_symbols
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime import streamer as st
    from amps_tpu_torch.tx import recc_ms
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
    S.LAUNCHES = R.LAUNCHES = 0
    got = graphed(wp)
    sync(dev)
    launches = (S.LAUNCHES, R.LAUNCHES)
    S.LAUNCHES = R.LAUNCHES = 0
    want = eager(wp)
    sync(dev)
    assert launches == (S.LAUNCHES, R.LAUNCHES) == (nblocks, nblocks), \
        (launches, S.LAUNCHES, R.LAUNCHES)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), (got, want)
    nv, q, wok = int(got[0]), float(got[1]), int(got[2])
    log(f"  graph (one block a replay) = eager, bit for bit: n_valid {nv}, "
        f"quality_max {q:.4f}, n_word_ok {wok}; synth and rx_front "
        f"launches {launches}, one a block in both")
    assert nv == 0 and np.isfinite(q) and q < 0.55, (nv, q)
    f32 = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank")
    kern = st.make_closed_loop_stream(f32, nblocks, frames, graph=False)[0](wp)
    S.LAUNCHES = R.LAUNCHES = 0
    plain = st.make_closed_loop_stream(
        f32, nblocks, frames, graph=False,
        synthesize=S.synthesize_block_reference,
        front_end=R.analyze_demod_reference)[0](wp)
    sync(dev)
    assert (S.LAUNCHES, R.LAUNCHES) == (0, 0)
    dq = abs(float(kern[1]) - float(plain[1]))
    log(f"  f32 spec, kernel path vs plain path (eager): n_valid "
        f"{int(kern[0])} / {int(plain[0])}, quality_max {float(kern[1]):.5f} "
        f"/ {float(plain[1]):.5f} (|diff| {dq:.2e}), n_word_ok "
        f"{int(kern[2])} / {int(plain[2])} (every candidate slot counts: "
        f"the periodic FOCC band ties its argmax)")
    assert int(kern[0]) == int(plain[0]) == 0
    assert float(kern[1]) < 0.55 and dq <= LOOP_QUALITY_ATOL

    # the same two paths block by block, slot by slot and sample by sample
    from amps_tpu_torch.dsp.fm import fsk_manchester_baseband
    from amps_tpu_torch.tx.focc import focc_frame_bits
    Y0 = fsk_manchester_baseband(
        focc_frame_bits(torch.as_tensor(wp, device=dev)), prod.chan_sps,
        prod.fm_sensitivity)[0].transpose(0, 1).contiguous()
    sk, sp = (st.closed_loop_state0(f32, frames, dev) for _ in range(2))
    skip = 2 * T + 2                   # hops of the banks' ramp-up, block 0
    loop_err = {"synth": 0.0, "rx_front": 0.0}
    agree = differ = wok_k = wok_p = on_seam = 0
    tie = 0.0
    for b in range(nblocks):
        sk, pk = st.closed_loop_block(Y0, sk, f32)
        sp, pp = st.closed_loop_block(
            Y0, sp, f32, synthesize=S.synthesize_block_reference,
            front_end=R.analyze_demod_reference)
        # hist is the tail of the synthesized band, carry the whole of the
        # block's demod plane (carry_hops = n_hops): every sample of both
        rms = sp["hist"].pow(2).mean().sqrt().item()
        for key in ("hist", "syn_carry"):
            e = (sk[key] - sp[key]).abs().max().item()
            loop_err["synth"] = max(loop_err["synth"], e)
            assert e <= SYNTH_RTOL * rms, (b, key, e, rms)
        lo = skip if b == 0 else 0
        e, n = demod_err(sk["carry"][:, lo:], sp["carry"][:, lo:])
        loop_err["rx_front"] = max(loop_err["rx_front"], e)
        on_seam += n
        e = ((sk["prev"] - sp["prev"]).abs().max()
             / sp["prev"].pow(2).mean().sqrt()).item()
        assert e <= LAST_RTOL, (b, e)
        assert not pk["valid"].any() and not pp["valid"].any()
        same = pk["starts"] == pp["starts"]
        agree += int(same.sum())
        differ += int((~same).sum())
        # where both paths pick the same start, the slot is the same slot
        assert torch.equal(pk["word_ok"][same], pp["word_ok"][same]), b
        assert torch.equal(pk["words"][same], pp["words"][same]), b
        qk, qp = pk["quality"].float(), pp["quality"].float()
        assert ((qk - qp).abs()[same] <= LOOP_QUALITY_ATOL).all(), b
        # where they differ it is an argmax tie: the best candidate of a
        # channel (slot 0) has the same quality on both paths
        dq0 = (qk - qp).abs()[:, 0][~same[:, 0]]
        if dq0.numel():
            tie = max(tie, dq0.max().item())
        wok_k += int(pk["word_ok"].sum())
        wok_p += int(pp["word_ok"].sum())
    assert carry_hops == n_hops and tie <= LOOP_QUALITY_ATOL, tie
    assert (wok_k, wok_p) == (int(kern[2]), int(plain[2]))
    log(f"  the two paths block by block: the synthesized band's tail and "
        f"carry max|err| {loop_err['synth']:.3e} "
        f"({loop_err['synth'] / rms:.2e} of RMS <= {SYNTH_RTOL}), every "
        f"demod sample max|err| {loop_err['rx_front']:.3e} <= {PHASE_ATOL} "
        f"({on_seam} on fast_atan2's octant seam); starts agree on {agree} "
        f"of {agree + differ} "
        f"slots, and there words, word_ok are identical and quality within "
        f"{LOOP_QUALITY_ATOL}; they differ on {differ}, and where a "
        f"channel's best candidate does, its quality on the two paths "
        f"differs by at most {tie:.2e}: a tie between repeats of the "
        f"periodic FOCC pattern, so n_word_ok sums other slots")

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
    S.LAUNCHES = R.LAUNCHES = 0
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
    assert (S.LAUNCHES, R.LAUNCHES) == (nblocks, nblocks)
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


def phase_loop_times(dev, M, T, card, nblocks=32, frames=2, n_runs=5):
    """Phase 14: the closed loop's times.  Graph against eager and the
    kernel path against the plain path, interleaved in one process, CUDA
    events around whole runs; a profiler window of one graph run.
    Returns a dict of the readings."""
    from amps_tpu_torch.kernels import rx_front as R
    from amps_tpu_torch.kernels import synth as S
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.runtime import streamer as st
    from amps_tpu_torch.rx.correlator import window_power_blocks
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    n_hops, block_samples, _ = st.closed_loop_geometry(prod, frames)
    wp = loop_pairs(M, frames, seed=0)
    log(f"phase 14: closed loop times, M={M}, nblocks={nblocks}, "
        f"frames={frames} ({nblocks * block_samples / 1e6:.1f} Msamples, "
        f"{nblocks * block_samples / REAL_TIME_MSPS / 1e6:.2f} s of band a "
        f"run), median of {n_runs} runs, CUDA events, on {card}")
    runs = {
        "graph": st.make_closed_loop_stream(prod, nblocks, frames)[0],
        "eager": st.make_closed_loop_stream(prod, nblocks, frames,
                                            graph=False)[0],
        "plain": st.make_closed_loop_stream(
            prod, nblocks, frames, graph=False,
            synthesize=S.synthesize_block_reference,
            front_end=R.analyze_demod_reference)[0],
    }
    S.LAUNCHES = R.LAUNCHES = 0
    res = runs["graph"](wp)
    sync(dev)
    warm = (S.LAUNCHES, R.LAUNCHES)          # + the warm-up block
    S.LAUNCHES = R.LAUNCHES = 0
    res = runs["graph"](wp)
    sync(dev)
    launches = (S.LAUNCHES, R.LAUNCHES)
    assert launches == (nblocks, nblocks) and warm == (nblocks + 1,) * 2
    assert np.isfinite(float(res[1])) and 0 <= int(res[0]) <= 2 * M * nblocks
    log(f"  random word pairs on every channel: n_valid {int(res[0])}, "
        f"quality_max {float(res[1]):.4f}, n_word_ok {int(res[2])}")
    t = timed({k: (lambda f=f: f(wp)) for k, f in runs.items()}, n_runs)
    out = {"launches": launches}
    for k, ms in t.items():
        per = ms / nblocks
        msps = block_samples / per / 1e3
        out[k] = per
        log(f"  {k}: {ms:.2f} ms a run, {per:.3f} ms a block, {msps:.1f} "
            f"Msamples/s, {msps / REAL_TIME_MSPS:.1f}x real time")
    log(f"  graph vs eager {out['eager'] / out['graph']:.3f}x, kernel path "
        f"vs plain path (eager) {out['plain'] / out['eager']:.3f}x")
    busy, wall, ops = profile_window(
        f"one run of the closed loop under the graph ({nblocks} blocks)",
        lambda: runs["graph"](wp), dev, top=8)
    out["busy"], out["wall"] = busy / nblocks, wall / nblocks
    # the launches run adds for its replays, held to the kernel spans the
    # profiler saw on the card in that graph run
    for key, pat in (("synth", "synth_kernel"),
                     ("rx_front", "rx_front_kernel")):
        ms = sum(v for k, (v, _) in ops.items() if pat in k) / nblocks
        calls = sum(c for k, (_, c) in ops.items() if pat in k)
        out[key + "_dev"], out[key + "_spans"] = ms, calls
        log(f"  {pat} inside the graph: {calls} spans in the run, {ms:.3f} "
            f"ms a block ({ms / (busy / nblocks):.1%} of the device time)")
        assert calls == nblocks, (pat, calls)
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
    k = timed({
        "synth": lambda: S.synthesize_block(Y, M, T, 0, carry),
        "synth_plain": lambda: S.synthesize_block_reference(Y, M, T, 0,
                                                            carry),
        "rx_front": lambda: R.analyze_demod(x_ext, M, T, 0, prev),
        "rx_front_plain": lambda: R.analyze_demod_reference(
            x_ext, M, T, 0, prev),
    }, 10, KERNEL_REPS)
    out.update(k)
    out["synth_bound"], _ = bound(
        M, T, n_hops, 2 * nbytes(carry) + nbytes(Y) + n_hops * P * 8)
    out["rx_front_bound"], _ = bound(
        M, T, n_hops, nbytes(x_ext, prev, *R._tables(M, T, dev))
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
                                      K.analyze_phases_reference),
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU",
              file=sys.stderr)
        return 1
    from amps_tpu_torch.eval.traffic import synthesize_reverse_band
    from amps_tpu_torch.kernels import build
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.parallel import pipeline as pl
    from amps_tpu_torch.rx.correlator import RSSI_BLOCK

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # -- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    path, nvcc_log = build.build(("-Xptxas", "-v"))
    log(f"phase 1: built {path.name} in {time.perf_counter() - t0:.1f} s "
        f"(set-up)")
    for name, usage in ptxas_usage(nvcc_log):
        log(f"  nvcc: {name}: {usage}")

    # -- phase 2: kernel against its plain version ------------------------
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
    M, Nh = 1024, 12288
    log(f"phase 3: rx_multichannel_block, M={M}, Nh={Nh} "
        f"({Nh * M // 2} samples), 8 planted bursts")
    prod = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank",
                               io_bf16=True, corr_bf16=True,
                               transform_bf16=True)
    events = plant_events(M, 553)
    x = synthesize_reverse_band(events, prod, Nh, noise_sigma=0.001,
                                device=dev)
    K.LAUNCHES = 0
    out = pl.rx_multichannel_block(x, prod, max_bursts=2)
    torch.cuda.synchronize()
    launches = K.LAUNCHES
    log(f"  kernel launches on the main path: {launches}")
    assert launches >= 1
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

    f32 = pl.MultichannelSpec(num_channels=M, taps_per_phase=T, fold="bank")
    got = pl.rx_multichannel_block(x, f32, max_bursts=2)
    ref = pl._rx_block(x, f32, 2, 0.55, "first_ok",
                       K.analyze_phases_reference)
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
    n = 1 << 22
    Nh = n // (M // 2)
    log(f"phase 4: times, n = {n} samples (Nh={Nh}), median of {N_TIMED}, "
        f"CUDA events, on {card}")
    xb = synthesize_reverse_band(plant_events(M, 11), prod, Nh,
                                 noise_sigma=0.001, device=dev)
    blk = timed({
        "kernel": lambda: pl.rx_multichannel_block(xb, prod, max_bursts=2),
        "plain": lambda: pl._rx_block(xb, prod, 2, 0.55, "first_ok",
                                      K.analyze_phases_reference),
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
    synth_err = phase_synth(dev, (1024, 256), T)
    front_err = phase_rx_front(dev, (1024, 256), T)
    tx_launches = phase_tx(dev, M, T)
    assert tx_launches >= 2
    rx_launches, pushes = phase_rx(dev, M, T)
    assert rx_launches == pushes + 1
    times = phase_times(dev, M, T, card)

    # -- phases 10-11: the mobile's ear and the whole call -----------------
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
    small_err, small_ms = phase_small_widths(dev)
    loop_launches, loop_err = phase_loop_checks(dev, M, T)
    loop = phase_loop_times(dev, M, T, card)
    batched = phase_batched(dev, T, card)
    phase_single_channel(dev)
    sup_launches = phase_supervision(dev, M, T)

    # -- phases 18-20: the station as operators run it ----------------------
    app_launches, app_front_err = phase_station_app(dev, M, card, times)
    phase_ring(dev, M, card)
    phase_entry_points(dev, card)

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
                **more}

    assert loop_launches == (4, 4) and loop["launches"] == (32, 32)

    # each at the shape its main path hands it: a superframe for the
    # analysis (the ear) and synth (next_block) kernels, a 1<<22-sample
    # block for rx_phases and rx_front
    print(json.dumps({"kernels": [
        entry("analysis", "amps_tpu/pallas/channelizer_kernel.py:151",
              call_launches["analysis"], max(ana_err.values()),
              ana_times[M, 50004],
              launches_by_path={"call": call_launches["analysis"]}),
        # launches_by_path: each path driven with the count set to 0 just
        # before it; the loop's are those of one graph run of 32 blocks,
        # loop_graph_spans the kernel's spans the profiler saw in such a run
        entry("rx_phases", "amps_tpu/pallas/rx_phases_kernel.py:223",
              launches, max_err, kernel_ms[1024],
              launches_by_path={"block": launches,
                                "batched_block": batched["launches"]},
              batched_max_abs_err=batched["err"],
              batched_ms=batched["one_launch"],
              batched_g_launches_ms=batched["g_launches"],
              batched_plain_ms=batched["plain"],
              batched_bound_ms=batched["bound"]),
        entry("rx_front", "amps_tpu/pallas/rx_front_kernel.py:184",
              rx_launches, front_err[1024], times["rx_front"],
              launches_by_path={"receiver": rx_launches,
                                "closed_loop": loop["launches"][1],
                                "supervision": sup_launches,
                                "station_app": app_launches[1]},
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
                                "station_app": app_launches[0]},
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
    sys.exit(main())
