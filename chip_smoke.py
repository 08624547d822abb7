"""GPU smoke run of the PyTorch/CUDA port.  It builds the three CUDA
kernels of the ported path (rx_phases, rx_front, synth), holds each
against its plain PyTorch version at M=1024 and 256, drives the
1024-channel receive block and the station's streaming duplex end to
end -- MultichannelTransmitter superframes read back through the
rx_phases kernel, and planted bursts streamed through
MultichannelReceiver -- and times kernels and paths against their plain
versions.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Every check raises on failure.  The last line of standard output is a
JSON object naming the device; the line before it lists each kernel of
the path with its launches on the main path, its error against the
plain version and both times.  Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import json
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


def timed(fns, n=N_TIMED):
    """Median ms of each callable, interleaved in turns, CUDA events."""
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(n):
        for k, f in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            torch.cuda.synchronize()
            times[k].append(a.elapsed_time(b))
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
    receiver is built without a device, as a caller that hands it blocks
    on the card would: it must place itself there."""
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
    }, n_timed)}
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
    }, n_timed)
    rxs = {"kernel": MultichannelReceiver(prod, device=dev),
           "plain": MultichannelReceiver(
               prod, device=dev, front_end=R.analyze_demod_reference)}
    out["push"] = timed({k: (lambda r=r: r.push(xb)) for k, r in rxs.items()},
                        n_timed)
    txs = {"kernel": MultichannelTransmitter(prod, device=dev),
           "plain": MultichannelTransmitter(
               prod, device=dev, synthesize=S.synthesize_block_reference)}
    out["next_block"] = timed({k: t.next_block for k, t in txs.items()},
                              max(3, n_timed // 3))
    n_sf = 18 * 463 * 2 * 3 * P
    for name, label, samples in (
            ("synth", f"synth kernel, Nh={Nh}", Nh * P),
            ("rx_front", f"rx_front kernel, Nh={Nh}", n),
            ("push", f"MultichannelReceiver.push of {n} samples, depth 1",
             n),
            ("next_block", "MultichannelTransmitter.next_block, one "
             "superframe, all channels", n_sf)):
        for k, ms in out[name].items():
            log(f"  {label}, {k}: {ms:.3f} ms, "
                f"{samples / ms / 1e3:.1f} Msamples/s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU",
              file=sys.stderr)
        return 1
    from amps_tpu_torch.eval.traffic import synthesize_reverse_band
    from amps_tpu_torch.kernels import build
    from amps_tpu_torch.kernels import rx_phases as K
    from amps_tpu_torch.parallel import pipeline as pl

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
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  nvcc: {line.strip()}")

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
        pph, _, _ = K.analyze_phases(planar, M, T, sps, hop0_parity=1)
        rph, _, _ = K.analyze_phases_reference(planar, M, T, sps,
                                               hop0_parity=1)
        torch.cuda.synchronize()
        perr = (pph - rph).abs()
        log(f"  M={M} planar input, odd parity: max|err| "
            f"{perr.max().item():.3e}")
        assert (perr > PHASE_ATOL).double().mean().item() <= \
            BRANCH_CUT_FRACTION

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
        })
        kernel_ms[Mk] = fe
        for k, ms in fe.items():
            log(f"  stages 1-3 M={Mk}, {k}: {ms:.3f} ms, "
                f"{n / ms / 1e3:.1f} Msamples/s")

    # -- phases 5-9: the streaming duplex ----------------------------------
    synth_err = phase_synth(dev, (1024, 256), T)
    front_err = phase_rx_front(dev, (1024, 256), T)
    tx_launches = phase_tx(dev, M, T)
    assert tx_launches >= 2
    rx_launches, pushes = phase_rx(dev, M, T)
    assert rx_launches == pushes + 1
    times = phase_times(dev, M, T, card)

    print(json.dumps({"kernels": [{
        "name": "rx_phases",
        "route": "cuda",
        "source": "amps_tpu_torch/csrc/rx_phases.cu",
        "replaces": "amps_tpu/pallas/rx_phases_kernel.py:223",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms[1024]["kernel"],
        "plain_ms": kernel_ms[1024]["plain"],
    }, {
        "name": "rx_front",
        "route": "cuda",
        "source": "amps_tpu_torch/csrc/rx_front.cu",
        "replaces": "amps_tpu/pallas/rx_front_kernel.py:184",
        "launches": rx_launches,
        "max_abs_err": front_err[1024],
        "ms": times["rx_front"]["kernel"],
        "plain_ms": times["rx_front"]["plain"],
    }, {
        "name": "synth",
        "route": "cuda",
        "source": "amps_tpu_torch/csrc/synth.cu",
        "replaces": "amps_tpu/pallas/synthesizer_kernel.py:128",
        "launches": tx_launches,
        "max_abs_err": synth_err[1024],
        "ms": times["synth"]["kernel"],
        "plain_ms": times["synth"]["plain"],
    }]}), flush=True)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
