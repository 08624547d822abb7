"""The port on the card: each CUDA kernel against its plain version, and
the receive block, the streaming receiver, the transmitter and the
analysis of ``dsp.channelizer.analyze`` on the card against the same on
the CPU.  Every test here needs a CUDA device
and skips without one.

This file imports neither ``jax`` nor ``amps_tpu``, so it runs on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Branch-cut rule: two correct f32 computations that sum in different
orders can put a noise-only sample on opposite sides of ±π, which moves
one phase symbol by ~2π/3.  On random-noise input at most 1e-5 of the
phase elements may fall outside the tolerance."""

import re

import numpy as np
import pytest
import torch

from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.eval.traffic import (BurstEvent, synthesize_reverse_band,
                                         unit_channel_band)
from amps_tpu_torch.kernels import analysis as KA
from amps_tpu_torch.kernels import rx_front as K2
from amps_tpu_torch.kernels import rx_phases as K
from amps_tpu_torch.kernels import synth as K4
from amps_tpu_torch.kernels import trigger_search as KS
from amps_tpu_torch.parallel import pipeline as pl
from amps_tpu_torch.rx import correlator as cor
from amps_tpu_torch.rx.correlator import window_power_blocks
from amps_tpu_torch.runtime.streamer import (MultichannelReceiver,
                                             MultichannelTransmitter)
from amps_tpu_torch.utils import profiling

BRANCH_CUT_FRACTION = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda", 0)


def _x_ext(M, T, Nh, seed, sigma=0.5):
    P = M // 2
    rng = np.random.default_rng(seed)
    x = rng.normal(0, sigma, (Nh * P, 2)).astype(np.float32)
    return np.concatenate([np.zeros((M * T - P, 2), np.float32), x])


@pytest.mark.cuda
@pytest.mark.parametrize("M,Nh,parity,planar,bf16,sps", [
    (256, 1000, 0, False, False, 3),
    (1024, 800, 1, True, True, 3),
    (64, 27 * 14 + 1, 1, False, False, 3),   # one hop past 14 runs of 27
    (1024, 1000, 0, False, False, 1),
    (2048, 200, 1, False, True, 3),
    (4096, 200, 0, True, False, 3),
])
def test_kernel_matches_plain_version_on_card(cuda_device, M, Nh, parity,
                                              planar, bf16, sps):
    T = 8
    x = torch.as_tensor(_x_ext(M, T, Nh, seed=M), device=cuda_device)
    if planar:
        x = x.t().contiguous()
    dt = torch.bfloat16 if bf16 else torch.float32
    before = K.LAUNCHES
    ph, cp, pw = K.analyze_phases(x, M, T, sps, parity, dt)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    rph, rcp, rpw = K.analyze_phases_reference(x, M, T, sps, parity, dt)
    assert ph.shape == rph.shape and ph.dtype == dt
    atol = 0.02 if bf16 else 1e-3
    err = (ph.float() - rph.float()).abs()
    assert (err > atol).sum().item() <= int(BRANCH_CUT_FRACTION * err.numel())
    torch.testing.assert_close(pw, rpw, rtol=1e-4, atol=0)
    torch.testing.assert_close(cp, rcp, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_run(cuda_device):
    x = torch.zeros(((100 + 15) * 48, 2), device=cuda_device)
    with pytest.raises(ValueError):
        K.analyze_phases(x, 95, 8)          # odd M
    with pytest.raises(ValueError):         # odd past 32768
        K.analyze_phases(torch.zeros(((100 + 15) * 16384, 2),
                                     device=cuda_device), 32769, 8)
    with pytest.raises(ValueError):         # sps past the route's 16
        K.analyze_phases(torch.zeros(((100 + 15) * 16385, 2),
                                     device=cuda_device), 32770, 8, sps=17)
    with pytest.raises(ValueError):
        K.analyze_phases(x.double(), 96, 8)
    with pytest.raises(ValueError):         # sps past the tile's hops
        K.analyze_phases(torch.zeros(((100 + 15) * 512, 2),
                                     device=cuda_device), 1024, 8, sps=13)


@pytest.mark.cuda
def test_rx_block_on_card_matches_cpu(cuda_device):
    """f32 spec, M=64: the kernel path on the card and the plain path on
    the CPU find the same bursts and decode the same words."""
    M, total_hops = 64, 12500
    spec = pl.MultichannelSpec(num_channels=M, taps_per_phase=8, fold="bank")
    rng = np.random.default_rng(64)
    events = [BurstEvent(c, h, rng.integers(0, 2, (3, 36)).astype(np.uint8))
              for c, h in ((0, 300), (M - 1, 900), (M // 2 + 1, 1500))]
    x = synthesize_reverse_band(events, spec, total_hops, noise_sigma=0.001,
                                device="cpu")
    want = pl.rx_multichannel_block(x, spec, max_bursts=2)
    before = K.LAUNCHES
    got = pl.rx_multichannel_block(x.to(cuda_device), spec, max_bursts=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    got = {k: v.cpu() for k, v in got.items()}
    valid = want["valid"]
    assert torch.equal(got["valid"], valid)
    assert int(valid.sum()) == len(events)
    for k in ("starts", "words", "word_ok", "dcc_bits", "bad_symbols"):
        assert torch.equal(got[k][valid], want[k][valid]), k
    for ev in events:
        assert torch.equal(got["words"][ev.channel, 0, :3],
                           torch.as_tensor(ev.words))


@pytest.mark.cuda
@pytest.mark.parametrize("M,Nh,parity,planar", [
    (256, 1000, 0, False),
    (1024, 800, 1, True),
    (64, 373, 1, False),       # one hop past 12 whole tiles of 31
])
def test_rx_front_kernel_matches_plain_version_on_card(cuda_device, M, Nh,
                                                       parity, planar):
    T = 8
    x = torch.as_tensor(_x_ext(M, T, Nh, seed=M + 1), device=cuda_device)
    if planar:
        x = x.t().contiguous()
    prev = torch.randn((M, 2), device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(M))
    before = K2.LAUNCHES
    d, last, pw = K2.analyze_demod(x, M, T, parity, prev)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == before + 1
    rd, rlast, rpw = K2.analyze_demod_reference(x, M, T, parity, prev)
    err = (d - rd).abs()
    assert (err > 1e-3).sum().item() <= int(BRANCH_CUT_FRACTION * err.numel())
    # power as the 384-hop block means the rssi uses (a sample near zero
    # carries the roundoff of the strong ones, up to ~1e-2 of its size)
    blk, rblk = (window_power_blocks([p]) for p in (pw, rpw))
    assert ((blk - rblk).abs() / rblk).max().item() <= 1e-4
    assert ((last - rlast).abs().max() / rlast.pow(2).mean().sqrt()).item() \
        <= 1e-4


@pytest.mark.cuda
def test_rx_front_kernel_chained_calls_equal_one(cuda_device):
    M, T = 256, 8
    P = M // 2
    N1, N2 = 1001, 700
    x = torch.as_tensor(_x_ext(M, T, N1 + N2, seed=5), device=cuda_device)
    zero = torch.zeros((M, 2), device=cuda_device)
    d, last, pw = K2.analyze_demod(x, M, T, 0, zero)
    da, la, pa = K2.analyze_demod(x[: (N1 + 2 * T - 1) * P].contiguous(), M,
                                  T, 0, zero)
    db, lb, pb = K2.analyze_demod(x[N1 * P:].contiguous(), M, T, N1 % 2, la)
    assert torch.equal(torch.cat([da, db], 1), d)
    assert torch.equal(torch.cat([pa, pb], 1), pw)
    assert torch.equal(lb, last)


@pytest.mark.cuda
@pytest.mark.parametrize("M,Nh,parity,planar_in,planar", [
    (1024, 2000, 0, False, False),
    (1024, 1001, 1, True, True),
    (256, 8192, 1, False, True),
    (256, 129, 0, True, False),      # one hop past 8 whole tiles of 16
    (64, 1001, 1, False, True),
])
def test_analysis_kernel_matches_plain_version_on_card(cuda_device, M, Nh,
                                                       parity, planar_in,
                                                       planar):
    """K1 against its plain version on unit-amplitude channels, atol
    2e-4 (f32 summation orders of the M-point transform)."""
    T = 8
    x = unit_channel_band(M, T, Nh, M + Nh, cuda_device)
    if planar_in:
        x = x.t().contiguous()
    before = KA.LAUNCHES
    y = KA.analyze_block(x, M, T, parity, planar, planar_in)
    torch.cuda.synchronize()
    assert KA.LAUNCHES == before + 1
    ry = KA.analyze_reference(x, M, T, parity, planar, planar_in)
    assert y.shape == ry.shape == ((2, M, Nh) if planar else (M, Nh, 2))
    assert (y - ry).abs().max().item() <= 2e-4


@pytest.mark.cuda
def test_analyze_on_card_runs_kernel_and_chains(cuda_device):
    """dsp.channelizer.analyze on a CUDA state launches K1 on every call,
    and two chained calls (odd hop count: the parity flips) equal one
    call bit for bit."""
    M, T = 256, 8
    spec = chz.ChannelizerSpec(M, T)
    x = unit_channel_band(M, T, 3001, 9, cuda_device)[M * T - M // 2:]
    n1 = 1001 * M // 2
    before = KA.LAUNCHES
    y, st = chz.analyze(x, spec, chz.analyzer_init(spec), chmajor=True)
    ya, sa = chz.analyze(x[:n1], spec, chz.analyzer_init(spec), chmajor=True)
    yb, sb = chz.analyze(x[n1:], spec, sa, chmajor=True)
    torch.cuda.synchronize()
    assert KA.LAUNCHES == before + 3
    assert torch.equal(torch.cat([ya, yb], 1), y)
    assert sb.hop_idx == st.hop_idx == 3001
    assert torch.equal(sb.history, st.history)


@pytest.mark.cuda
def test_analysis_kernel_rejects_what_it_cannot_run(cuda_device):
    M, T, Nh = 64, 8, 16
    n = (Nh + 2 * T - 1) * M // 2
    x = torch.zeros(n * 2 + 1, device=cuda_device)[1:].view(n, 2)
    with pytest.raises(ValueError, match="aligned"):
        KA.analyze_block(x, M, T)
    with pytest.raises(ValueError, match="device"):
        KA.analyze_block(torch.zeros((n, 2), device="meta"), M, T)
    with pytest.raises(ValueError):            # odd M
        KA.analyze_block(torch.zeros(((Nh + 15) * 48, 2), device=cuda_device),
                         97, T)
    with pytest.raises(ValueError):            # M = 0
        KA.analyze_block(torch.zeros(((Nh + 15) * 8194, 2),
                                     device=cuda_device), 0, T)
    with pytest.raises(ValueError):            # rows that are no (n, 2) block
        KA.analyze_block(torch.zeros((2, n, 3), device=cuda_device), M, T)
    with pytest.raises(ValueError):
        KA.analyze_block(torch.zeros((n, 2), device=cuda_device).double(),
                         M, T)


@pytest.mark.cuda
@pytest.mark.parametrize("M,Nh,parity", [
    (64, 300, 0), (256, 1000, 1), (1024, 257, 1), (128, 3, 0),
    (2048, 100, 1), (4096, 100, 0)])
def test_synth_kernel_matches_plain_version_on_card(cuda_device, M, Nh,
                                                    parity):
    T = 8
    g = torch.Generator(cuda_device).manual_seed(Nh)
    Y = torch.randn((Nh, M, 2), device=cuda_device, generator=g)
    carry = torch.randn((M * T - M // 2, 2), device=cuda_device, generator=g)
    before = K4.LAUNCHES
    x, c = K4.synthesize_block(Y, M, T, parity, carry)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == before + 1
    rx, rc = K4.synthesize_block_reference(Y, M, T, parity, carry)
    rms = rx.pow(2).mean().sqrt()
    assert ((x - rx).abs().max() / rms).item() <= 1e-4
    assert ((c - rc).abs().max() / rms).item() <= 1e-4


@pytest.mark.cuda
def test_synth_kernel_chained_calls_equal_one(cuda_device):
    """Two chained calls (the first's carry into the second, the parity
    flipped by an odd first block) equal one call within 1e-4 of the
    output RMS (the ring adds an output hop's terms in other groupings)."""
    M, T, N1, N2 = 1024, 8, 1001, 700
    g = torch.Generator(cuda_device).manual_seed(7)
    Y = torch.randn((N1 + N2, M, 2), device=cuda_device, generator=g)
    carry = torch.randn((M * T - M // 2, 2), device=cuda_device, generator=g)
    x, c = K4.synthesize_block(Y, M, T, 0, carry)
    xa, ca = K4.synthesize_block(Y[:N1].contiguous(), M, T, 0, carry)
    xb, cb = K4.synthesize_block(Y[N1:].contiguous(), M, T, N1 % 2, ca)
    rms = x.pow(2).mean().sqrt()
    assert ((torch.cat([xa, xb]) - x).abs().max() / rms).item() <= 1e-4
    assert ((cb - c).abs().max() / rms).item() <= 1e-4


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_run(cuda_device):
    Y = torch.zeros((10, 16397, 2), device=cuda_device)
    with pytest.raises(ValueError):            # odd past 16384
        K4.synthesize_block(Y, 16397, 8, 0, torch.zeros(
            (16397 * 8 - 8198, 2), device=cuda_device))
    x = torch.zeros(((100 + 15) * 48, 2), device=cuda_device)
    with pytest.raises(ValueError):            # odd M
        K2.analyze_demod(x, 95, 8, 0, torch.zeros((95, 2), device=cuda_device))


@pytest.mark.cuda
def test_synth_rejects_misaligned_input(cuda_device):
    M, T, Nh = 64, 8, 16
    Y = torch.zeros(Nh * M * 2 + 1, device=cuda_device)[1:].view(Nh, M, 2)
    carry = torch.zeros((M * T - M // 2, 2), device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        K4.synthesize_block(Y, M, T, 0, carry)


def _duplex_band(M, total_hops):
    spec = pl.MultichannelSpec(num_channels=M, taps_per_phase=8, fold="bank")
    rng = np.random.default_rng(M)
    burst = (30 + 11 + 7 + 7 * 240) * 2 * 3
    events = [BurstEvent(c, h, rng.integers(0, 2, (3, 36)).astype(np.uint8))
              for c, h in ((1, 300), (M - 2, 5000),
                           (M // 2, total_hops - 4 - burst))]
    return spec, events, synthesize_reverse_band(events, spec, total_hops,
                                                 noise_sigma=0.001)


@pytest.mark.cuda
def test_streaming_receiver_on_card_matches_cpu(cuda_device):
    """f32 spec, M=64, ragged pushes at depth 2: the kernel front end on
    the card and the plain one on the CPU give the same report list."""
    M = 64
    spec, events, x = _duplex_band(M, 20000)
    n = 4095 * M // 2 + 5
    blocks = [x[i: i + n] for i in range(0, x.shape[0], n)]

    def run(device):
        rx = MultichannelReceiver(spec, threshold=0.5, pipeline_depth=2,
                                  device=device)
        reps = []
        for b in blocks:
            reps += rx.push(b.to(device))
        return reps + rx.flush(pad_tail=True)

    want = run("cpu")
    before = K2.LAUNCHES
    got = run(cuda_device)
    assert K2.LAUNCHES - before == len(blocks) + 1     # + the pad block
    key = [(r.channel, r.abs_symbol, r.words.tolist(), r.word_ok.tolist(),
            r.dcc) for r in got]
    assert key == [(r.channel, r.abs_symbol, r.words.tolist(),
                    r.word_ok.tolist(), r.dcc) for r in want]
    assert sorted(r.channel for r in got) == sorted(e.channel for e in events)


@pytest.mark.cuda
def test_receiver_without_device_runs_kernel_on_card(cuda_device):
    """A receiver built without a device lives on the current CUDA
    device: host blocks (numpy) are copied there and every push launches
    the rx_front kernel; a receiver on the CPU refuses a block on the
    card."""
    M = 64
    spec, events, x = _duplex_band(M, 20000)
    assert x.device == cuda_device            # the traffic is made there too
    n = 4095 * M // 2 + 5
    blocks = [x[i: i + n].cpu().numpy() for i in range(0, x.shape[0], n)]
    rx = MultichannelReceiver(spec, threshold=0.5)
    assert rx.device == cuda_device and rx._carry.device == cuda_device
    before = K2.LAUNCHES
    reps = []
    for b in blocks:
        reps += rx.push(b)
    reps += rx.flush(pad_tail=True)
    assert K2.LAUNCHES - before == len(blocks) + 1     # + the pad block
    assert sorted(r.channel for r in reps) == sorted(e.channel for e in events)
    with pytest.raises(ValueError):
        MultichannelReceiver(spec, device="cpu").push(x[:n])


@pytest.mark.cuda
def test_transmitter_without_device_runs_kernel_on_card(cuda_device):
    spec = pl.MultichannelSpec(num_channels=64, taps_per_phase=8)
    tx = MultichannelTransmitter(spec, control_channels=[0, 5, 63])
    assert tx.device == cuda_device
    before = K4.LAUNCHES
    x = tx.next_block()
    torch.cuda.synchronize()
    assert K4.LAUNCHES == before + 1 and x.device == cuda_device


@pytest.mark.cuda
def test_voice_slot_runs_on_card(cuda_device, monkeypatch):
    """A VoiceFvcSlot built without a device modulates on the card: the
    resampler, the SAT tone, the FM modulator and the FVC burst modulator
    all get CUDA tensors, and the blocks equal a CPU slot's within 2e-3
    (f32 cumsums in other orders)."""
    from amps_tpu_torch.control.station import BaseStation
    from amps_tpu_torch.runtime import sources
    from amps_tpu_torch.tx import voice
    seen = []

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(x, *a, **k):
            seen.append((name, torch.as_tensor(x).device.type))
            return fn(x, *a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(voice, "polyphase_interpolate")
    spy(voice, "fm_modulate")
    spy(sources, "fm_modulate_symbols")
    sts = [BaseStation(sps=3) for _ in range(2)]
    card = sources.VoiceFvcSlot(sts[0])
    host = sources.VoiceFvcSlot(sts[1], device="cpu")
    assert card.device == cuda_device
    for step in (9000, "fvc alert", "fvc on", 12001, "fvc off", 9000):
        if isinstance(step, str):
            for st in sts:
                st.handle_command(step)
            continue
        n = len(seen)
        got = card(step)
        assert {d for _, d in seen[n:]} == {"cuda"}, seen[n:]
        want = host(step)
        assert isinstance(got, np.ndarray) and got.shape == (step, 2)
        assert np.abs(got - want).max() < 2e-3
    assert {name for name, _ in seen} == {"polyphase_interpolate",
                                          "fm_modulate",
                                          "fm_modulate_symbols"}


@pytest.mark.cuda
def test_resilient_receiver_recovers_on_card(cuda_device, monkeypatch):
    """ResilientReceiver over a factory that names no device: its
    receivers live on the card, the blocks there run the kernel, and
    after an injected push failure the ring's host copies are replayed
    onto the card."""
    from amps_tpu_torch.runtime.resilient import ResilientReceiver
    M = 64
    spec, events, x = _duplex_band(M, 20000)
    n = 4096 * M // 2
    blocks = [x[i: i + n].to(cuda_device) for i in range(0, x.shape[0], n)]
    orig, calls = MultichannelReceiver.push, {"n": 0}

    def push(self, b):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected device loss")
        return orig(self, b)

    monkeypatch.setattr(MultichannelReceiver, "push", push)
    res = ResilientReceiver(lambda: MultichannelReceiver(spec, threshold=0.5),
                            checkpoint_blocks=2)
    before = K2.LAUNCHES
    reps = []
    for b in blocks:
        reps += res.push(b)
    reps += res.flush()
    assert res.recoveries == 1 and res.rx.device == cuda_device
    # each block once (the failed one in the replay), + the pad block
    assert K2.LAUNCHES - before == len(blocks) + 1
    assert sorted(r.channel for r in reps) == sorted(e.channel for e in events)


@pytest.mark.cuda
def test_transmitter_on_card_matches_cpu(cuda_device):
    spec = pl.MultichannelSpec(num_channels=64, taps_per_phase=8)
    txs = [MultichannelTransmitter(spec, control_channels=[0, 5, 63],
                                   device=d) for d in ("cpu", cuda_device)]
    before = K4.LAUNCHES
    for _ in range(2):
        want, got = (tx.next_block() for tx in txs)
        assert (got.cpu() - want).abs().max().item() <= 2e-4
    assert K4.LAUNCHES == before + 2


@pytest.mark.cuda
def test_tx_block_on_card_matches_cpu(cuda_device):
    spec = pl.MultichannelSpec(num_channels=64, taps_per_phase=8)
    wp = np.random.default_rng(3).integers(0, 2, (64, 2, 2, 28)).astype(
        np.uint8)
    want = pl.tx_multichannel_block(wp, spec)
    before = K4.LAUNCHES
    got = pl.tx_multichannel_block(torch.as_tensor(wp, device=cuda_device),
                                   spec)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == before + 1
    assert (got.cpu() - want).abs().max().item() <= 2e-4


# ---- the small banks (M = 8, 16, 32) -----------------------------------

SMALL = [(8, 4, 0, False), (8, 8, 1, True), (16, 8, 0, True),
         (16, 4, 1, False), (32, 8, 1, False), (32, 4, 0, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,T,parity,planar", SMALL)
def test_small_width_analysis_kernel(cuda_device, M, T, parity, planar):
    """K1 at the small banks, both parities, T = 4 and 8, riq and planar
    in and out, the bound of the wide widths (2e-4 on unit-amplitude
    channels); two chained calls (an odd first block) equal one bit for
    bit."""
    Nh, N1 = 1001, 333
    P = M // 2
    x = unit_channel_band(M, T, Nh, M + T, cuda_device)
    cut = (lambda a, lo, hi: a[lo:hi].contiguous())
    if planar:
        x = x.t().contiguous()
        cut = (lambda a, lo, hi: a[:, lo:hi].contiguous())
    before = KA.LAUNCHES
    y = KA.analyze_block(x, M, T, parity, planar, planar)
    torch.cuda.synchronize()
    assert KA.LAUNCHES == before + 1
    ry = KA.analyze_reference(x, M, T, parity, planar, planar)
    assert y.shape == ry.shape == ((2, M, Nh) if planar else (M, Nh, 2))
    assert (y - ry).abs().max().item() <= 2e-4
    ya = KA.analyze_block(cut(x, 0, (N1 + 2 * T - 1) * P), M, T, parity,
                          planar, planar)
    yb = KA.analyze_block(cut(x, N1 * P, None), M, T, parity + N1, planar,
                          planar)
    assert torch.equal(torch.cat([ya, yb], -1 if planar else 1), y)


@pytest.mark.cuda
@pytest.mark.parametrize("M,T,parity,planar", SMALL)
def test_small_width_rx_front_kernel(cuda_device, M, T, parity, planar):
    """K2 at the small banks against its plain version (the wide widths'
    bounds), and chained = one."""
    Nh, N1 = 1001, 333
    P = M // 2
    x = torch.as_tensor(_x_ext(M, T, Nh, seed=M + T), device=cuda_device)
    cut = (lambda a, lo, hi: a[lo:hi].contiguous())
    if planar:
        x = x.t().contiguous()
        cut = (lambda a, lo, hi: a[:, lo:hi].contiguous())
    prev = torch.randn((M, 2), device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(M))
    d, last, pw = K2.analyze_demod(x, M, T, parity, prev)
    rd, rlast, rpw = K2.analyze_demod_reference(x, M, T, parity, prev)
    err = (d - rd).abs()
    assert (err > 1e-3).sum().item() <= int(BRANCH_CUT_FRACTION * err.numel())
    blk, rblk = (window_power_blocks([p]) for p in (pw, rpw))
    assert ((blk - rblk).abs() / rblk).max().item() <= 1e-4
    assert ((last - rlast).abs().max() / rlast.pow(2).mean().sqrt()).item() \
        <= 1e-4
    da, la, pa = K2.analyze_demod(cut(x, 0, (N1 + 2 * T - 1) * P), M, T,
                                  parity, prev)
    db, lb, pb = K2.analyze_demod(cut(x, N1 * P, None), M, T, parity + N1, la)
    assert torch.equal(torch.cat([da, db], 1), d)
    assert torch.equal(torch.cat([pa, pb], 1), pw)
    assert torch.equal(lb, last)


@pytest.mark.cuda
@pytest.mark.parametrize("M,T,parity,planar", SMALL)
@pytest.mark.parametrize("bf16", [False, True])
def test_small_width_rx_phases_kernel(cuda_device, M, T, parity, planar,
                                      bf16):
    """K3 at the small banks against its plain version (the wide widths'
    bounds); a ragged hop count, one hop past whole runs of 27."""
    Nh = 27 * 40 + 1
    x = torch.as_tensor(_x_ext(M, T, Nh, seed=M + T + 1), device=cuda_device)
    if planar:
        x = x.t().contiguous()
    dt = torch.bfloat16 if bf16 else torch.float32
    ph, cp, pw = K.analyze_phases(x, M, T, 3, parity, dt)
    rph, rcp, rpw = K.analyze_phases_reference(x, M, T, 3, parity, dt)
    assert ph.shape == rph.shape == (M, 3, (Nh - 2) // 3) and ph.dtype == dt
    err = (ph.float() - rph.float()).abs()
    assert (err > (0.02 if bf16 else 1e-3)).sum().item() \
        <= int(BRANCH_CUT_FRACTION * err.numel())
    torch.testing.assert_close(pw, rpw, rtol=1e-4, atol=0)
    torch.testing.assert_close(cp, rcp, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,T,parity", [(m, t, p) for m, t, p, _ in SMALL])
def test_small_width_synth_kernel(cuda_device, M, T, parity):
    """K4 at the small banks against its plain version, with a carry in
    (1e-4 of the output RMS, the wide widths' bound); chained = one
    within the same bound."""
    Nh, N1 = 1000, 333
    g = torch.Generator(cuda_device).manual_seed(M + T)
    Y = torch.randn((Nh, M, 2), device=cuda_device, generator=g)
    carry = torch.randn((M * T - M // 2, 2), device=cuda_device, generator=g)
    x, c = K4.synthesize_block(Y, M, T, parity, carry)
    rx, rc = K4.synthesize_block_reference(Y, M, T, parity, carry)
    rms = rx.pow(2).mean().sqrt()
    assert ((x - rx).abs().max() / rms).item() <= 1e-4
    assert ((c - rc).abs().max() / rms).item() <= 1e-4
    xa, ca = K4.synthesize_block(Y[:N1].contiguous(), M, T, parity, carry)
    xb, cb = K4.synthesize_block(Y[N1:].contiguous(), M, T, parity + N1, ca)
    assert ((torch.cat([xa, xb]) - x).abs().max() / rms).item() <= 1e-4
    assert ((cb - c).abs().max() / rms).item() <= 1e-4


@pytest.mark.cuda
def test_widths_the_tile_cannot_take_raise(cuda_device, mixed_libraries):
    """Odd M and M < 2 raise on the card, naming every rule; no width
    reaches the plain version.  The unsplit widths up to 16384 (8194,
    8198) run the kernels in shared memory; the unsplit widths past 16384
    (16396, 16388) and M past 32768 (32770) run them through device
    memory (the route), each call one launch of the wrapper."""
    for M in (13, 16397, 4097, 16389, 32769):
        x = torch.zeros(((100 + 15) * (M // 2), 2), device=cuda_device)
        with pytest.raises(ValueError):
            KA.analyze_block(x, M, 8)
        with pytest.raises(ValueError):
            K.analyze_phases(x, M, 8)
    for M in (8194, 8198, 16396, 16388, 32770):
        x = torch.zeros(((100 + 15) * (M // 2), 2), device=cuda_device)
        before = KA.LAUNCHES
        assert torch.isfinite(KA.analyze_block(x, M, 8)).all()
        assert KA.LAUNCHES == before + 1
        assert bool(KA.route_length(M)) == (M > 16384)
    rule = "even M from 2 to 16384 .past 8192 split, or Bluestein"
    for M in (16397, 0, 32769):
        x = torch.zeros(((100 + 15) * max(M // 2, 1), 2), device=cuda_device)
        with pytest.raises(ValueError, match=rule):
            KA.analyze_block(x, M, 8)
        with pytest.raises(ValueError, match=rule):
            K2.analyze_demod(x, M, 8, 0, torch.zeros((M, 2),
                                                     device=cuda_device))


# ---- widths that are not powers of two (mixed-radix FFT tile) ----------

# (M, parity, planar): radices 5 and 7 at the small end, the generic
# prime pass (22 = 2·11, 286 = 2·11·13, 682 = 2·11·31, 2046 = 2·3·11·31,
# 2038 = 2·1019), long plans (1000 = 8·5³), the station's 96, 384, 768
# and 1536; chip_smoke phase 29 covers 24, 160, 448, 768, 1458 and 2038
MIXED = [(10, 0, False), (22, 1, True), (96, 1, False), (210, 0, True),
         (286, 1, False), (384, 0, False), (682, 1, True), (768, 1, False),
         (1000, 0, True), (1536, 1, False), (2038, 0, False),
         (2046, 1, True)]
# banks past 2048 channels (the twiddles read from device memory, K4's
# column groups): 3·1024 and the 122.88 Msps bank, 4096 (main library)
WIDE = [(3072, 1, True), (4096, 0, False)]
# banks past 4096 channels, each hop shared by a cluster of two blocks:
# an odd half width (4098 = 2·2049), radix 3 at 6144, the generic pass
# at 8190 = 2·3²·5·7·13, the 245.76 Msps bank 8192; both parities, riq
# and planar at each
WIDEST = [(M, parity, planar) for M in (4098, 6144, 8190, 8192)
          for parity, planar in ((0, False), (1, True))]
# banks past 8192 channels, each hop shared by a cluster of C > 2 blocks
# and a radix-C pass across it: 12294 = 6·2049 (an odd block width),
# 16384 = 4·4096 (491.52 Msps)
WIDER = [(M, parity, planar) for M in (12294, 16384)
         for parity, planar in ((0, False), (1, True))]
# the unsplit widths past 8192, each a chirp convolution of length 32768
# (Bluestein) on a cluster of 8 blocks: 8194 = 2·17·241 (the first),
# 8198 = 2·4099 and 16382 = 2·8191 (the widest, 491.46 Msps)
BLUESTEIN = [(M, parity, planar) for M in (8194, 8198, 16382)
             for parity, planar in ((0, False), (1, True))]
# every other even width, through device memory (the main library's
# route): 16388 = 4·17·241 (Bluestein, L = 65536), 32770 (past 32768, L =
# 131072) and 65536 (a power of two, direct)
ROUTE = [(16388, 0, False), (16388, 1, True), (32770, 1, False),
         (65536, 0, True)]


@pytest.fixture(scope="module")
def mixed_libraries():
    """Every MIXED, WIDE, WIDEST, WIDER and BLUESTEIN width's own
    library, built at once (one nvcc a source and width, all in parallel)
    before the first test needs one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    from amps_tpu_torch.kernels import build
    build.build(widths=[M for M, _, _ in
                        MIXED + WIDE + WIDEST + WIDER + BLUESTEIN
                        if M not in KA.LIBRARY_WIDTHS])


def _fsk_band(M, T, Nh, seed, dev):
    """History-prepended wideband whose M channels all carry random-data
    FSK at 3 hops a symbol (no channel's phase sits near zero magnitude),
    through the plain synthesis on the card."""
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


# fast_atan2 steps by 0.0417 at its octant seam (|im| = |re|), where two
# f32 summation orders may land on either side: a demod sample there is
# held to the step, and such samples to BRANCH_CUT_FRACTION of the plane
ATAN_SEAM = 0.0417


def _held_to_phase_atol(err, ref, atol):
    a = ref.abs()
    seam = ((a - np.pi / 4).abs() < 0.025) | ((a - 3 * np.pi / 4).abs() < 0.025)
    on_seam = (err > atol) & seam
    assert err.masked_fill(on_seam, 0.0).max().item() <= atol
    assert on_seam.sum().item() <= BRANCH_CUT_FRACTION * err.numel() + 1
    assert err.max().item() <= ATAN_SEAM + atol


@pytest.mark.cuda
@pytest.mark.parametrize("M,parity,planar",
                         MIXED + WIDE + WIDEST + WIDER + BLUESTEIN + ROUTE)
def test_mixed_width_analysis_kernel(cuda_device, mixed_libraries, M,
                                     parity, planar):
    """K1 at a width that is not a power of two: atol 2e-4 on
    unit-amplitude channels, riq or planar in and out; one launch."""
    T, Nh = 8, 301
    x = unit_channel_band(M, T, Nh, M, cuda_device)
    if planar:
        x = x.t().contiguous()
    before = KA.LAUNCHES
    y = KA.analyze_block(x, M, T, parity, planar, planar)
    torch.cuda.synchronize()
    assert KA.LAUNCHES == before + 1
    ry = KA.analyze_reference(x, M, T, parity, planar, planar)
    assert y.shape == ry.shape and torch.isfinite(y).all()
    assert (y - ry).abs().max().item() <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("M,parity,planar",
                         MIXED + WIDE + WIDEST + WIDER + BLUESTEIN + ROUTE)
def test_mixed_width_rx_front_kernel(cuda_device, mixed_libraries, M,
                                     parity, planar):
    """K2 on FSK in every channel: demod within 1e-3 (fast_atan2's seam
    aside), the 384-hop power blocks within 1e-4, the last sample within
    1e-4 of its RMS."""
    T, Nh, skip = 8, 500, 18
    x = _fsk_band(M, T, Nh, M + 1, cuda_device)
    if planar:
        x = x.t().contiguous()
    prev = torch.randn((M, 2), device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(M))
    before = K2.LAUNCHES
    d, last, pw = K2.analyze_demod(x, M, T, parity, prev)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == before + 1
    rd, rlast, rpw = K2.analyze_demod_reference(x, M, T, parity, prev)
    _held_to_phase_atol((d - rd)[:, skip:].abs(), rd[:, skip:], 1e-3)
    blk, rblk = (window_power_blocks([p[:, skip:]]) for p in (pw, rpw))
    assert ((blk - rblk).abs() / rblk).max().item() <= 1e-4
    assert ((last - rlast).abs().max() / rlast.pow(2).mean().sqrt()).item() \
        <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("M,parity,planar",
                         MIXED + WIDE + WIDEST + WIDER + BLUESTEIN + ROUTE)
@pytest.mark.parametrize("bf16", [False, True])
def test_mixed_width_rx_phases_kernel(cuda_device, mixed_libraries, M,
                                      parity, planar, bf16):
    """K3 on FSK in every channel: phases within 1e-3 (f32) or 0.02 (bf16)
    past the bank's ramp-up, a ragged hop count; the power within 1e-4.
    A demod sample on fast_atan2's seam moves each of the sps = 3 symbols
    it enters by a third of the step: in f32 such samples are held to
    BRANCH_CUT_FRACTION of the demod samples, as K2's are."""
    T, Nh = 8, 27 * 20 + 1
    x = _fsk_band(M, T, Nh, M + 2, cuda_device)
    if planar:
        x = x.t().contiguous()
    dt = torch.bfloat16 if bf16 else torch.float32
    before = K.LAUNCHES
    ph, cp, pw = K.analyze_phases(x, M, T, 3, parity, dt)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    rph, rcp, rpw = K.analyze_phases_reference(x, M, T, 3, parity)
    assert ph.shape == rph.shape and ph.dtype == dt
    err = (ph.float() - rph)[..., 6:].abs()
    if bf16:
        assert err.max().item() <= 0.02
    else:
        assert err.max().item() <= ATAN_SEAM / 3 + 1e-3
        assert (err > 1e-3).sum().item() \
            <= 3 * BRANCH_CUT_FRACTION * err.numel()
    rel = ((pw - rpw).abs() / rpw)[:, 1:]
    assert rel.max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("M,parity",
                         [(M, p) for M, p, _ in
                          MIXED + WIDE + WIDEST + WIDER + BLUESTEIN + ROUTE])
def test_mixed_width_synth_kernel(cuda_device, mixed_libraries, M, parity):
    """K4 with a carry in: 1e-4 of the output RMS."""
    T, Nh = 8, 333
    g = torch.Generator(cuda_device).manual_seed(M)
    Y = torch.randn((Nh, M, 2), device=cuda_device, generator=g)
    carry = torch.randn((M * T - M // 2, 2), device=cuda_device, generator=g)
    before = K4.LAUNCHES
    x, c = K4.synthesize_block(Y, M, T, parity, carry)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == before + 1
    rx, rc = K4.synthesize_block_reference(Y, M, T, parity, carry)
    rms = rx.pow(2).mean().sqrt()
    assert ((x - rx).abs().max() / rms).item() <= 1e-4
    assert ((c - rc).abs().max() / rms).item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("M,parity", [(16388, 0), (16388, 1), (65536, 1)])
def test_route_takes_one_hop(cuda_device, M, parity):
    """On the device-memory route a block of one hop (a streaming call
    may hand one) runs K1 and K4 in one chunk of a single row, and K2 in
    one of two (the hop behind it): each within the mixed-width tests'
    bounds of its plain version, K4's output and carry each of its own
    RMS."""
    T, P = 8, M // 2
    x = unit_channel_band(M, T, 1, M, cuda_device)
    y = KA.analyze_block(x, M, T, parity)
    ry = KA.analyze_reference(x, M, T, parity)
    assert y.shape == ry.shape == (M, 1, 2)
    assert (y - ry).abs().max().item() <= 2e-4
    # K2 on the hop 30 hops into an FSK band (past the bank's ramp-up)
    band = _fsk_band(M, T, 31, M + 1, cuda_device)
    x = band[30 * P:(31 + 2 * T - 1) * P].contiguous()
    prev = torch.randn((M, 2), device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(M))
    d, last, _ = K2.analyze_demod(x, M, T, parity, prev)
    rd, rlast, _ = K2.analyze_demod_reference(x, M, T, parity, prev)
    assert d.shape == rd.shape == (M, 1)
    _held_to_phase_atol((d - rd).abs(), rd, 1e-3)
    assert ((last - rlast).abs().max() / rlast.pow(2).mean().sqrt()).item() \
        <= 1e-4
    g = torch.Generator(cuda_device).manual_seed(M + parity)
    Y = torch.randn((1, M, 2), device=cuda_device, generator=g)
    carry = torch.randn((M * T - P, 2), device=cuda_device, generator=g)
    out, c = K4.synthesize_block(Y, M, T, parity, carry)
    rout, rc = K4.synthesize_block_reference(Y, M, T, parity, carry)
    # each against its own RMS: one hop's output holds the filter's first
    # taps, its carry the central ones (~20x larger at 16388)
    for got, ref in ((out, rout), (c, rc)):
        assert ((got - ref).abs().max() / ref.pow(2).mean().sqrt()).item() \
            <= 1e-4


@pytest.mark.cuda
def test_chained_calls_equal_one_at_768(cuda_device, mixed_libraries):
    """At M=768 two chained calls (an odd first block: the parity flips)
    equal one call: K1 and K2 bit for bit; K4 within 1e-4 of the output
    RMS (the carry's partial sums group an output hop's terms
    otherwise)."""
    _chained_calls_equal_one(cuda_device, 768)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4098, 6144, 8190, 8192, 16384, 8194, 16382,
                               16388, 32770])
def test_chained_calls_equal_one_at_cluster_widths(cuda_device,
                                                   mixed_libraries, M):
    """Past 4096, where a cluster of blocks shares each hop (two up to
    8192, four at 16384, with the radix-4 pass across them, eight at
    8194 and 16382 in the Bluestein mode), and on the device-memory route
    (16388, 32770): two chained calls equal one call, K1 and K2 bit for
    bit, K4 within 1e-4 of the output RMS, as at 768."""
    _chained_calls_equal_one(cuda_device, M)


def _chained_calls_equal_one(cuda_device, M):
    T, N1, N2 = 8, 1001, 700
    P = M // 2
    x = unit_channel_band(M, T, N1 + N2, 768, cuda_device)
    y = KA.analyze_block(x, M, T, 0)
    ya = KA.analyze_block(x[: (N1 + 2 * T - 1) * P].contiguous(), M, T, 0)
    yb = KA.analyze_block(x[N1 * P:].contiguous(), M, T, N1 % 2)
    assert torch.equal(torch.cat([ya, yb], 1), y)
    zero = torch.zeros((M, 2), device=cuda_device)
    d, last, pw = K2.analyze_demod(x, M, T, 0, zero)
    da, la, pa = K2.analyze_demod(x[: (N1 + 2 * T - 1) * P].contiguous(), M,
                                  T, 0, zero)
    db, lb, pb = K2.analyze_demod(x[N1 * P:].contiguous(), M, T, N1 % 2, la)
    assert torch.equal(torch.cat([da, db], 1), d)
    assert torch.equal(torch.cat([pa, pb], 1), pw)
    assert torch.equal(lb, last)
    g = torch.Generator(cuda_device).manual_seed(7)
    Y = torch.randn((N1 + N2, M, 2), device=cuda_device, generator=g)
    carry = torch.randn((M * T - P, 2), device=cuda_device, generator=g)
    xs, c = K4.synthesize_block(Y, M, T, 0, carry)
    xa, ca = K4.synthesize_block(Y[:N1].contiguous(), M, T, 0, carry)
    xb, cb = K4.synthesize_block(Y[N1:].contiguous(), M, T, N1 % 2, ca)
    rms = xs.pow(2).mean().sqrt()
    assert ((torch.cat([xa, xb]) - xs).abs().max() / rms).item() <= 1e-4
    assert ((cb - c).abs().max() / rms).item() <= 1e-4


@pytest.mark.cuda
def test_rx_block_on_card_matches_cpu_at_768(cuda_device, mixed_libraries):
    """f32 spec at M=768: the kernel path on the card (K3 from the width's
    own library) and the plain path on the CPU find the same bursts and
    decode the same words."""
    M, total_hops = 768, 12500
    spec = pl.MultichannelSpec(num_channels=M, taps_per_phase=8, fold="bank")
    rng = np.random.default_rng(768)
    events = [BurstEvent(c, h, rng.integers(0, 2, (3, 36)).astype(np.uint8))
              for c, h in ((0, 300), (M - 1, 900), (M // 2 + 1, 1500))]
    x = synthesize_reverse_band(events, spec, total_hops, noise_sigma=0.001,
                                device="cpu")
    want = pl.rx_multichannel_block(x, spec, max_bursts=2)
    before = K.LAUNCHES
    got = pl.rx_multichannel_block(x.to(cuda_device), spec, max_bursts=2)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    got = {k: v.cpu() for k, v in got.items()}
    valid = want["valid"]
    assert torch.equal(got["valid"], valid)
    assert int(valid.sum()) == len(events)
    for k in ("starts", "words", "word_ok", "dcc_bits", "bad_symbols"):
        assert torch.equal(got[k][valid], want[k][valid]), k


# ---- the batched block, the closed loop, supervision -------------------

@pytest.mark.cuda
def test_rx_phases_band_axis_equals_one_launch_a_band(cuda_device):
    """G bands in one launch (the band as the grid's second axis) equal G
    launches bit for bit, and count as one launch."""
    M, T, Nh, G = 128, 8, 1000, 5
    x = torch.stack([torch.as_tensor(_x_ext(M, T, Nh, seed=g),
                                     device=cuda_device) for g in range(G)])
    before = K.LAUNCHES
    ph, cp, pw = K.analyze_phases(x, M, T, 3, 0, torch.bfloat16)
    assert K.LAUNCHES == before + 1
    assert ph.shape[:2] == (G, M) and cp.shape == (G, M)
    for g in range(G):
        a = K.analyze_phases(x[g], M, T, 3, 0, torch.bfloat16)
        for u, v in zip((ph[g], cp[g], pw[g]), a):
            assert torch.equal(u, v)
    with pytest.raises(ValueError):
        K.analyze_phases(x.transpose(0, 1), M, T, 3)     # not contiguous


@pytest.mark.cuda
def test_batched_block_on_card_at_16_channels(cuda_device):
    """tests/test_rx.py's batched scenario on the card: M=16, G=3, one
    burst a band; the batched block (one K3 launch) equals the single-band
    block on each band and the CPU's plain path on valid slots."""
    M, G, total_hops = 16, 3, 12500
    spec = pl.MultichannelSpec(num_channels=M, taps_per_phase=8)
    rng = np.random.default_rng(16)
    events = [BurstEvent(c, h, rng.integers(0, 2, (3, 36)).astype(np.uint8))
              for c, h in ((2, 300), (9, 900), (15, 1500))]
    xs = torch.stack([synthesize_reverse_band([ev], spec, total_hops,
                                              noise_sigma=0.001)
                      for ev in events])
    assert xs.device == cuda_device
    before = K.LAUNCHES
    got = pl.rx_multichannel_block_batched(xs, spec, max_bursts=2)
    assert K.LAUNCHES == before + 1
    want = pl.rx_multichannel_block_batched(xs.cpu(), spec, max_bursts=2)
    for g, ev in enumerate(events):
        one = pl.rx_multichannel_block(xs[g], spec, max_bursts=2)
        for k in one:
            assert torch.equal(got[k][g], one[k]), (g, k)
        valid = want["valid"][g]
        assert int(valid.sum()) == 1 and valid[ev.channel, 0]
        assert torch.equal(got["valid"][g].cpu(), valid)
        for k in ("starts", "words", "word_ok", "dcc_bits"):
            assert torch.equal(got[k][g].cpu()[valid], want[k][g][valid]), k
        assert torch.equal(got["words"][g, ev.channel, 0, :3].cpu(),
                           torch.as_tensor(ev.words))


def _loop_pairs(M, frames=2):
    """The steady-state FOCC superframe's first frames on every channel
    (a forward control channel must not trigger the reverse detector)."""
    from amps_tpu_torch.tx.focc import superframe_word_pairs
    return np.broadcast_to(superframe_word_pairs()[:frames],
                           (M, frames, 2, 28)).copy()


@pytest.mark.cuda
@pytest.mark.parametrize("nblocks", [3, 4])
def test_closed_loop_graph_equals_eager(cuda_device, nblocks):
    """M=64: the loop under a CUDA graph (one block a replay) and the
    eager loop launch the same kernels in the same order on the same data,
    so the three sums are bit-identical; K4 and K2 count one launch a block
    either way (a replay's launches are added by ``run``), plus the one
    warm-up block before the capture in a closure's first run; a second
    run replays without a new capture."""
    from amps_tpu_torch.runtime.streamer import make_closed_loop_stream
    spec = pl.MultichannelSpec(num_channels=64, taps_per_phase=8,
                               io_bf16=True, corr_bf16=True)
    wp = _loop_pairs(64)
    eager, bs = make_closed_loop_stream(spec, nblocks, graph=False)
    graphed, bs2 = make_closed_loop_stream(spec, nblocks)
    assert bs == bs2 == 5556 * 32
    b4, b2 = K4.LAUNCHES, K2.LAUNCHES
    want = eager(wp)
    assert (K4.LAUNCHES - b4, K2.LAUNCHES - b2) == (nblocks, nblocks)
    for warm_up in (1, 0):
        b4, b2 = K4.LAUNCHES, K2.LAUNCHES
        got = graphed(wp)
        torch.cuda.synchronize()
        assert (K4.LAUNCHES - b4, K2.LAUNCHES - b2) \
            == (nblocks + warm_up, nblocks + warm_up)
        assert all(a.device == cuda_device and a.ndim == 0 for a in got)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[0]) == 0 and 0.2 < float(got[1]) < 0.55


@pytest.mark.cuda
def test_closed_loop_capture_failure_raises(cuda_device):
    """A body that reads a tensor on the host cannot be captured: run
    raises, and does not go eager by itself."""
    from amps_tpu_torch.runtime.streamer import make_closed_loop_stream
    spec = pl.MultichannelSpec(num_channels=64, taps_per_phase=8)
    calls = []

    def front_end(x_ext, M, T, parity, prev):
        out = K2.analyze_demod(x_ext, M, T, parity, prev)
        if calls:                 # the warm-up passes, the capture does not
            out[0].sum().item()
        calls.append(1)
        return out

    run, _ = make_closed_loop_stream(spec, 2, front_end=front_end)
    with pytest.raises(RuntimeError):
        run(_loop_pairs(64))
    torch.cuda.synchronize()
    assert len(calls) == 1
    # the device and a fresh closure are fine afterwards
    ok, _ = make_closed_loop_stream(spec, 2)
    assert int(ok(_loop_pairs(64))[0]) == 0


@pytest.mark.cuda
def test_supervision_slots_on_card_match_cpu(cuda_device):
    """A receiver with two supervision slots on the card (rows gathered
    there, K2 front end) delivers the frames the CPU receiver delivers:
    same slots in the same order, the voice slot's levels within 2e-3
    (f32 transform orders; the idle slot demodulates roundoff, which no
    two orders share), SAT near its transmitted 0.05 on the voice slot."""
    from amps_tpu_torch.tx.voice import voice_channel_baseband
    M, hops = 64, 3 * 4096
    spec = pl.MultichannelSpec(num_channels=M, taps_per_phase=8)
    audio = np.zeros(hops * 16000 // 60000 + 8, np.float32)
    bb, _ = voice_channel_baseband(audio, sat=True)
    Y = torch.zeros((hops, M, 2), device=cuda_device)
    Y[:, 5] = bb[:hops]
    x, _ = chz.synthesize(Y, spec.chz_spec,
                          chz.synthesizer_init(spec.chz_spec))
    n = 4096 * M // 2

    def run(device):
        calls = []
        rx = MultichannelReceiver(
            spec, supervision_slots=(5, 9), device=device,
            on_supervision=lambda s, lv, pw: calls.append((s, lv, pw)))
        for i in range(3):
            rx.push(x[i * n: (i + 1) * n].to(device))
        return calls

    want = run("cpu")
    before = K2.LAUNCHES
    got = run(cuda_device)
    assert K2.LAUNCHES - before == 3
    assert [c[0] for c in got] == [c[0] for c in want] == [5, 9] * 3
    for (slot, lv, pw), (_, wlv, wpw) in zip(got, want):
        assert lv.shape == wlv.shape and lv.shape[1] == 5
        assert pw.shape == wpw.shape == lv.shape[:1]
        if slot == 5:
            assert np.abs(lv - wlv).max() <= 2e-3
    sat = np.concatenate([lv[:, 1] for s, lv, _ in got if s == 5])[12:]
    assert np.abs(sat - 0.05).max() < 0.01


@pytest.mark.cuda
def test_bs_app_on_card_launches_both_kernels(cuda_device):
    """The BS-in-a-box app at M=64 on the card (its default device): the
    TX thread runs the synthesis kernel, the RX thread the front-end
    kernel, and the simulated origination is dispatched."""
    from amps_tpu_torch.apps import bs_app
    K4.LAUNCHES = K2.LAUNCHES = 0
    result = {}
    bs_app.main(["--channels", "64", "--superframes", "1", "--no-server",
                 "--simulate", "origination:5551234567:5551230000"], result)
    assert K4.LAUNCHES >= 1 and K2.LAUNCHES >= 1
    assert [r.channel for r in result["reports"]] == [3]
    assert any(e.kind == "command" and str(e.payload) == "page 5551230000"
               for e in result["station"].events)
    assert result["stats"].tx_samples == 50004 * 32


@pytest.mark.cuda
def test_file_sink_writes_cuda_tensor(cuda_device, tmp_path):
    from amps_tpu_torch.runtime.sdr import FileIQSink, FileIQSource
    x = torch.randn((1000, 2), device=cuda_device)
    sink = FileIQSink(str(tmp_path / "iq.f32"))
    sink.write(x)
    sink.close()
    got = FileIQSource(str(tmp_path / "iq.f32")).read(2000)
    assert np.array_equal(got, x.cpu().numpy())


@pytest.mark.cuda
def test_link_curve_on_card(cuda_device):
    from amps_tpu_torch.eval.ber import recc_link_curve
    curve = recc_link_curve([20.0, 6.0, -14.0], trials=16)
    assert curve[20.0]["detect_rate"] == 1.0
    assert curve[20.0]["word_success_rate"] == 1.0
    assert curve[6.0]["word_success_rate"] >= 0.9
    assert curve[-14.0]["word_success_rate"] <= 0.25


@pytest.mark.cuda
def test_sharded_step_on_card_matches_cpu(cuda_device):
    """The full-duplex sharded step on a 2x2 mesh whose four workers share
    the card, against the same mesh on CPU workers, M=32: two blocks with
    a burst across the row boundary and one across the block boundary.
    Each worker launches the analysis kernel and the synthesis kernel once
    a step; the reports agree on every valid slot, the TX wideband to
    1e-4 of its peak, the carried analyzer history exactly."""
    from amps_tpu_torch.eval.traffic import MobileEvent
    from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from amps_tpu_torch.tx.focc import superframe_word_pairs
    M, row = 32, 12480
    spec = pl.MultichannelSpec(num_channels=M, taps_per_phase=8, fold="bank")
    hal = pl.full_demod_halo(spec)
    block = 2 * row
    events = [MobileEvent("origination", 1, 700, "5551234567", "7025551000",
                          esn=777),
              MobileEvent("registration", 2, row - 5000, "9165554321",
                          esn=42),
              MobileEvent("page_response", 30, block - 4000, "4155559876")]
    x = synthesize_reverse_band(events, spec, 2 * block, noise_sigma=0.001,
                                device="cpu")
    pairs = superframe_word_pairs()[:2]
    wp = np.broadcast_to(pairs, (M,) + pairs.shape).copy()
    res = {}
    for dev in ("cpu", cuda_device):
        mesh = make_mesh(MeshSpec(2, 2), [dev])
        step = pl.make_sharded_bs_stream_step(mesh, spec, hal, max_bursts=2,
                                              rx_external=True)
        st = pl.sharded_stream_state(spec, hal, mesh.device)
        outs = []
        for b in range(2):
            before = (KA.LAUNCHES, K4.LAUNCHES)
            out, st = step(wp, st, x[b * block * M // 2:
                                     (b + 1) * block * M // 2])
            if mesh.device.type == "cuda":
                torch.cuda.synchronize()
                assert (KA.LAUNCHES - before[0], K4.LAUNCHES - before[1]) \
                    == (4, 4)
            outs.append({k: v.cpu() for k, v in out.items()})
        res[str(dev)] = (outs, {k: (v.cpu() if torch.is_tensor(v) else v)
                                for k, v in st.items()})
    (h_outs, h_st), (c_outs, c_st) = res["cpu"], res[str(cuda_device)]
    n_valid = 0
    for h, c in zip(h_outs, c_outs):
        valid = h["valid"]
        assert torch.equal(c["valid"], valid)
        n_valid += int(valid.sum())
        for k in ("starts", "words", "word_ok", "dcc_bits"):
            assert torch.equal(c[k][valid], h[k][valid]), k
        peak = float(h["tx_wideband"].abs().max())
        assert float((c["tx_wideband"] - h["tx_wideband"]).abs().max()) \
            <= 1e-4 * max(peak, 1.0)
    assert n_valid >= len(events)
    assert torch.equal(c_st["hist"], h_st["hist"])
    assert (c_st["parity"], c_st["tx_parity"]) == (h_st["parity"],
                                                   h_st["tx_parity"])


@pytest.mark.cuda
def test_sharded_receiver_on_card_matches_cpu(cuda_device):
    """ShardedReceiver on card workers reports what it reports on CPU
    workers (M=32, 2x2, two blocks)."""
    from amps_tpu_torch.eval.traffic import MobileEvent
    from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from amps_tpu_torch.parallel.stream import ShardedReceiver
    M, block = 32, 2 * 12480
    spec = pl.MultichannelSpec(num_channels=M, taps_per_phase=8, fold="bank")
    events = [MobileEvent("page_response", 3, 2000, "4155559876"),
              MobileEvent("origination", 9, block - 3000, "5551234567",
                          "7025551000", esn=5)]
    x = synthesize_reverse_band(events, spec, 2 * block, noise_sigma=0.001,
                                device="cpu")
    reps = {}
    for dev in ("cpu", cuda_device):
        rx = ShardedReceiver(make_mesh(MeshSpec(2, 2), [dev]), spec,
                             min_rssi=0.05)
        n = block * M // 2
        reps[str(dev)] = rx.push(x[:n]) + rx.push(x[n:]) + rx.flush()
    h, c = reps["cpu"], reps[str(cuda_device)]
    assert len(h) == len(c) == len(events)
    for a, b in zip(h, c):
        assert (a.channel, a.abs_symbol) == (b.channel, b.abs_symbol)
        assert np.array_equal(a.words, b.words)
        assert np.array_equal(a.word_ok, b.word_ok)


@pytest.mark.cuda
@pytest.mark.parametrize("chmajor,planar,planar_in", [
    (False, False, False), (True, True, False), (True, False, True)])
def test_analyze_with_batch_dims_on_card(cuda_device, chmajor, planar,
                                         planar_in):
    """analyze on a (2, 3) batch of streams launches K1 once a row, and
    equals its plain version (``block=analyze_reference``) in each
    layout."""
    M, T, Nh = 64, 8, 501
    spec = chz.ChannelizerSpec(M, T)
    g = torch.Generator(cuda_device).manual_seed(5)
    x = torch.randn((2, 3, Nh * M // 2, 2), device=cuda_device, generator=g)
    if planar_in:
        x = x.transpose(-1, -2).contiguous()
    kw = dict(chmajor=chmajor, planar=planar, planar_in=planar_in)
    st = chz.analyzer_init(spec, (2, 3), planar_in)
    before = KA.LAUNCHES
    y, st2 = chz.analyze(x, spec, st, **kw)
    torch.cuda.synchronize()
    assert KA.LAUNCHES == before + 6
    ry, _ = chz.analyze(x, spec, st, block=KA.analyze_reference, **kw)
    assert y.shape == ry.shape and y.shape[:2] == (2, 3)
    assert (y - ry).abs().max().item() <= 2e-4
    assert st2.hop_idx == Nh


@pytest.mark.cuda
def test_two_process_step_on_one_card(cuda_device, tmp_path):
    """tests/test_torch_distributed.py's two-process job with both
    processes' workers on cuda:0 at M=64: ``initialize`` picks gloo (two
    processes on one card), the halo and psum cross the processes through
    host copies, the burst across the process boundary decodes and each
    process's TX share equals the single-device transmitter's."""
    import importlib.util
    import pathlib
    here = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "two_process_case", here / "test_torch_distributed.py")
    case = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(case)
    outs = case.run_two_processes(case.step_worker(
        tmp_path, device="cuda:0", M=64, T=8), timeout=300)
    case.check_step_outputs(outs, backend="gloo")


# ---- filters longer than 16 taps a phase -------------------------------
# K1-K3 fold past 16 taps in chunks (an instantiation of their own); K4
# runs one launch a chunk of 16 gain rows and sums them.  T = 17 (a last
# chunk of one tap), 32 (two full chunks), 33; M = 64, the production
# 1024, 2038 (the generic pass, its own library) and 8192 (a cluster)

LONG = [(M, T) for M in (64, 1024, 2038, 8192) for T in (17, 32, 33)]


def _rms(t):
    return t.pow(2).mean().sqrt().item()


@pytest.mark.cuda
@pytest.mark.parametrize("M,T", LONG)
def test_long_filter_analysis_kernel(cuda_device, mixed_libraries, M, T):
    """K1 at T > 16, riq at even parity and planar at odd: within 1.5e-5
    of the plain output's RMS (unit-amplitude channels), one launch a
    call."""
    Nh = 301
    x = unit_channel_band(M, T, Nh, M + T, cuda_device)
    for parity, planar in ((0, False), (1, True)):
        xi = x.t().contiguous() if planar else x
        before = KA.LAUNCHES
        y = KA.analyze_block(xi, M, T, parity, planar, planar)
        torch.cuda.synchronize()
        assert KA.LAUNCHES == before + 1
        ry = KA.analyze_reference(xi, M, T, parity, planar, planar)
        assert y.shape == ry.shape and torch.isfinite(y).all()
        assert (y - ry).abs().max().item() <= 1.5e-5 * _rms(ry)


@pytest.mark.cuda
@pytest.mark.parametrize("M,T", LONG)
def test_long_filter_rx_front_kernel(cuda_device, mixed_libraries, M, T):
    """K2 at T > 16 on FSK in every channel, a random previous sample,
    both parities: demod within 1e-5 of its RMS past the bank's ramp-up
    (fast_atan2's seam rule), the power blocks within 1e-4, the last
    sample within 1e-4 of its RMS."""
    Nh, skip = 500, 2 * T + 2
    x = _fsk_band(M, T, Nh, M + T, cuda_device)
    prev = torch.randn((M, 2), device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(M))
    for parity in (0, 1):
        before = K2.LAUNCHES
        d, last, pw = K2.analyze_demod(x, M, T, parity, prev)
        torch.cuda.synchronize()
        assert K2.LAUNCHES == before + 1
        rd, rlast, rpw = K2.analyze_demod_reference(x, M, T, parity, prev)
        rd = rd[:, skip:]
        _held_to_phase_atol((d[:, skip:] - rd).abs(), rd, 1e-5 * _rms(rd))
        blk, rblk = (window_power_blocks([p[:, skip:]]) for p in (pw, rpw))
        assert ((blk - rblk).abs() / rblk).max().item() <= 1e-4
        assert (last - rlast).abs().max().item() <= 1e-4 * _rms(rlast)


@pytest.mark.cuda
@pytest.mark.parametrize("M,T", LONG)
def test_long_filter_rx_phases_kernel(cuda_device, mixed_libraries, M, T):
    """K3 at T > 16 on FSK in every channel, a ragged hop count, planar
    input at odd parity: f32 phases within 1e-3 past the ramp-up (a seam
    sample moves its symbols by a third of the step, such samples within
    BRANCH_CUT_FRACTION), bf16 within 0.02; the power within 1e-4."""
    Nh = 27 * 20 + 1 + 2 * T
    x = _fsk_band(M, T, Nh, M + T + 1, cuda_device).t().contiguous()
    js = -(-(2 * T + 2) // 3)
    rph, rcp, rpw = K.analyze_phases_reference(x, M, T, 3, 1)
    for dt in (torch.float32, torch.bfloat16):
        before = K.LAUNCHES
        ph, cp, pw = K.analyze_phases(x, M, T, 3, 1, dt)
        torch.cuda.synchronize()
        assert K.LAUNCHES == before + 1
        assert ph.shape == rph.shape and ph.dtype == dt
        err = (ph.float() - rph)[..., js:].abs()
        if dt == torch.bfloat16:
            assert err.max().item() <= 0.02
        else:
            assert err.max().item() <= ATAN_SEAM / 3 + 1e-3
            assert (err > 1e-3).sum().item() \
                <= 3 * BRANCH_CUT_FRACTION * err.numel()
        assert (((pw - rpw).abs() / rpw)[:, 1:]).max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("M,T", LONG)
def test_long_filter_synth_kernel(cuda_device, mixed_libraries, M, T):
    """K4 at T > 16 with a carry in, both parities: ceil(T/16) launches a
    call, the block and the new carry within 2e-5 of the output's RMS."""
    Nh = 333
    g = torch.Generator(cuda_device).manual_seed(M + T)
    Y = torch.randn((Nh, M, 2), device=cuda_device, generator=g)
    carry = torch.randn((M * T - M // 2, 2), device=cuda_device, generator=g)
    for parity in (0, 1):
        before = K4.LAUNCHES
        x, c = K4.synthesize_block(Y, M, T, parity, carry)
        torch.cuda.synchronize()
        assert K4.LAUNCHES == before + -(-T // 16) == \
            before + K4.chunk_launches(T)
        rx, rc = K4.synthesize_block_reference(Y, M, T, parity, carry)
        rms = _rms(rx)
        assert x.shape == rx.shape and c.shape == rc.shape
        assert (x - rx).abs().max().item() <= 2e-5 * rms
        assert (c - rc).abs().max().item() <= 2e-5 * rms


@pytest.mark.cuda
def test_long_filter_chained_calls_equal_one(cuda_device):
    """At M=1024, T=32, two chained calls (an odd first block) equal one
    call: K1 and K2 bit for bit, K4 within 2e-5 of the output's RMS."""
    M, T, N1, N2 = 1024, 32, 1001, 700
    P = M // 2
    x = unit_channel_band(M, T, N1 + N2, 32, cuda_device)
    y = KA.analyze_block(x, M, T, 0)
    ya = KA.analyze_block(x[: (N1 + 2 * T - 1) * P].contiguous(), M, T, 0)
    yb = KA.analyze_block(x[N1 * P:].contiguous(), M, T, N1 % 2)
    assert torch.equal(torch.cat([ya, yb], 1), y)
    zero = torch.zeros((M, 2), device=cuda_device)
    d, last, pw = K2.analyze_demod(x, M, T, 0, zero)
    da, la, pa = K2.analyze_demod(x[: (N1 + 2 * T - 1) * P].contiguous(), M,
                                  T, 0, zero)
    db, lb, pb = K2.analyze_demod(x[N1 * P:].contiguous(), M, T, N1 % 2, la)
    assert torch.equal(torch.cat([da, db], 1), d)
    assert torch.equal(torch.cat([pa, pb], 1), pw)
    assert torch.equal(lb, last)
    g = torch.Generator(cuda_device).manual_seed(32)
    Y = torch.randn((N1 + N2, M, 2), device=cuda_device, generator=g)
    carry = torch.randn((M * T - P, 2), device=cuda_device, generator=g)
    xs, c = K4.synthesize_block(Y, M, T, 0, carry)
    xa, ca = K4.synthesize_block(Y[:N1].contiguous(), M, T, 0, carry)
    xb, cb = K4.synthesize_block(Y[N1:].contiguous(), M, T, N1 % 2, ca)
    rms = _rms(xs)
    assert (torch.cat([xa, xb]) - xs).abs().max().item() <= 2e-5 * rms
    assert (cb - c).abs().max().item() <= 2e-5 * rms


@pytest.mark.cuda
def test_zero_taps_raise(cuda_device):
    """T = 0 is refused by every wrapper on the card; any T >= 1 runs."""
    M, Nh = 64, 16
    x = torch.zeros(((Nh + 2 * 8 - 1) * M // 2, 2), device=cuda_device)
    zero = torch.zeros((M, 2), device=cuda_device)
    with pytest.raises(ValueError, match="T >= 1"):
        KA.analyze_block(x, M, 0)
    with pytest.raises(ValueError, match="T >= 1"):
        K2.analyze_demod(x, M, 0, 0, zero)
    with pytest.raises(ValueError, match="T >= 1"):
        K.analyze_phases(x, M, 0)
    with pytest.raises(ValueError):
        K4.synthesize_block(torch.zeros((Nh, M, 2), device=cuda_device), M,
                            0, 0, torch.zeros((0, 2), device=cuda_device))


@pytest.mark.cuda
def test_stages_captured_in_a_graph_time_each_replay(cuda_device):
    """Two joined ``utils.profiling`` stages captured in a CUDA graph
    inside ``capturing()`` stamp three event nodes, a graph captured
    outside it none; after the replays and a sync, ``collect`` reads a
    positive device time of each, the second longer (it does four times
    the work), and nothing is left pending."""
    profiling.reset()
    a = torch.randn((2048, 2048), device=cuda_device)
    b = torch.empty_like(a)

    def body():
        with profiling.stage("t.one", cuda_device):
            b.copy_(a @ a)
        with profiling.stage("t.four", cuda_device, joined=True):
            for _ in range(4):
                b.copy_(b @ a)

    with torch.cuda.device(cuda_device):
        side = torch.cuda.Stream(device=cuda_device)
        side.wait_stream(torch.cuda.current_stream(cuda_device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(cuda_device).wait_stream(side)
        torch.cuda.synchronize(cuda_device)
        profiling.reset()
        # outside capturing() a captured stage stamps nothing
        plain = torch.cuda.CUDAGraph()
        with torch.cuda.graph(plain):
            body()
        profiling.collect()
        assert profiling.stage_samples("t.one") == []
        assert profiling.COUNTERS["stage_pending"] == 0
        g = torch.cuda.CUDAGraph()
        with profiling.capturing() as stages, \
                torch.cuda.graph(g, pool=plain.pool()):
            body()
        assert [s[0] for s in stages] == ["t.one", "t.four"]
        assert stages[0][2] is stages[1][1]         # one shared event
        call = profiling.begin_call()
        for _ in range(3):
            plain.replay()
        g.replay()
        profiling.replayed(stages)
        torch.cuda.synchronize(cuda_device)
    profiling.collect()
    one, = [ms for c, ms in profiling.stage_samples("t.one") if c == call]
    four, = [ms for c, ms in profiling.stage_samples("t.four") if c == call]
    assert 0 < one < four
    assert profiling.COUNTERS["stage_pending"] == 0
    profiling.reset()


# -- the trigger search kernel ---------------------------------------------

TRIGGER = cor.trigger_template(1)


def _search_rows(shape, O, case, seed):
    """Phase streams (..., sps, nsym) for the trigger search.  Grid cases
    hold values k/64, |k| < 64, and triggers of amplitude 1/2: every f32
    sum of the correlation and of the squares (in bf16 or f32) is then
    exact in any order, so kernel and plain version agree bit for bit.
    ``periodic``: row 0 all zeros, row 1 of period O on every phase with
    a trigger in phase 0 (an offset and the same offset a block later
    tie).  ``noise``: gaussian noise with triggers of amplitude 0.8, 0.5
    and 0.3 added, sums that round."""
    rng = np.random.default_rng(seed)
    sps, nsym = shape[-2], shape[-1]
    if case == "noise":
        x = rng.normal(0, 0.3, shape).astype(np.float32)
    else:
        x = (rng.integers(-63, 64, shape) / 64).astype(np.float32)
    rows = x.reshape(-1, sps, nsym)
    if case == "periodic":
        rows[0] = 0
        period = (rng.integers(-63, 64, (sps, O)) / 64).astype(np.float32)
        period[0, 20:20 + len(TRIGGER)] = TRIGGER / 2
        rows[1] = np.tile(period, -(-nsym // O))[:, :nsym]
        return x
    for r in range(rows.shape[0]):
        for amp in (0.8, 0.5, 0.3):
            p = int(rng.integers(0, sps))
            s0 = int(rng.integers(0, nsym - len(TRIGGER) + 1))
            w = rows[r, p, s0:s0 + len(TRIGGER)]
            if case == "noise":
                w += TRIGGER * amp
            else:
                w[:] = TRIGGER / 2
    return x


def _ulp(v, acc_t):
    """One unit in the last place of |v| in the accumulation dtype."""
    bits = 7 if acc_t == torch.bfloat16 else 23
    e = torch.floor(torch.log2(v.abs().double().clamp(min=1e-30)))
    return torch.pow(2.0, e - bits)


def _tolerance(v, acc_t):
    """How far two orders of the search's f32 sums may put a quality v
    apart: one ulp of a bfloat16 quality; 32 ulp of a float32 quality,
    which carries the sums' own rounding (on the noise rows the two
    orders have put it at most 10 ulp apart on the H100; the worst case
    of two orders of 74-term sums is about 180 ulp)."""
    return _ulp(v, acc_t) * (1 if acc_t == torch.bfloat16 else 32)


def _check_search(got, want, plane, sps, K, threshold, acc_t):
    """starts and valid equal wherever the plain version's top value of a
    round beats every other candidate by more than the tolerance (and
    lies farther than it from the threshold), up to the first round that
    does not; quality within the tolerance there.  Returns the rounds
    checked."""
    L, cap = len(TRIGGER), cor.CAPTURE_SYMBOLS
    gs, gv, gq = (a.cpu().reshape(-1, K) for a in got)
    ws, wv, wq = (a.cpu().reshape(-1, K) for a in want)
    q = plane.cpu().double().reshape(gs.shape[0], -1)      # phase-major
    no = q.shape[-1] // sps
    pos = (torch.arange(sps)[:, None] + sps * torch.arange(no)).reshape(-1)
    checked = 0
    for r in range(q.shape[0]):
        cand = q[r].clone()
        for k in range(K):
            s = int(ws[r, k]) - L * sps
            if torch.isinf(cand).all():        # nothing left: index 0
                assert int(gs[r, k]) == int(ws[r, k]) == L * sps
                assert gq[r, k] == wq[r, k] == float("-inf")
                checked += 1
                continue
            idx = (s % sps) * no + s // sps
            v1 = cand[idx]
            rest = cand.clone()
            rest[idx] = float("-inf")
            u = _tolerance(v1, acc_t)
            if v1 - rest.max() <= 2 * u or abs(v1 - threshold) <= u:
                break
            assert int(gs[r, k]) == int(ws[r, k]), (r, k)
            assert bool(gv[r, k]) == bool(wv[r, k]), (r, k)
            assert abs(float(gq[r, k]) - float(wq[r, k])) <= float(u), (r, k)
            cand[(pos > s - L * sps) & (pos < s + (L + cap) * sps)] = \
                float("-inf")
            checked += 1
    return checked


SEARCH_CASES = {   # shape, corr_block, K, data
    "short": ((4, 1, 124), 128, 1, "grid"),     # under one block of lags
    "loop": ((64, 3, 3703), 128, 2, "grid"),    # the duplex loop's rows
    "tiled": ((2, 3, 20000), 256, 4, "grid"),   # past shared memory
    "batched": ((2, 5, 3, 1500), 256, 4, "grid"),
    "periodic": ((2, 3, 3703), 128, 2, "periodic"),
    "noise": ((64, 3, 3703), 128, 2, "noise"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("data_bf16", [False, True])
@pytest.mark.parametrize("out_bf16", [False, True])
@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_trigger_search_kernel_matches_plain_version_on_card(
        cuda_device, data_bf16, out_bf16, case):
    """The kernel against the plain version on the card, one launch a
    call, on the path ``plan`` chooses: equal outputs on the grid rows
    (ties included), and on the noise rows wherever rounding cannot
    decide a pick."""
    shape, O, K, data = SEARCH_CASES[case]
    sps, threshold = shape[-2], 0.55
    ph = torch.as_tensor(_search_rows(shape, O, data, len(shape) + O + K),
                         device=cuda_device)
    if data_bf16:
        ph = ph.to(torch.bfloat16)
    assert KS.plan(sps, shape[-1], O, K, out_bf16)[0] == (case != "tiled")
    before = KS.LAUNCHES
    got = cor.find_bursts_phases(ph, sps, K, threshold, O, out_bf16)
    torch.cuda.synchronize()
    assert KS.LAUNCHES == before + 1
    want = cor.find_bursts_phases_reference(ph, sps, K, threshold, O,
                                            out_bf16)
    plane = cor.trigger_quality_reference(ph, O, out_bf16)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.device == cuda_device
    acc_t = torch.bfloat16 if out_bf16 else torch.float32
    checked = _check_search(got, want, plane, sps, K, threshold, acc_t)
    rows = int(np.prod(shape[:-2]))
    if data == "noise":
        assert checked >= rows      # every row's first pick is decided
        return
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if data == "periodic":
        # row 0: zeros everywhere, the first index and the first past it;
        # row 1: the trigger's first period, then its first copy past it
        L = len(TRIGGER)
        first_past = -(-(L + cor.CAPTURE_SYMBOLS) * sps // sps)
        assert got[0][0].tolist() == [L * sps, (first_past + L) * sps]
        o2 = 20 + O * -(-first_past // O)
        assert got[0][1].tolist() == [(20 + L) * sps, (o2 + L) * sps]
        assert got[1][1].tolist() == [True, True]


@pytest.mark.cuda
@pytest.mark.parametrize("sps,nsym,O,K,out_bf16,resident", [
    (3, 3703, 128, 2, True, True),     # the duplex loop's rows
    (3, 3703, 128, 4, False, True),
    (1, 124, 128, 1, False, True),     # shorter than one block of lags
    (3, 20000, 128, 4, True, False),   # longer than shared memory: tiles
    (1, 200000, 256, 2, False, False),
    (3, 9000, 2000, 2, True, False),
])
def test_trigger_search_plan(cuda_device, sps, nsym, O, K, out_bf16,
                             resident):
    """The kernel keeps a row in shared memory when its symbols and
    quality fit, else cuts it into tiles of one phase that fit, by the
    library's layout."""
    smem = KS._library()[1]
    got, nb = KS.plan(sps, nsym, O, K, out_bf16)
    nblk = -(-(nsym - 73) // O)
    assert got == resident
    if resident:
        assert nb == nblk
        assert smem(sps, nb, O, K, out_bf16) <= KS.RESIDENT_BYTES
    else:
        assert 1 <= nb <= min(KS.MAX_TILE_BLOCKS, nblk)
        assert smem(1, nb, O, K, out_bf16) <= KS.RESIDENT_BYTES
        assert nb in (KS.MAX_TILE_BLOCKS, nblk) or \
            smem(1, nb + 1, O, K, out_bf16) > KS.RESIDENT_BYTES


@pytest.mark.cuda
def test_trigger_search_plan_refuses_a_block_past_shared_memory(
        cuda_device):
    with pytest.raises(ValueError):
        KS.plan(1, 200000, 20000, 2, False)


@pytest.mark.cuda
def test_trigger_search_launches_no_gemm(cuda_device):
    """On the card the search is the one kernel: no cuBLAS GEMM."""
    ph = torch.as_tensor(_search_rows((256, 3, 3703), 128, "grid", 1),
                         device=cuda_device).to(torch.bfloat16)
    cor.find_bursts_phases(ph, 3, 2, 0.55, out_bf16=True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cor.find_bursts_phases(ph, 3, 2, 0.55, out_bf16=True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("trigger_search_kernel" in n for n in names), names
    assert not any(re.search("gemm|xmma|cutlass|cublas", n, re.I)
                   for n in names), names


@pytest.mark.cuda
def test_closed_loop_graph_counts_search_launches(cuda_device):
    """M=64: the captured block runs the search kernel once, and each
    replay adds one launch to ``LAUNCHES``, as the eager loop does."""
    from amps_tpu_torch.runtime.streamer import make_closed_loop_stream
    spec = pl.MultichannelSpec(num_channels=64, taps_per_phase=8,
                               io_bf16=True, corr_bf16=True)
    nblocks = 3
    eager, _ = make_closed_loop_stream(spec, nblocks, graph=False)
    graphed, _ = make_closed_loop_stream(spec, nblocks)
    before = KS.LAUNCHES
    want = eager(_loop_pairs(64))
    assert KS.LAUNCHES - before == nblocks
    for warm_up in (1, 0):
        before = KS.LAUNCHES
        got = graphed(_loop_pairs(64))
        torch.cuda.synchronize()
        assert KS.LAUNCHES - before == nblocks + warm_up
        assert all(torch.equal(a, b) for a, b in zip(got, want))
