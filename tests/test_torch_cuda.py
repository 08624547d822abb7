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
from amps_tpu_torch.parallel import pipeline as pl
from amps_tpu_torch.rx.correlator import window_power_blocks
from amps_tpu_torch.runtime.streamer import (MultichannelReceiver,
                                             MultichannelTransmitter)

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
        K.analyze_phases(x, 96, 8)          # M not a power of two
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
    y, st = chz.analyze(x, spec, chz.analyzer_init(spec))
    ya, sa = chz.analyze(x[:n1], spec, chz.analyzer_init(spec))
    yb, sb = chz.analyze(x[n1:], spec, sa)
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
    with pytest.raises(ValueError):            # M not a power of two
        KA.analyze_block(torch.zeros(((Nh + 15) * 48, 2), device=cuda_device),
                         96, T)
    with pytest.raises(ValueError):            # not one (n, 2) block
        KA.analyze_block(torch.zeros((2, n, 2), device=cuda_device), M, T)
    with pytest.raises(ValueError):
        KA.analyze_block(torch.zeros((n, 2), device=cuda_device).double(),
                         M, T)


@pytest.mark.cuda
@pytest.mark.parametrize("M,Nh,parity", [
    (64, 300, 0), (256, 1000, 1), (1024, 257, 1), (128, 3, 0),
    (2048, 100, 1)])
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
    Y = torch.zeros((10, 96, 2), device=cuda_device)
    with pytest.raises(ValueError):            # M not a power of two
        K4.synthesize_block(Y, 96, 8, 0,
                            torch.zeros((96 * 8 - 48, 2), device=cuda_device))
    x = torch.zeros(((100 + 15) * 48, 2), device=cuda_device)
    with pytest.raises(ValueError):
        K2.analyze_demod(x, 96, 8, 0, torch.zeros((96, 2), device=cuda_device))


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
def test_widths_not_a_power_of_two_still_raise(cuda_device):
    for M in (12, 24, 48, 4096):
        x = torch.zeros(((100 + 15) * (M // 2), 2), device=cuda_device)
        with pytest.raises(ValueError, match="power of two"):
            KA.analyze_block(x, M, 8)
        with pytest.raises(ValueError, match="power of two"):
            K.analyze_phases(x, M, 8)


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
