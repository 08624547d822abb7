"""The port's streaming receiver against the JAX package's on the CPU
(where the front end is the rx_front kernel's plain version): the same
multi-block reverse-band stream, with bursts straddling blocks,
non-hop-multiple pushes, depth 1 and 2 and flush(pad_tail), gives the
identical report list.  Channel, abs_symbol, words, word_ok, dcc and
the bad-symbol counts are held exactly; quality to 1e-4 and rssi to
1e-4 relative (f32 summation order).  Both sides get fold="bank"."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp.fm import fm_modulate_symbols as jfm
from amps_tpu.eval.traffic import MobileEvent, synthesize_reverse_band
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu.runtime.streamer import MultichannelReceiver as JRx
from amps_tpu.tx import recc_ms
from amps_tpu_torch.parallel.pipeline import MultichannelSpec as TSpec
from amps_tpu_torch.runtime import streamer as S
from amps_tpu_torch.runtime.streamer import MultichannelReceiver as TRx

torch.set_num_threads(1)

M = 16
BLOCK_HOPS = 4095          # odd: the hop parity alternates between blocks
BURST_HOPS = (30 + 11 + 7 + 7 * 240) * 2 * 3
SENS = 2 * np.pi * 8000 / 60000     # FSK phase step at the channel rate


def _specs(bf16=False, m=M):
    kw = dict(num_channels=m, taps_per_phase=8, fold="bank",
              io_bf16=bf16, corr_bf16=bf16)
    return JSpec(**kw), TSpec(**kw)


@functools.cache
def _stream():
    """Four bursts of 10368 hops (2.5 blocks) each, all straddling push
    boundaries; the last one ends 4 hops before the stream does, so only
    flush(pad_tail) completes it."""
    total = 4 * BLOCK_HOPS + 2000
    events = [
        MobileEvent("origination", 3, 900, "5551234567", "16505551234",
                    esn=77),
        MobileEvent("page_response", 11, 3000, "4155559876"),
        MobileEvent("registration", 0, 6000, "2125550000", esn=5),
        MobileEvent("page_response", 15, total - 4 - BURST_HOPS,
                    "7735550000"),
    ]
    x = synthesize_reverse_band(events, _specs()[0], total,
                                noise_sigma=0.001)
    return x, events


def _pushes(x):
    """Blocks of BLOCK_HOPS hops, every other one 3 samples long and the
    next 3 short, then a 5-sample ragged tail."""
    n = BLOCK_HOPS * M // 2
    out, off, k = [], 0, 0
    while off + n + 3 <= len(x) - 5:
        step = n + (3 if k % 2 == 0 else -3)
        out.append(x[off: off + step])
        off += step
        k += 1
    out.append(x[off:])
    return out


def _key(r):
    return (r.channel, r.abs_symbol, r.words.tolist(), r.word_ok.tolist(),
            np.asarray(r.bad_symbols).tolist(), r.dcc)


def _run(rx, blocks, pad_tail=True):
    reps = []
    for b in blocks:
        reps += rx.push(b)
    return reps + rx.flush(pad_tail=pad_tail)


def _assert_same_reports(got, want):
    assert [_key(r) for r in got] == [_key(r) for r in want]
    for a, b in zip(got, want):
        assert abs(a.quality - b.quality) <= 1e-4
        assert abs(a.rssi - b.rssi) <= 1e-4 * abs(b.rssi)


@pytest.mark.parametrize("depth", [1, 2])
def test_receiver_matches_jax(depth):
    x, events = _stream()
    jspec, tspec = _specs()
    blocks = _pushes(x)
    assert any(len(b) % (M // 2) for b in blocks)
    want = _run(JRx(jspec, threshold=0.5, pipeline_depth=depth), blocks)
    got = _run(TRx(tspec, device="cpu", threshold=0.5, pipeline_depth=depth),
               [torch.as_tensor(b) for b in blocks])
    _assert_same_reports(got, want)
    assert sorted(r.channel for r in got) == sorted(e.channel for e in events)
    for ev in events:
        r = next(r for r in got if r.channel == ev.channel)
        w = np.stack(ev.words())
        assert np.array_equal(r.words[: len(w)], w) and r.word_ok[: len(w)].all()
        assert r.dcc == 0


def test_last_burst_needs_pad_tail():
    x, events = _stream()
    _, tspec = _specs()
    blocks = _pushes(x)
    got = _run(TRx(tspec, device="cpu", threshold=0.5), blocks, pad_tail=False)
    assert events[-1].channel not in [r.channel for r in got]
    assert len(got) == len(events) - 1


def test_receiver_bf16_spec_decodes_same_words():
    x, events = _stream()
    jspec, tspec = _specs(bf16=True)
    blocks = _pushes(x)
    want = _run(JRx(jspec, threshold=0.5), blocks)
    got = _run(TRx(tspec, device="cpu", threshold=0.5), blocks)
    assert [(r.channel, r.words.tolist(), r.word_ok.tolist()) for r in got] \
        == [(r.channel, r.words.tolist(), r.word_ok.tolist()) for r in want]
    assert len(got) == len(events)


def test_demod_tap_matches_jax(tmp_path):
    """The demod tap files of the two receivers: (M, Nh) float32 per
    block.  Inside the bursts the demod agrees to 1e-4; the noise-only
    samples (σ 0.001, ~70 dB below the bursts) carry the f32 roundoff of
    the strong channels and branch cuts, so there only 1e-3 of them may
    differ by more than 0.05."""
    x, events = _stream()
    jspec, tspec = _specs()
    blocks = _pushes(x)[:3]
    pj, pt = str(tmp_path / "j.f32"), str(tmp_path / "t.f32")
    rj = JRx(jspec, threshold=0.5, tap_demod_path=pj)
    rt = TRx(tspec, device="cpu", threshold=0.5, tap_demod_path=pt)
    _run(rj, blocks, pad_tail=False)
    _run(rt, blocks, pad_tail=False)
    rj.close()
    rt.close()
    a, b = np.fromfile(pt, np.float32), np.fromfile(pj, np.float32)
    # flush() completes the sub-hop residue's hop with zeros
    n = sum(len(k) for k in blocks)
    nh = -(-n // (M // 2))
    assert a.shape == b.shape == (M * nh,)
    sizes = [BLOCK_HOPS] * 3 + [nh - 3 * BLOCK_HOPS]

    def series(f):   # per-block (M, Nh_i) planes -> (M, nh)
        parts = np.split(f, np.cumsum([M * h for h in sizes])[:-1])
        return np.concatenate([p.reshape(M, -1) for p in parts], axis=1)

    err = np.abs(series(a) - series(b))
    burst = np.zeros_like(err, dtype=bool)
    for ev in events:
        burst[ev.channel, ev.start_hop + 20: ev.start_hop + BURST_HOPS] = True
    assert burst.sum() > 4 * BLOCK_HOPS
    assert err[burst].max() <= 1e-4
    assert (err[~burst] > 0.05).mean() <= 1e-3


def _reverse_band(bursts, total_hops, m=8):
    """Bursts {channel: (start_hop, words, amplitude)} on an m-channel
    bank, synthesized by the JAX package."""
    spec = _specs(m=m)[0]
    Y = np.zeros((total_hops, m, 2), np.float32)
    for k, (start, syms, amp) in bursts.items():
        bb = np.asarray(jfm(syms.astype(np.int8), SENS)[0])
        n = min(len(bb), total_hops - start)
        Y[start: start + n, k] = amp * bb[:n]
    x, _ = jchz.synthesize(Y, spec.chz_spec,
                           jchz.synthesizer_init(spec.chz_spec))
    return np.asarray(x)


def _both(m, **kw):
    jspec, tspec = _specs(m=m)
    return JRx(jspec, **kw), TRx(tspec, device="cpu", **kw)


def test_overflow_path_is_lossless():
    """max_reports=1 with two simultaneous bursts: the drain fetches the
    full planes, counts the overflow, and delivers what the roomy
    receiver delivers."""
    wa = recc_ms.page_response_words("5551234567")
    wb = recc_ms.page_response_words("4155559876")
    x = _reverse_band({2: (2000, recc_ms.burst_symbols(wa, 0, 3), 1.0),
                       5: (2000, recc_ms.burst_symbols(wb, 0, 3), 1.0)},
                      40000)
    _, roomy = _both(8, threshold=0.5)
    full = roomy.push(x) + roomy.flush()
    jx, tight = _both(8, threshold=0.5, max_reports=1)
    got = tight.push(x) + tight.flush()
    want = jx.push(x) + jx.flush()
    assert roomy.report_overflows == 0 and tight.report_overflows >= 1
    assert len(got) == 2 and {r.channel for r in got} == {2, 5}
    assert [_key(r) for r in got] == [_key(r) for r in full]
    _assert_same_reports(got, want)
    assert tight.report_overflows == jx.report_overflows


def test_rssi_gate_survives_block_edge_deferral():
    """A burst cut by the block edge is found in the next window, whose
    new samples are idle; its rssi is measured over its own capture."""
    blk = 16384
    words = recc_ms.registration_words("2135551212", esn=0xBEEF)
    syms = recc_ms.burst_symbols(words, dcc=0, sps=3)
    start = 2 * blk - (82 * 3 + 3374 * 3) + 6
    x = _reverse_band({3: (start, syms, 1.0)}, 3 * blk)
    P = 4
    for rx in _both(8, threshold=0.5, min_rssi=0.05):
        reps = []
        for i in range(3):
            reps += rx.push(x[i * blk * P: (i + 1) * blk * P])
        assert len(reps) == 1 and reps[0].channel == 3
        assert reps[0].rssi >= 0.05 and reps[0].dcc == 0
        for i, w in enumerate(words):
            assert np.array_equal(np.asarray(reps[0].words[i]), np.asarray(w))


def test_rssi_gate_strict_for_fresh_samples():
    """A ghost-level burst right after a loud one on the same channel is
    dropped by min_rssi; only the loud one reports."""
    words = recc_ms.page_response_words("5551234567")
    syms = recc_ms.burst_symbols(words, dcc=0, sps=3)
    Y = np.zeros((3 * 16384, 8, 2), np.float32)
    bb = np.asarray(jfm(syms.astype(np.int8), SENS)[0])
    Y[500: 500 + len(bb), 3] = bb
    Y[17000: 17000 + len(bb), 3] = 0.01 * bb
    spec = _specs(m=8)[0]
    x = np.asarray(jchz.synthesize(Y, spec.chz_spec,
                                   jchz.synthesizer_init(spec.chz_spec))[0])
    got = {}
    for name, rx in zip(("jax", "port"), _both(8, threshold=0.5,
                                                 min_rssi=0.05)):
        reps = []
        for i in range(3):
            reps += rx.push(x[i * 16384 * 4: (i + 1) * 16384 * 4])
        got[name] = reps
    assert [r.abs_symbol < 6000 for r in got["port"] if r.channel == 3] \
        == [True]
    _assert_same_reports(got["port"], got["jax"])


def test_word_a_gate_drops_undecodable_splatter():
    """A clean trigger with a noise payload is dropped by the Word A
    gate; require_word_a=False delivers it, honestly not word_ok."""
    words = recc_ms.page_response_words("5551234567")
    rng = np.random.default_rng(11)
    base = recc_ms.burst_symbols(words, dcc=0, sps=3)
    noise = np.repeat(rng.choice(np.array([-1, 1], np.int8), 3500), 3)
    fake = np.concatenate([base[:82 * 3], noise]).astype(np.int8)
    x = _reverse_band({3: (2000, base, 1.0), 5: (2000, fake, 1.0)}, 40000)
    for require in (True, False):
        jr, tr = _both(8, threshold=0.5, min_rssi=0.05,
                       require_word_a=require)
        want = jr.push(x) + jr.flush(pad_tail=True)
        got = tr.push(x) + tr.flush(pad_tail=True)
        _assert_same_reports(got, want)
        assert sorted(r.channel for r in got) == ([3] if require else [3, 5])
        if not require:
            assert not next(r for r in got if r.channel == 5).word_ok[0]


def test_on_burst_and_reports_attribute():
    x, events = _stream()
    seen = []
    rx = TRx(_specs()[1], threshold=0.5, device="cpu", on_burst=seen.append)
    reps = _run(rx, _pushes(x))
    assert seen == reps == rx.reports and len(reps) == len(events)


@pytest.mark.parametrize("host", ["numpy", "tensor"])
def test_receiver_refuses_block_on_another_device(host):
    """A receiver on the CPU copies host data (a numpy array or a CPU
    tensor) to its device and never takes a block lying on another
    device: work handed over on a device is not moved off it."""
    x, _ = _stream()
    rx = TRx(_specs()[1], threshold=0.5, device="cpu")
    n = BLOCK_HOPS * M // 2
    rx.push(x[:n] if host == "numpy" else torch.as_tensor(x[:n]))
    assert rx.device == torch.device("cpu")
    assert rx._carry.device == torch.device("cpu")
    with pytest.raises(ValueError, match="receiver on cpu"):
        rx.push(torch.zeros((n, 2), device="meta"))


def test_entry_points_without_cuda_raise(monkeypatch):
    """Without CUDA, a transmitter or receiver built without a device
    raises: the entry points run on the card unless the CPU is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.MultichannelTransmitter(_specs()[1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRx(_specs()[1])


def test_front_end_argument_runs_every_push():
    """The front_end argument is the receive front end of every push,
    the pad_tail push included, and the plain front end gives the
    default receiver's report list."""
    from amps_tpu_torch.kernels.rx_front import analyze_demod_reference
    x, events = _stream()
    blocks = [torch.as_tensor(b) for b in _pushes(x)]
    calls = []

    def front_end(*args):
        calls.append(args[0].shape[0])
        return analyze_demod_reference(*args)

    got = _run(TRx(_specs()[1], threshold=0.5, device="cpu", front_end=front_end), blocks)
    assert len(calls) == len(blocks) + 1
    want = _run(TRx(_specs()[1], threshold=0.5, device="cpu"), blocks)
    assert [_key(r) for r in got] == [_key(r) for r in want]
    assert len(got) == len(events)


def test_search_argument_runs_every_push():
    """The search argument is the trigger search of every push, the
    pad_tail push included, with the receiver's K and threshold, and the
    plain search gives the default receiver's report list."""
    from amps_tpu_torch.rx.correlator import find_bursts_phases_reference
    x, events = _stream()
    blocks = [torch.as_tensor(b) for b in _pushes(x)]
    calls = []

    def search(phases, sps, max_bursts, threshold, **kw):
        calls.append((max_bursts, threshold))
        return find_bursts_phases_reference(phases, sps, max_bursts,
                                            threshold, **kw)

    got = _run(TRx(_specs()[1], max_bursts=3, threshold=0.5, device="cpu",
                   search=search), blocks)
    assert calls == [(3, 0.5)] * (len(blocks) + 1)
    want = _run(TRx(_specs()[1], max_bursts=3, threshold=0.5,
                    device="cpu"), blocks)
    assert [_key(r) for r in got] == [_key(r) for r in want]
    assert len(got) == len(events)


def test_receiver_rejects_other_folds():
    """Every fold name of the JAX package is taken (below); any other
    name raises."""
    with pytest.raises(ValueError, match="unknown fold"):
        TRx(dataclasses.replace(_specs()[1], fold="fft"), device="cpu")


@pytest.mark.parametrize("fold", [None, "conv", "shift", "bank", "bank2",
                                  "bankp"])
def test_receiver_every_fold_matches_jax(fold):
    """The default spec (fold None here: the dataclass default, "conv")
    and every fold name through push + flush, against the JAX receiver
    built with that same fold, at the bank fold's tolerances: two bursts,
    one cut by the push boundary and found in the next window."""
    kw = dict(num_channels=8, taps_per_phase=8)
    if fold is not None:
        kw["fold"] = fold
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    assert tspec.fold == jspec.fold == (fold or "conv")
    wa = recc_ms.page_response_words("5551234567")
    wb = recc_ms.registration_words("2135551212", esn=0xBEEF)
    x = _reverse_band({2: (2000, recc_ms.burst_symbols(wa, 0, 3), 1.0),
                       5: (9000, recc_ms.burst_symbols(wb, 0, 3), 1.0)},
                      3 * 8192)
    blocks = [x[i * 8192 * 4: (i + 1) * 8192 * 4] for i in range(3)]
    want = _run(JRx(jspec, threshold=0.5), blocks)
    got = _run(TRx(tspec, device="cpu", threshold=0.5), blocks)
    assert sorted(r.channel for r in got) == [2, 5]
    _assert_same_reports(got, want)


def test_decode_dcc_matches_jax():
    from amps_tpu.runtime.streamer import decode_dcc as jdcc
    rng = np.random.default_rng(2)
    for bits in rng.integers(0, 2, (64, 7)):
        assert S.decode_dcc(bits) == jdcc(bits)
