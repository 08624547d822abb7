"""The voice-supervision receive path of the port's streaming receiver
(``supervision_slots`` + ``on_supervision``, ``deliver_supervision_frames``,
the snapshot's supervision carry, ``ResilientReceiver``'s exactly-once
delivery) against the JAX receiver on the CPU, on the scenarios of
tests/test_voice.py and tests/test_state.py.

The callback lists of the two receivers are equal in order and slots.
On a slot that carries a signal the levels are held to 2e-3 and the
frame power to 2e-3 of its scale (two f32 analysis orders, then 600- and
7200-term projections of a demod divided by the 0.84 rad sensitivity).
An idle slot demodulates the roundoff of its neighbours' leakage, which
no two summation orders share, so there only the shapes are held."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.config import PipelineConfig as JPipe
from amps_tpu.config import SystemConfig as JSystem
from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp.fm import fm_modulate as jfm
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu.runtime.state import snapshot_receiver as jsnapshot
from amps_tpu.runtime.streamer import MultichannelReceiver as JRx
from amps_tpu.runtime.streamer import deliver_supervision_frames as jdeliver
from amps_tpu.tx.voice import voice_channel_baseband as jvoice
from amps_tpu_torch import convert
from amps_tpu_torch.control.supervision import ChannelSupervisor
from amps_tpu_torch.parallel.pipeline import MultichannelSpec as TSpec
from amps_tpu_torch.runtime import state as tstate
from amps_tpu_torch.runtime.resilient import ResilientReceiver
from amps_tpu_torch.runtime.streamer import MultichannelReceiver as TRx
from amps_tpu_torch.runtime.streamer import deliver_supervision_frames

torch.set_num_threads(1)

M = 8
KW = dict(num_channels=M, taps_per_phase=8)
P = M // 2
LEVEL_ATOL = 2e-3


def _voice_band(seconds=0.4, slot=2):
    """tests/test_voice.py: a 700 Hz tone + SAT (SCC 1) on one slot."""
    t = np.arange(int(seconds * 16000)) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 700 * t)).astype(np.float32)
    bb = np.asarray(jvoice(audio, JSystem(scc=1), JPipe())[0])
    Y = np.zeros((len(bb), M, 2), np.float32)
    Y[:, slot] = bb
    spec = JSpec(**KW)
    x, _ = jchz.synthesize(Y, spec.chz_spec,
                           jchz.synthesizer_init(spec.chz_spec))
    x = np.asarray(x)
    return x[: len(x) // P * P]


def _sat_band(n=8 * 4096, slot=5):
    """tests/test_state.py: a bare 6 kHz SAT at 0.05 on one slot."""
    spec = JSpec(**KW)
    fs = float(spec.pipe.chan_rate)
    sens = 2.0 * np.pi * spec.pipe.deviation_hz / fs
    m = 0.05 * np.cos(2 * np.pi * 6000.0 * np.arange(n) / fs)
    Y = np.zeros((n, M, 2), np.float32)
    Y[:, slot] = np.asarray(jfm(jnp.asarray(m, jnp.float32), sens)[0])
    x, _ = jchz.synthesize(jnp.asarray(Y), spec.chz_spec,
                           jchz.synthesizer_init(spec.chz_spec))
    x = np.asarray(x)
    blk = 4096 * P
    return [x[i: i + blk] for i in range(0, n * P, blk)]


def _collect(rx_cls, blocks, slots, **kw):
    calls = []
    rx = rx_cls(supervision_slots=slots,
                on_supervision=lambda s, lv, pw: calls.append(
                    (s, np.asarray(lv), np.asarray(pw))), **kw)
    for b in blocks:
        rx.push(b)
    return calls, rx


def _assert_same_calls(got, want, signal_slots):
    assert [c[0] for c in got] == [c[0] for c in want]
    for (s, lv, pw), (_, wlv, wpw) in zip(got, want):
        assert lv.shape == wlv.shape and pw.shape == wpw.shape
        assert lv.dtype == np.float32 and pw.dtype == np.float32
        if s in signal_slots:
            assert np.abs(lv - wlv).max() <= LEVEL_ATOL, s
            assert np.abs(pw - wpw).max() <= LEVEL_ATOL * max(1.0, wpw.max())


@pytest.mark.parametrize("depth", [1, 2])
def test_receiver_supervision_hook_matches_jax(depth):
    """tests/test_voice.py's hook scenario, in ragged pushes (so the
    sub-frame carry works), at depth 1 and 2."""
    x = _voice_band()
    cuts = [0, 7001 * P, 12000 * P, len(x)]
    blocks = [x[a:b] for a, b in zip(cuts, cuts[1:])]

    def run(cls, spec, **kw):
        calls, rx = _collect(cls, blocks, (2, 5), spec=spec,
                             pipeline_depth=depth, **kw)
        rx.flush()
        return calls

    want = run(JRx, JSpec(**KW))
    got = run(TRx, TSpec(**KW), device="cpu")
    assert [c[0] for c in got] == [2, 5] * 3
    _assert_same_calls(got, want, {2})
    lv2 = np.concatenate([c[1] for c in got if c[0] == 2])
    pw2 = np.concatenate([c[2] for c in got if c[0] == 2])
    assert len(lv2) == len(x) // P // 600          # no frame dropped
    mid = slice(len(lv2) // 4, 3 * len(lv2) // 4)
    assert abs(np.median(lv2[mid, 1]) - 0.05) < 0.015
    assert np.median(lv2[mid, 0]) < 0.025 and np.median(lv2[mid, 2]) < 0.025
    # the measured frames drive a supervisor: the call holds on SAT
    sup = ChannelSupervisor(355, scc=1)
    sup.push_frames(lv2[mid], pw2[mid])
    assert sup.state == "conversation"
    assert not any(e.kind == "release" for e in sup.events)


def test_deliver_supervision_frames_matches_jax():
    rng = np.random.default_rng(3)
    spec_j, spec_t = JSpec(**KW), TSpec(**KW)
    carry_j = carry_t = np.zeros((2, 0), np.float32)
    for n in (1000, 150, 2500, 10):         # one push holds no whole frame
        t = np.arange(n) / 60000.0
        dem = (0.84 * 0.05 * np.cos(2 * np.pi * 6000 * t)
               + rng.normal(0, 0.05, (2, n))).astype(np.float32)
        cj, ct = [], []
        carry_j = jdeliver(dem, carry_j, spec_j, (4, 1),
                           lambda *a: cj.append(a))
        carry_t = deliver_supervision_frames(torch.as_tensor(dem), carry_t,
                                             spec_t, (4, 1),
                                             lambda *a: ct.append(a))
        assert isinstance(carry_t, np.ndarray)
        assert np.array_equal(carry_t, np.asarray(carry_j))
        assert [c[0] for c in ct] == [c[0] for c in cj]
        for (_, lv, pw), (_, wlv, wpw) in zip(ct, cj):
            assert np.abs(lv - np.asarray(wlv)).max() <= 1e-5
            assert np.abs(pw - np.asarray(wpw)).max() <= 1e-5
    assert carry_t.shape == (2, (1000 + 150 + 2500 + 10) % 600)
    # no callback: the carry still advances
    assert deliver_supervision_frames(dem, carry_t, spec_t, (4, 1),
                                      None).shape[1] == (carry_t.shape[1]
                                                         + 10) % 600


def test_snapshot_carries_the_supervision_leftover():
    """A receiver restored from a snapshot between two pushes delivers
    the frames of an uninterrupted one; a JAX snapshot's supervision
    carry crosses over too."""
    blocks = _sat_band(4 * 4096)
    spec = TSpec(**KW)
    ref, _ = _collect(TRx, blocks, (5,), spec=spec, device="cpu")
    first, rx = _collect(TRx, blocks[:2], (5,), spec=spec, device="cpu")
    snap = tstate.snapshot_receiver(rx)
    assert snap["sup_carry"].shape == (1, 2 * 4096 % 600)
    rest = []
    rx2 = TRx(spec, device="cpu", supervision_slots=(5,),
              on_supervision=lambda s, lv, pw: rest.append((s, lv, pw)))
    tstate.restore_receiver(snap, rx2)
    for b in blocks[2:]:
        rx2.push(b)
    got = first + rest
    assert len(got) == len(ref)
    for (_, lv, pw), (_, wlv, wpw) in zip(got, ref):
        assert np.array_equal(lv, wlv) and np.array_equal(pw, wpw)
    # a receiver without supervision slots keeps none
    plain = TRx(spec, device="cpu")
    tstate.restore_receiver(snap, plain)
    assert plain._sup_carry is None
    assert tstate.snapshot_receiver(plain)["sup_carry"].shape == (0, 0)
    # from a JAX receiver's snapshot
    _, jrx = _collect(JRx, blocks[:2], (5,), spec=JSpec(**KW))
    rest_j = []
    rx3 = TRx(spec, device="cpu", supervision_slots=(5,),
              on_supervision=lambda s, lv, pw: rest_j.append((s, lv, pw)))
    convert.receiver_state_from_jax(jsnapshot(jrx), rx3)
    assert np.array_equal(rx3._sup_carry, jrx._sup_carry)
    for b in blocks[2:]:
        rx3.push(b)
    _assert_same_calls(rest_j, rest, {5})


def test_supervision_slots_are_checked():
    with pytest.raises(ValueError, match="outside the bank"):
        TRx(TSpec(**KW), device="cpu", supervision_slots=(1, M))


@pytest.mark.parametrize("flaky", [False, True])
def test_resilient_receiver_supervision_exactly_once(flaky, monkeypatch):
    """tests/test_state.py: a recovery's replay must not deliver the
    frames of blocks already delivered; the failing run delivers the
    uninterrupted JAX run's frames, once each."""
    blocks = _sat_band()
    want, _ = _collect(JRx, blocks, (5,), spec=JSpec(**KW), threshold=0.5)
    frames = []

    def make():
        return TRx(TSpec(**KW), threshold=0.5, device="cpu",
                   supervision_slots=(5,),
                   on_supervision=lambda s, lv, pw: frames.append(
                       (s, lv, pw)))

    res = ResilientReceiver(make, checkpoint_blocks=3)
    calls, orig = {"n": 0}, TRx.push

    def flaky_push(self, b):
        calls["n"] += 1
        if flaky and calls["n"] == 5:
            raise RuntimeError("injected device loss")
        return orig(self, b)

    monkeypatch.setattr(TRx, "push", flaky_push)
    for b in blocks:
        res.push(b)
    assert res.recoveries == int(flaky)
    assert len(frames) == len(want) == len(blocks)
    _assert_same_calls(frames, want, {5})


def test_resilient_receiver_callback_exception_is_not_a_device_failure():
    """tests/test_state.py: an exception of the supervision callback
    surfaces once, with the block's reports attached, triggers no rebuild,
    and every frame is still delivered exactly once."""
    blocks = _sat_band()

    def run(poison_at):
        frames = []

        def cb(s, lv, pw):
            frames.append((lv, pw))
            if len(frames) == poison_at:
                raise RuntimeError("station handler bug")

        res = ResilientReceiver(
            lambda: TRx(TSpec(**KW), threshold=0.5, device="cpu",
                        supervision_slots=(5,), on_supervision=cb),
            checkpoint_blocks=3)
        raised = 0
        for b in blocks:
            try:
                res.push(b)
            except RuntimeError as e:
                assert "station handler bug" in str(e)
                assert isinstance(e.burst_reports, list)
                raised += 1
        assert res.rx.on_supervision is cb      # the guard is taken off
        return frames, res.recoveries, raised

    ref, rec0, raised0 = run(poison_at=0)
    assert rec0 == 0 and raised0 == 0 and len(ref) > 2
    got, recoveries, raised = run(poison_at=2)
    assert (raised, recoveries) == (1, 0) and len(got) == len(ref)
    for (lv_a, pw_a), (lv_b, pw_b) in zip(ref, got):
        assert np.array_equal(lv_a, lv_b) and np.array_equal(pw_a, pw_b)
