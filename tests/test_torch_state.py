"""Checkpoint/resume, elastic recovery and the carry-over of the JAX
side's streaming state, on the CPU.  A resumed or recovered stream
gives the report list of an uninterrupted one, each report once.  Two
tests show where the port follows the fix of a known defect of the JAX
package (ADVICE.md r5, findings 1 and 2) and the JAX package does
not."""

import functools

import numpy as np
import pytest
import torch

from amps_tpu.eval.traffic import MobileEvent, synthesize_reverse_band
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu.runtime import resilient as jres
from amps_tpu.runtime import state as jstate
from amps_tpu.runtime.streamer import MultichannelReceiver as JRx
from amps_tpu.runtime.streamer import MultichannelTransmitter as JTx
from amps_tpu_torch import convert
from amps_tpu_torch.codec import words as TW
from amps_tpu_torch.parallel.pipeline import MultichannelSpec as TSpec
from amps_tpu_torch.runtime import state as tstate
from amps_tpu_torch.runtime.resilient import ResilientReceiver
from amps_tpu_torch.runtime.streamer import MultichannelReceiver as TRx
from amps_tpu_torch.runtime.streamer import MultichannelTransmitter as TTx
from amps_tpu_torch.tx.focc import STREAM_BOTH

torch.set_num_threads(1)

M = 8
P = M // 2
BLOCK = 4096 * P
BURST_HOPS = (30 + 11 + 7 + 7 * 240) * 2 * 3
KW = dict(num_channels=M, taps_per_phase=8, fold="bank")
JSPEC, TSPEC = JSpec(**KW), TSpec(**KW)


@functools.cache
def _stream():
    """6 blocks of 4096 hops; three bursts straddling blocks, the last
    ending 4 hops before the stream does (flush(pad_tail) completes
    it)."""
    total = 6 * 4096
    events = [MobileEvent("page_response", 2, 1500, "5551234567"),
              MobileEvent("registration", 5, 9000, "2135551212", esn=9),
              MobileEvent("origination", 1, total - 4 - BURST_HOPS,
                          "4155559876", "16505550000")]
    x = synthesize_reverse_band(events, JSPEC, total, noise_sigma=0.001)
    return [x[i: i + BLOCK] for i in range(0, len(x), BLOCK)], events


def _keys(reps):
    return [(r.channel, r.abs_symbol, r.words.tolist(), r.word_ok.tolist(),
             r.dcc) for r in reps]


def _run(rx, blocks, pad_tail=True):
    out = []
    for b in blocks:
        out += rx.push(b)
    return out + rx.flush(pad_tail=pad_tail)


def test_receiver_checkpoint_resume(tmp_path):
    blocks, events = _stream()
    full = _run(TRx(TSPEC, device="cpu", threshold=0.5), blocks)
    assert len(full) == len(events)
    a = TRx(TSPEC, device="cpu", threshold=0.5)
    got = []
    for b in blocks[:3]:
        got += a.push(b)
    path = str(tmp_path / "rx.npz")
    tstate.save_receiver(path, a)
    b_ = TRx(TSPEC, device="cpu", threshold=0.5)
    tstate.load_receiver(path, b_)
    got += _run(b_, blocks[3:])
    assert _keys(got) == _keys(full)


def test_snapshot_refuses_inflight_blocks():
    blocks, _ = _stream()
    rx = TRx(TSPEC, device="cpu", threshold=0.5, pipeline_depth=2)
    rx.push(blocks[0])
    with pytest.raises(ValueError, match="in-flight"):
        tstate.snapshot_receiver(rx)


def _page_words():
    from amps_tpu.ref import words_ref
    min1, min2 = words_ref.parse_min("5551234567")
    return [TW.focc_word1(True, 0, min1).numpy(),
            TW.focc_word2_general(min2, 0, 0, 0).numpy()]


def test_transmitter_checkpoint_resume(tmp_path):
    tx_full = TTx(TSPEC, device="cpu", control_channels=[1, 6])
    tx_a = TTx(TSPEC, device="cpu", control_channels=[1, 6])
    for tx in (tx_full, tx_a):
        tx.next_block()
        tx.focc[1].push_words(STREAM_BOTH, _page_words(), repeats=3)
        tx.focc[6].mark_busy(2)
    path = str(tmp_path / "tx.npz")
    tstate.save_transmitter(path, tx_a)
    tx_b = TTx(TSPEC, device="cpu", control_channels=[1, 6])
    tstate.load_transmitter(path, tx_b)
    assert tx_b.focc[1].queue_depth() == 2
    for _ in range(2):
        assert torch.equal(tx_full.next_block(), tx_b.next_block())


def test_transmitter_state_from_jax(tmp_path):
    """A JAX transmitter's checkpoint continues in the port: synthesis
    carry, hop index, accumulators and queued words."""
    jtx = JTx(JSPEC, control_channels=[0, 3])
    jtx.next_block()
    jtx.focc[3].push_words(STREAM_BOTH, _page_words(), repeats=2)
    path = str(tmp_path / "jtx.npz")
    jstate.save_transmitter(path, jtx)
    ttx = TTx(TSPEC, device="cpu", control_channels=[0, 3])
    with np.load(path) as z:
        convert.transmitter_state_from_jax(z, ttx)
    assert ttx._state.hop_idx == jtx._state.hop_idx
    for _ in range(2):
        np.testing.assert_allclose(ttx.next_block().numpy(),
                                   np.asarray(jtx.next_block()), atol=2e-4)


def test_receiver_state_from_jax():
    """A JAX receiver's block k continues as the port's block k+1: the
    two halves give the JAX receiver's uninterrupted report list."""
    blocks, events = _stream()
    want = _run(JRx(JSPEC, threshold=0.5), blocks)
    assert len(want) == len(events)
    jrx = JRx(JSPEC, threshold=0.5)
    got = []
    for b in blocks[:2]:                 # block 1 ends inside two bursts
        got += jrx.push(b)
    snap = jstate.snapshot_receiver(jrx)
    trx = TRx(TSPEC, device="cpu", threshold=0.5)
    convert.receiver_state_from_jax(snap, trx)
    got += _run(trx, blocks[2:])
    assert _keys(got) == _keys(want)


def _flaky(fail_at, fails):
    """Patch MultichannelReceiver.push to raise on its fail_at-th call,
    `fails` times in a row; returns the restore function."""
    calls = {"n": 0, "left": fails}
    orig = TRx.push

    def push(self, b):
        calls["n"] += 1
        if calls["n"] == fail_at and calls["left"] > 0:
            calls["left"] -= 1
            calls["n"] -= 1
            raise RuntimeError("injected device loss")
        return orig(self, b)

    TRx.push = push
    return lambda: setattr(TRx, "push", orig)


def test_resilient_receiver_recovers_from_push_failure():
    blocks, events = _stream()
    want = _run(TRx(TSPEC, device="cpu", threshold=0.5), blocks)
    seen = []
    res = ResilientReceiver(lambda: TRx(TSPEC, device="cpu", threshold=0.5),
                            checkpoint_blocks=2, on_burst=seen.append)
    restore = _flaky(fail_at=4, fails=2)
    try:
        got = []
        for b in blocks:
            got += res.push(b)
        got += res.flush()
    finally:
        restore()
    assert res.recoveries == 2
    assert _keys(got) == _keys(want) == _keys(seen)
    assert len(got) == len(events)


def test_resilient_receiver_replays_tensor_blocks():
    """Tensor blocks go to the receiver as they are; after a failure the
    ring's host copies are replayed into the fresh receiver, which copies
    them to its own device, and the report list is that of an
    uninterrupted run."""
    blocks, events = _stream()
    want = _run(TRx(TSPEC, device="cpu", threshold=0.5), blocks)
    res = ResilientReceiver(lambda: TRx(TSPEC, device="cpu", threshold=0.5),
                            checkpoint_blocks=4)
    restore = _flaky(fail_at=3, fails=1)
    try:
        got = []
        for b in blocks:
            got += res.push(torch.as_tensor(b))
        got += res.flush()
    finally:
        restore()
    assert res.recoveries == 1 and res.rx.device == torch.device("cpu")
    assert _keys(got) == _keys(want) and len(got) == len(events)


def test_resilient_final_failure_leaves_ring_clean():
    blocks, _ = _stream()
    res = ResilientReceiver(lambda: TRx(TSPEC, device="cpu", threshold=0.5),
                            max_retries=1)
    restore = _flaky(fail_at=1, fails=5)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            res.push(blocks[0])
    finally:
        restore()
    assert res._ring == []


def test_resilient_rejects_misconfigured_factory():
    with pytest.raises(ValueError):
        ResilientReceiver(lambda: TRx(TSPEC, device="cpu", pipeline_depth=2))
    with pytest.raises(ValueError):
        ResilientReceiver(lambda: TRx(TSPEC, device="cpu", on_burst=print))


def test_flush_pads_when_stream_ends_on_checkpoint_boundary():
    """ADVICE r5 finding 1: 6 blocks at checkpoint_blocks=3 leave the
    replay ring empty at the end of the stream.  The JAX
    ResilientReceiver.flush then skips the pad and never reports the
    burst pending in the carried overlap; the port pads on the last
    block's length alone and reports it."""
    blocks, events = _stream()
    jr = jres.ResilientReceiver(lambda: JRx(JSPEC, threshold=0.5),
                                checkpoint_blocks=3)
    tr = ResilientReceiver(lambda: TRx(TSPEC, device="cpu", threshold=0.5),
                           checkpoint_blocks=3)
    want, got = [], []
    for b in blocks:
        want += jr.push(b)
        got += tr.push(b)
    assert jr._ring == [] and tr._ring == []
    want += jr.flush()
    got += tr.flush()
    assert events[-1].channel not in [r.channel for r in want]
    assert sorted(r.channel for r in got) == sorted(e.channel
                                                    for e in events)
    assert _keys(got[: len(want)]) == _keys(want)


def test_snapshot_keeps_sub_hop_residue():
    """ADVICE r5 finding 2: a block that is not a multiple of the hop
    leaves a residue.  The JAX snapshot raises on it, after the block's
    reports were delivered, so ResilientReceiver.push fails on every
    such block; the port snapshots the residue and streams on, with
    the report list of an uninterrupted run."""
    blocks, events = _stream()
    x = np.concatenate(blocks)
    ragged = [x[i: i + BLOCK + 3] for i in range(0, len(x), BLOCK + 3)]
    want = _run(TRx(TSPEC, device="cpu", threshold=0.5), ragged)
    jr = jres.ResilientReceiver(lambda: JRx(JSPEC, threshold=0.5),
                                checkpoint_blocks=1)
    with pytest.raises(ValueError, match="residue"):
        jr.push(ragged[0])
    tr = ResilientReceiver(lambda: TRx(TSPEC, device="cpu", threshold=0.5),
                           checkpoint_blocks=1)
    got = []
    for b in ragged:
        got += tr.push(b)
        left = 0 if tr.rx._residue is None else tr.rx._residue.shape[0]
        assert tr._snap["residue"].shape[0] == left
    got += tr.flush()
    assert _keys(got) == _keys(want) and len(got) == len(events)
    # a receiver restored from the last snapshot holds the same residue
    rx = TRx(TSPEC, device="cpu", threshold=0.5)
    tstate.restore_receiver(tr._snap, rx)
    assert (rx._residue is None) == (tr.rx._residue is None)
    if rx._residue is not None:
        assert torch.equal(rx._residue, tr.rx._residue)


# -- the base station's checkpoint, across the two packages ------------------

def _page_response_burst():
    from amps_tpu.tx import recc_ms
    arr = np.zeros((7, 36), np.uint8)
    ok = np.zeros(7, bool)
    for i, w in enumerate(recc_ms.page_response_words("5551234567")):
        arr[i] = w
        ok[i] = True
    return arr, ok


def _ring_frames(n):
    """SAT (scc=1) + ST present: the mobile is ringing."""
    lv = np.zeros((n, 4), np.float32)
    lv[:, 1] = 0.05
    lv[:, 3] = 0.05
    return lv, np.full(n, 1e-3, np.float32)


def _drive_to_checkpoint(bs):
    arr, ok = _page_response_burst()
    bs.handle_burst(arr, ok)                 # page response -> alert
    bs.handle_command("page 2135551212")     # second FOCC queue entry
    part = np.asarray(bs.fvc.next_block(4000))   # mid-burst offset
    bs.push_supervision(355, *_ring_frames(50))  # 0.5 s of ringing
    return part


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_station_checkpoint_across_packages(tmp_path, direction):
    """A station checkpoint written by either package resumes in the
    other: the continued FOCC superframes, the FVC stream and the
    supervision timeline equal those of an uninterrupted station of the
    writing package (tests/test_state.py's resume test)."""
    from amps_tpu.control.station import BaseStation as JStation
    from amps_tpu_torch.control.station import BaseStation as TStation
    if direction == "jax_to_port":
        src_cls, dst_cls = JStation, TStation
        save, load = jstate.save_station, tstate.load_station
    else:
        src_cls, dst_cls = TStation, JStation
        save, load = tstate.save_station, jstate.load_station
    full, a = src_cls(), src_cls()
    part_full = _drive_to_checkpoint(full)
    assert np.array_equal(_drive_to_checkpoint(a), part_full)
    path = str(tmp_path / "station.npz")
    save(path, a)
    b = dst_cls()
    load(path, b)
    assert (b.fvc_mute, b.audio_mute) == (full.fvc_mute, full.audio_mute)
    for _ in range(3):
        assert np.array_equal(
            np.asarray(full.focc.next_superframe_symbols()),
            np.asarray(b.focc.next_superframe_symbols()))
    assert np.array_equal(np.asarray(full.fvc.next_block(6000)),
                          np.asarray(b.fvc.next_block(6000)))
    assert (full.fvc._timer, full.fvc._off) == (b.fvc._timer, b.fvc._off)
    # supervision resumes mid-alert: ST drops -> answer at the same time
    lv, pw = _ring_frames(10)
    lv[:, 3] = 0.0
    for bs in (full, b):
        bs.push_supervision(355, lv, pw)
    ans = [[e for e in bs.supervisors[355].events if e.kind == "answer"]
           for bs in (full, b)]
    assert len(ans[0]) == len(ans[1]) == 1
    assert abs(ans[0][0].t - ans[1][0].t) < 1e-9
    assert full.supervisors[355].state == b.supervisors[355].state \
        == "conversation"
    assert (full.fvc_mute, full.audio_mute) == (b.fvc_mute, b.audio_mute) \
        == (True, False)


def test_station_checkpoint_per_channel_fvc(tmp_path):
    """A per-channel-FVC station's streams and mute pairs round-trip
    through the port's checkpoint."""
    from amps_tpu_torch.config import SystemConfig
    from amps_tpu_torch.control.station import BaseStation as TStation
    sys_ = SystemConfig(voice_channels=(355, 356))
    full = TStation(sys_, per_channel_fvc=True)
    a = TStation(sys_, per_channel_fvc=True)
    for bs in (full, a):
        _drive_to_checkpoint(bs)
        bs.fvc_for(355).next_block(1234)
    path = str(tmp_path / "station.npz")
    tstate.save_station(path, a)
    b = TStation(sys_, per_channel_fvc=True)
    tstate.load_station(path, b)
    assert sorted(b.fvc_streams) == sorted(full.fvc_streams)
    assert b.fvc_mutes == full.fvc_mutes and \
        b.audio_mutes == full.audio_mutes
    for c in full.fvc_streams:
        assert np.array_equal(full.fvc_for(c).next_block(5000),
                              b.fvc_for(c).next_block(5000))


def test_station_checkpoint_carries_voice_slot_continuity(tmp_path):
    """The voice slots' FM phase accumulator, SAT tone clock and audio
    offset join the checkpoint (the sources map), so the resumed TX
    waveform has no phase step."""
    from amps_tpu_torch.config import SystemConfig
    from amps_tpu_torch.control.station import BaseStation as TStation
    from amps_tpu_torch.runtime.sources import VoiceFvcSlot

    st = TStation(SystemConfig())
    slot = VoiceFvcSlot(st, chan=355, device="cpu")
    _ = slot(3000)
    want = (slot._fvc_accum, slot._voice_phase, slot._t)
    assert want[2] > 0.0
    path = str(tmp_path / "station.npz")
    tstate.save_station(path, st, sources={355: slot})
    st2 = TStation(SystemConfig())
    slot2 = VoiceFvcSlot(st2, chan=355, device="cpu")
    tstate.load_station(path, st2, sources={355: slot2})
    assert (slot2._fvc_accum, slot2._voice_phase, slot2._t) == want
    assert np.allclose(slot(3000), slot2(3000), atol=1e-6)


def test_station_checkpoint_refuses_other_kinds(tmp_path):
    from amps_tpu_torch.control.station import BaseStation as TStation
    tx = TTx(TSPEC, device="cpu", control_channels=[1])
    path = str(tmp_path / "tx.npz")
    tstate.save_transmitter(path, tx)
    with pytest.raises(ValueError, match="not a station"):
        tstate.load_station(path, TStation())
