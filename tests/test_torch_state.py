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


# -- the sharded receiver ----------------------------------------------------

def _sharded(package, **kw):
    """A 2x2 sharded receiver of either package (the port's on CPU
    workers, the JAX package's on four virtual devices)."""
    kw = dict(max_bursts=4, threshold=0.55, policy="first_ok",
              min_rssi=0.05, **kw)
    if package == "port":
        from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        from amps_tpu_torch.parallel.stream import ShardedReceiver
        return ShardedReceiver(make_mesh(MeshSpec(2, 2), ["cpu"]), TSPEC,
                               **kw)
    import jax
    from amps_tpu.parallel.mesh import MeshSpec, make_mesh
    from amps_tpu.parallel.stream import ShardedReceiver
    return ShardedReceiver(make_mesh(MeshSpec(2, 2), jax.devices()[:4]),
                           JSPEC, **kw)


@functools.cache
def _sharded_stream():
    """3 blocks of 2 rows x 12480 hops; one burst spans the block 1|2
    boundary, where the checkpoints are taken."""
    block = 2 * 12480
    events = [MobileEvent("page_response", 2, 5000, "4155559876"),
              MobileEvent("origination", 5, 2 * block - 4000, "5551234567",
                          "7025551000", esn=11)]
    x = synthesize_reverse_band(events, JSPEC, 3 * block, noise_sigma=0.001)
    return [x[i: i + block * P] for i in range(0, len(x), block * P)], events


def test_snapshot_sharded_receiver_matches_jax():
    """After the same two blocks, the port's sharded checkpoint has the
    JAX package's layout: the same keys, dtypes and shapes; the counters,
    dedup positions, parities and the raw input history equal; the
    analysis IQ halo within 2e-4 (the f32 analysis tolerance)."""
    blocks, _ = _sharded_stream()
    snaps = []
    for package, mod in (("port", tstate), ("jax", jstate)):
        rx = _sharded(package)
        rx.push(blocks[0])
        rx.push(blocks[1])
        snaps.append(mod.snapshot_sharded_receiver(rx))
    got, want = snaps
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        if k == "st_iq_carry":
            assert np.abs(g - w).max() <= 2e-4
        else:
            assert np.array_equal(g, w), k
    assert int(got["nh_done"]) > 0 and str(got["kind"]) == "sharded_receiver"


def test_sharded_receiver_checkpoint_resume(tmp_path):
    """Mid-stream checkpoint -> a fresh ShardedReceiver -> restore: the
    resumed stream's reports are bit-identical to an uninterrupted
    receiver's."""
    blocks, events = _sharded_stream()
    ref_rx = _sharded("port")
    ref = [r for b in blocks for r in ref_rx.push(b)] + ref_rx.flush()
    rx = _sharded("port")
    got = rx.push(blocks[0]) + rx.push(blocks[1])
    path = str(tmp_path / "sharded.npz")
    tstate.save_sharded_receiver(path, rx)
    rx2 = _sharded("port")
    tstate.load_sharded_receiver(path, rx2)
    got += rx2.push(blocks[2]) + rx2.flush()
    assert len(got) == len(ref) == len(events)
    assert _keys(got) == _keys(ref)
    assert [(r.quality, r.rssi) for r in got] == \
        [(r.quality, r.rssi) for r in ref]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sharded_checkpoint_across_packages(tmp_path, direction):
    """A sharded checkpoint of one package resumes in the other: the
    JAX file's stream state crosses through convert.sharded_state_from_jax
    (what load_sharded_receiver uses), and the resumed receiver reports
    what the writer reports on the next block."""
    import jax
    blocks, events = _sharded_stream()
    src, dst = (("jax", "port") if direction == "jax_to_port"
                else ("port", "jax"))
    writer = _sharded(src)
    writer.push(blocks[0])
    writer.push(blocks[1])
    path = str(tmp_path / "sharded.npz")
    (jstate if src == "jax" else tstate).save_sharded_receiver(path, writer)
    reader = _sharded(dst)
    (jstate if dst == "jax" else tstate).load_sharded_receiver(path, reader)
    if src == "jax":
        want_state = convert.sharded_state_from_jax(
            jax.device_get(writer._state), "cpu")
        for k in ("hist", "iq_carry", "syn_carry"):
            assert torch.equal(reader._state[k], want_state[k])
        assert reader._state["parity"] == want_state["parity"] == 0
    want = writer.push(blocks[2]) + writer.flush()
    got = reader.push(blocks[2]) + reader.flush()
    assert len(got) == 1 and got[0].channel == events[1].channel
    assert _keys(got) == _keys(want)
    assert abs(got[0].quality - want[0].quality) <= 2e-4


def test_sharded_supervision_carry_survives_checkpoint(tmp_path):
    """The sub-frame supervision leftover is part of the sharded
    checkpoint: a resumed stream measures the same frames."""
    from amps_tpu_torch.dsp import channelizer as chz
    from amps_tpu_torch.dsp.fm import fm_modulate
    nh_row, SLOT = 11520, 5
    n = 3 * 2 * nh_row
    t = np.arange(n) / float(TSPEC.pipe.chan_rate)
    Y = torch.zeros((n, M, 2))
    Y[:, SLOT] = fm_modulate(torch.as_tensor(
        0.05 * np.cos(2 * np.pi * 6000.0 * t), dtype=torch.float32),
        TSPEC.fm_sensitivity)[0]
    x, _ = chz.synthesize(Y, TSPEC.chz_spec,
                          chz.synthesizer_init(TSPEC.chz_spec, device="cpu"))
    blk = 2 * nh_row * P

    def run(split):
        frames = []
        kw = dict(supervision_slots=(SLOT,),
                  on_supervision=lambda s, lv, pw: frames.append(
                      (lv.copy(), pw.copy())))
        rx = _sharded("port", **kw)
        for b in range(3):
            rx.push(x[b * blk:(b + 1) * blk])
            if split and b == 0:
                path = str(tmp_path / "sup.npz")
                tstate.save_sharded_receiver(path, rx)
                rx = _sharded("port", **kw)
                tstate.load_sharded_receiver(path, rx)
        return frames

    ref, got = run(False), run(True)
    assert len(ref) == len(got) == 3
    for (la, pa), (lb, pb) in zip(ref, got):
        assert np.array_equal(la, lb) and np.array_equal(pa, pb)


def test_sharded_checkpoint_refuses_other_kinds(tmp_path):
    rx = _sharded("port")
    with pytest.raises(ValueError, match="not a sharded receiver"):
        tstate.restore_sharded_receiver(tstate.snapshot_receiver(
            TRx(TSPEC, device="cpu")), rx)


# ---- the state of a 4096-channel bank (122.88 Msps) --------------------

WIDE = dict(num_channels=4096, taps_per_phase=8, fold="bank")


def test_receiver_state_from_jax_at_4096():
    """At M=4096 a JAX receiver's block k continues as the port's block
    k+1 through convert.receiver_state_from_jax.  Two page responses
    (2 words) from hops 300 and 600 in 11264 hops of band; a report
    waits for its 7-word capture window (10368 hops), so the JAX
    receiver takes the first 10752 hops and the one whose window ends
    past them (hop 600's) is completed from the carried state: the JAX
    receiver and the port, each continuing from the same snapshot with
    the last 512 hops and a padded flush, give the same reports, and the
    two bursts are reported once each with their words."""
    jspec, tspec = JSpec(**WIDE), TSpec(**WIDE)
    Mw, hops, cut = 4096, 11264, 10752
    events = [MobileEvent("page_response", 7, 600, "5551234567"),
              MobileEvent("page_response", Mw - 3, 300, "2135551212")]
    x = np.asarray(synthesize_reverse_band(events, jspec, hops,
                                           noise_sigma=0.001))
    n = cut * (Mw // 2)
    jrx = JRx(jspec, threshold=0.5)
    head = jrx.push(x[:n])
    snap = jstate.snapshot_receiver(jrx)
    want = _run(jrx, [x[n:]])
    trx = TRx(tspec, device="cpu", threshold=0.5)
    convert.receiver_state_from_jax(snap, trx)
    got = _run(trx, [x[n:]])
    assert _keys(got) == _keys(want) and 7 in [r.channel for r in got]
    reps = head + got
    assert sorted(r.channel for r in reps) == [7, Mw - 3]
    for ev in events:
        r = next(r for r in reps if r.channel == ev.channel)
        w = np.stack(ev.words())
        assert np.array_equal(r.words[:2], w) and r.word_ok[:2].all()


def test_transmitter_state_from_jax_at_4096(tmp_path):
    """At M=4096 a JAX transmitter's checkpoint (a synthesis carry made
    random, an odd hop index, a page queued) crosses through
    convert.transmitter_state_from_jax bit for bit, and the port's
    synthesis from the carried state equals the JAX synthesis from it on
    a 64-hop block, atol 2e-4 (a superframe at 4096 channels is a 1.64 GB
    plane, beyond a CPU test)."""
    import jax.numpy as jnp
    from amps_tpu.dsp import channelizer as jchz
    from amps_tpu_torch.dsp import channelizer as tchz
    jspec, tspec = JSpec(**WIDE), TSpec(**WIDE)
    jtx = JTx(jspec, control_channels=[0, 3])
    rng = np.random.default_rng(4096)
    carry = rng.normal(0, 1, np.asarray(jtx._state.carry).shape).astype(
        np.float32)
    jtx._state = jchz.SynthesizerState(jnp.asarray(carry), 50005)
    jtx.focc[3].push_words(STREAM_BOTH, _page_words(), repeats=2)
    path = str(tmp_path / "jtx4096.npz")
    jstate.save_transmitter(path, jtx)
    ttx = TTx(tspec, device="cpu", control_channels=[0, 3])
    with np.load(path) as z:
        convert.transmitter_state_from_jax(z, ttx)
    assert ttx._state.hop_idx == 50005
    assert np.array_equal(ttx._state.carry.numpy(), carry)
    assert len(ttx.focc[3]._queue) == len(jtx.focc[3]._queue) > 0
    Y = rng.normal(0, 1, (64, 4096, 2)).astype(np.float32)
    want, wst = jchz.synthesize(jnp.asarray(Y), jspec.chz_spec, jtx._state)
    got, tst = tchz.synthesize(torch.as_tensor(Y), tspec.chz_spec,
                               ttx._state)
    assert tst.hop_idx == wst.hop_idx == 50005 + 64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(tst.carry.numpy(), np.asarray(wst.carry),
                               atol=2e-4)
