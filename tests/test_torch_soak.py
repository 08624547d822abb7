"""The port's certification soaks (``amps_tpu_torch.eval.soak``) against
the JAX package at a small size: each family's band goes through the
port's family function and, composed from ``amps_tpu`` functions as the
JAX scripts compose them, through the JAX receivers.

Both packages get the same events, the same impairment draws and the
same band noise (the port's CPU draw, added to the JAX band as numpy),
and f32 planes (``corr_bf16=False``), so the report lists must be equal
exactly: channel, abs_symbol, words, word_ok, dcc.  The verdicts of both
runs, computed by the port's verdict functions, must be equal, and the
supervision timelines identical.  The channel planes of both packages
agree to 1e-5 (float32 basebands of the same draws).

Size: M=16 (multicall16 at M=32, its 16 calls on every other slot;
sharded_voice at M=32), 16384-hop bands of 2048-hop pushes, 4-9 events;
the sharded families on their 2x4 / 4x2 meshes with the JAX soaks' row
lengths.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amps_tpu.control.station import BaseStation as JStation
from amps_tpu.control.supervision import ALERTING
from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp.fm import fm_modulate as jfm
from amps_tpu.dsp.fm import fm_modulate_symbols as jfm_symbols
from amps_tpu.eval import channel as jchan
from amps_tpu.eval.traffic import random_events as jrandom_events
from amps_tpu.parallel.mesh import MeshSpec as JMeshSpec
from amps_tpu.parallel.mesh import make_mesh as jmake_mesh
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu.parallel.stream import ShardedReceiver as JShardedReceiver
from amps_tpu.runtime import state as jstate
from amps_tpu.runtime.streamer import MultichannelReceiver as JRx
from amps_tpu.tx import recc_ms as jrecc
from amps_tpu.config import SystemConfig as JSystemConfig
from amps_tpu_torch.eval import soak
from amps_tpu_torch.eval.traffic import random_events
from amps_tpu_torch.parallel.pipeline import MultichannelSpec as TSpec
from amps_tpu_torch.runtime import state as tstate
from amps_tpu_torch.runtime.streamer import MultichannelReceiver as TRx

torch.set_num_threads(2)

M = 16
HOPS = 16384
BLOCK_HOPS = 2048
NOISE = 0.001
SHARDED_ROWS = ((3, 10560), (1, 13440))    # 3 blocks, then a longer one


def _specs(m=M):
    kw = dict(num_channels=m, taps_per_phase=8, fold="bank")
    return JSpec(**kw), TSpec(**kw)


def _key(r):
    return (int(r.channel), int(r.abs_symbol),
            np.asarray(r.words).tolist(), np.asarray(r.word_ok).tolist(),
            int(r.dcc))


def _same_reports(got, want):
    assert [_key(r) for r in got] == [_key(r) for r in want]


def _no_timing(v):
    return {k: x for k, x in v.items()
            if k not in ("wall_s", "streaming_msps", "samples", "family",
                         "snapshot_ms", "recoveries", "gates",
                         "realtime_factor", "host_us_per_call_block",
                         "host_max_ms", "sat_measured")}


def _jax_planted(events, jspec, rng=None):
    """The JAX scripts' basebands: (event, dcc, cfo, fd, bb) with the
    impairments drawn in their order when ``rng`` is given."""
    fs = float(jspec.pipe.chan_rate)
    sens = 2 * np.pi * jspec.pipe.deviation_hz / fs
    out = []
    for ev in events:
        dcc = int(rng.integers(0, 4)) if rng is not None else 0
        syms = jrecc.burst_symbols(ev.words(), dcc=dcc, sps=jspec.chan_sps)
        bb = np.asarray(jfm_symbols(syms.astype(np.int8), sens)[0])
        cfo = fd = 0.0
        if rng is not None:
            cfo = float(rng.uniform(-2100.0, 2100.0))
            ph = 2 * np.pi * cfo * np.arange(len(bb)) / fs
            c, s = np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)
            bb = np.stack([bb[:, 0] * c - bb[:, 1] * s,
                           bb[:, 0] * s + bb[:, 1] * c], -1)
            fd = float(rng.uniform(2.0, 80.0))
            bb = np.asarray(jchan.apply_gain(
                bb, jchan.rayleigh_gain(len(bb), fs, fd, rng)), np.float32)
        out.append((ev, dcc, cfo, fd, bb))
    return out


def _jax_plane(planted, m, total_hops, add=False):
    Y = np.zeros((total_hops, m, 2), np.float32)
    for ev, _, _, _, bb in planted:
        n = min(len(bb), total_hops - ev.start_hop)
        if add:
            Y[ev.start_hop: ev.start_hop + n, ev.channel] += bb[:n]
        else:
            Y[ev.start_hop: ev.start_hop + n, ev.channel] = bb[:n]
    return Y


def _jax_band(planted, jspec, total_hops, noise, noise_seed, add=False):
    Y = _jax_plane(planted, jspec.num_channels, total_hops, add)
    x, _ = jchz.synthesize(jnp.asarray(Y), jspec.chz_spec,
                           jchz.synthesizer_init(jspec.chz_spec))
    x = np.asarray(x)
    if noise:
        x = x + soak.band_noise(x.shape, noise, noise_seed)
    return x


def _jax_stream(push, x, block):
    reports, off = [], 0
    while off < len(x):
        reports += push(x[off: off + block])
        off += block
    return reports


def _check_plane(planted_t, planted_j, jspec, total_hops, add=False):
    """Same draws (DCC, CFO, Doppler) and the same plane to 1e-5."""
    assert [(p.event.channel, p.event.start_hop, p.dcc, p.cfo, p.fd)
            for p, _ in planted_t] == \
        [(ev.channel, ev.start_hop, d, c, f) for ev, d, c, f, _ in planted_j]
    yt = soak.band_plane(planted_t, jspec.num_channels, total_hops, add)
    yj = _jax_plane(planted_j, jspec.num_channels, total_hops, add)
    assert np.abs(yt - yj).max() <= 1e-5


@functools.cache
def _recc_run(family):
    """(port verdict, port reports, JAX reports, planted) of a small
    one-receiver soak."""
    seed, impaired = {"clean": (11, False), "long": (13, False),
                      "impaired": (23, True)}[family]
    jspec, tspec = _specs()
    got = []
    v = getattr(soak, family)("cpu", spec=tspec, total_hops=HOPS, n_events=6,
                              seed=seed, noise=NOISE,
                              block=BLOCK_HOPS * M // 2, reports=got)
    events = jrandom_events(6, jspec, HOPS, seed=seed)
    rng = np.random.default_rng(seed) if impaired else None
    pj = _jax_planted(events, jspec, rng)
    planted = soak.burst_basebands(
        random_events(6, tspec, HOPS, seed=seed), tspec,
        np.random.default_rng(seed) if impaired else None)
    _check_plane(planted, pj, jspec, HOPS)
    noise_seed = 2 if impaired else 1
    xj = _jax_band(pj, jspec, HOPS, NOISE, noise_seed)
    thr, rssi = (0.55, 0.02) if impaired else (0.6, 0.05)
    rxj = JRx(jspec, threshold=thr, max_bursts=6, min_rssi=rssi)
    want = _jax_stream(rxj.push, xj, BLOCK_HOPS * M // 2)
    return v, got, want, [p for p, _ in planted]


@pytest.mark.parametrize("family", ["clean", "long", "impaired"])
def test_recc_family_matches_jax(family):
    v, got, want, planted = _recc_run(family)
    _same_reports(got, want)
    assert v["ok"] and v["exact"] == v["n_events"] == len(planted) >= 4
    jv = soak.recc_verdict(want, planted, impaired=family == "impaired")
    assert _no_timing(v) == _no_timing(jv)
    if family == "impaired":
        assert v["dcc_ok"] == v["n_events"]
        assert len({p.dcc for p in planted}) > 1


def test_chaos_gives_the_clean_reports():
    """One injected failure after the push ran: the rebuilt receiver
    replays from the host snapshot and the stream gives the clean run's
    (= the JAX package's) reports, each once."""
    _, clean_reports, want, _ = _recc_run("clean")
    got = []
    v = soak.chaos("cpu", spec=_specs()[1], total_hops=HOPS, n_events=6,
                   seed=11, noise=NOISE, block=BLOCK_HOPS * M // 2,
                   reports=got)
    assert v["ok"] and v["recoveries"] == 1
    _same_reports(got, clean_reports)
    _same_reports(got, want)


def test_failing_factory_fails_once_across_receivers():
    calls = []

    class Rx:
        def push(self, b):
            calls.append(b)
            return [b]

    make = soak._failing(Rx, 2)
    a = make()
    assert a.push(1) == [1]
    with pytest.raises(RuntimeError, match="injected"):
        a.push(2)
    b = make()
    assert b.push(3) == [3] and calls == [1, 2, 3]


STREAM_BLOCKS, RESTORE_AT = 10, 5


@functools.cache
def _stream64_jax():
    """The JAX receiver over the small stream64 band: unbroken, and with
    the JAX checkpoint at RESTORE_AT; plus the band and the planted."""
    jspec, tspec = _specs()
    total = STREAM_BLOCKS * BLOCK_HOPS
    events = jrandom_events(8, jspec, total, seed=41)
    pj = _jax_planted(events, jspec, np.random.default_rng(41))
    xj = _jax_band(pj, jspec, total, NOISE, 2)
    return jspec, tspec, xj, pj


def _jrx(jspec):
    return JRx(jspec, threshold=0.55, max_bursts=6, policy="majority",
               min_rssi=0.05)


def test_stream64_matches_jax(tmp_path):
    jspec, tspec, xj, pj = _stream64_jax()
    got = []
    v = soak.stream64("cpu", spec=tspec, blocks=STREAM_BLOCKS,
                      block_hops=BLOCK_HOPS, n_events=8, seed=41, noise=NOISE,
                      restore_at=RESTORE_AT, reports=got)
    n = BLOCK_HOPS * M // 2
    rx, want = _jrx(jspec), []
    for b in range(STREAM_BLOCKS):
        if b == RESTORE_AT:
            path = str(tmp_path / "j.npz")
            jstate.save_receiver(path, rx)
            rx = _jrx(jspec)
            jstate.load_receiver(path, rx)
        want += rx.push(xj[b * n:(b + 1) * n])
    want += rx.flush(pad_tail=True)
    _same_reports(got, want)
    planted = [soak.Planted(ev, np.stack(ev.words()), d, c, f)
               for ev, d, c, f, _ in pj]
    assert v["ok"] and v["exactly_once"] and v["n_events"] >= 6
    assert _no_timing(v) == _no_timing(soak.once_verdict(want, planted))


def test_stream64_restores_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package writes mid-stream, loaded by the
    port's ``load_receiver`` into a fresh receiver: the port finishes the
    stream with the reports of the unbroken JAX stream."""
    jspec, tspec, xj, _ = _stream64_jax()
    n = BLOCK_HOPS * M // 2
    rx, unbroken = _jrx(jspec), []
    for b in range(STREAM_BLOCKS):
        unbroken += rx.push(xj[b * n:(b + 1) * n])
    unbroken += rx.flush(pad_tail=True)
    rx, got = _jrx(jspec), []
    for b in range(RESTORE_AT):
        got += rx.push(xj[b * n:(b + 1) * n])
    path = str(tmp_path / "j.npz")
    jstate.save_receiver(path, rx)
    trx = TRx(tspec, threshold=0.55, max_bursts=6, policy="majority",
              min_rssi=0.05, device="cpu")
    tstate.load_receiver(path, trx)
    for b in range(RESTORE_AT, STREAM_BLOCKS):
        got += trx.push(torch.as_tensor(xj[b * n:(b + 1) * n]))
    got += trx.flush(pad_tail=True)
    assert len(unbroken) >= 6
    _same_reports(got, unbroken)


def test_sharded_matches_jax():
    jspec, tspec = _specs()
    got = []
    v = soak.sharded("cpu", spec=tspec, rows=SHARDED_ROWS, n_random=3,
                     noise=NOISE, reports=got)
    events, total = soak.sharded_events(M, SHARDED_ROWS, 2, 3, 7)
    pj = _jax_planted(events, jspec, np.random.default_rng(7))
    xj = _jax_band(pj, jspec, total, NOISE, 7, add=True)
    rx = JShardedReceiver(jmake_mesh(JMeshSpec(time=2, chan=4),
                                     jax.devices()[:8]), jspec,
                          threshold=0.55, max_bursts=6, min_rssi=0.02)
    want, off = [], 0
    P = M // 2
    for nb, nh in SHARDED_ROWS:
        for _ in range(nb):
            want += rx.push(xj[off: off + 2 * nh * P])
            off += 2 * nh * P
    want += rx.flush()
    _same_reports(got, want)
    planted = [soak.Planted(ev, np.stack(ev.words()), d, c, f)
               for ev, d, c, f, _ in pj]
    assert v["ok"] and v["n_events"] == 9
    assert _no_timing(v) == _no_timing(soak.once_verdict(want, planted))


def _jax_voice_band(jspec, n, slots, on_a_after_handoff, noise):
    fs = float(jspec.pipe.chan_rate)
    sens = 2.0 * np.pi * jspec.pipe.deviation_hz / fs
    t = np.arange(n) / fs
    m_a, m_b, act_a, act_b = soak._voice_mod(t, on_a_after_handoff)
    Y = np.zeros((n, jspec.num_channels, 2), np.float32)
    Y[:, slots[0]] = np.asarray(jfm(jnp.asarray(m_a, jnp.float32),
                                    sens)[0]) * act_a
    Y[:, slots[1]] = np.asarray(jfm(jnp.asarray(m_b, jnp.float32),
                                    sens)[0]) * act_b
    x, _ = jchz.synthesize(jnp.asarray(Y), jspec.chz_spec,
                           jchz.synthesizer_init(jspec.chz_spec))
    return np.asarray(x) + soak.band_noise(x.shape, noise, 7)


def _jax_station(timers, system=None, per_channel_fvc=False):
    st = JStation(system, sps=3, per_channel_fvc=per_channel_fvc)
    st.supervision_config = dataclasses.replace(st.supervision_config,
                                                **timers)
    events = []
    st._on_event = lambda ev: events.append((ev.kind, ev.payload))
    return st, events


def _jax_push_voice(rx, x, blk, fs, P, station, slots):
    t_cmd = None
    for off in range(0, len(x), blk):
        rx.push(x[off: off + blk])
        t_now = (off + blk) / P / fs
        if t_cmd is None and t_now >= soak.T_HANDOFF:
            assert station.handoff(*slots)
            t_cmd = t_now
    rx.flush()
    return t_cmd


def test_voice_matches_jax():
    jspec, tspec = _specs()
    slots, noise = (6, 10), 0.005
    tl = []
    v = soak.voice("cpu", spec=tspec, slots=slots, noise=noise, timeline=tl)
    P, fs = M // 2, float(jspec.pipe.chan_rate)
    n = int(3.4 * fs)
    n -= n % P
    xj = _jax_voice_band(jspec, n, slots, True, noise)
    station, events = _jax_station(soak.VOICE_TIMERS)
    station._start_supervision(slots[0], ALERTING)
    levels = []

    def on_sup(slot, lv, pw):
        levels.append((slot, np.asarray(lv)))
        station.push_supervision(slot, lv, pw)

    rx = JRx(jspec, max_bursts=2, threshold=0.55, supervision_slots=slots,
             on_supervision=on_sup)
    t_cmd = _jax_push_voice(rx, xj, soak.VOICE_BLOCK_HOPS * P, fs, P,
                            station, slots)
    jtl, checks, problems = soak.one_call_verdict(events, station, slots,
                                                  t_cmd)
    assert tl == jtl and len(tl) == 4
    sat = soak.sat_measured([lv for s, lv in levels if s == slots[0]])
    assert abs(sat - v["sat_measured"]) <= 1e-3
    checks["sat_level_within_10pct"] = abs(sat - soak.SAT_AMP) \
        / soak.SAT_AMP < 0.10
    assert v["ok"] and v["checks"] == checks and v["problems"] == problems


def test_sharded_voice_matches_jax():
    """At M=32 (at M=16 noise on a dead carrier flickers its SAT gate in
    both packages alike)."""
    m = 32
    jspec, tspec = _specs(m)
    noise, nh_row, blocks = 0.005, 10352, 5
    tl = []
    v = soak.sharded_voice("cpu", spec=tspec, noise=noise, timeline=tl)
    P, fs = m // 2, float(jspec.pipe.chan_rate)
    slots = (20 * m // 64, 40 * m // 64)
    xj = _jax_voice_band(jspec, blocks * 4 * nh_row, slots, False, noise)
    station, events = _jax_station(soak.VOICE_TIMERS)
    station._start_supervision(slots[0], ALERTING)
    rx = JShardedReceiver(
        jmake_mesh(JMeshSpec(time=4, chan=2), jax.devices()[:8]), jspec,
        max_bursts=2, threshold=0.55, supervision_slots=slots,
        on_supervision=station.push_supervision)
    t_cmd = _jax_push_voice(rx, xj, 4 * nh_row * P, fs, P, station, slots)
    jtl, checks, problems = soak.one_call_verdict(events, station, slots,
                                                  t_cmd)
    assert tl == jtl and len(tl) == 4
    assert v["ok"] and v["checks"] == checks and v["problems"] == problems


def test_multicall16_matches_jax():
    m = 32
    jspec, tspec = _specs(m)
    tl = []
    v = soak.multicall16("cpu", spec=tspec, timeline=tl)
    calls = soak.multicall_plan(m)
    P, fs = m // 2, float(jspec.pipe.chan_rate)
    sens = 2.0 * np.pi * jspec.pipe.deviation_hz / fs
    n = int(4.4 * fs)
    n -= n % 2
    t = np.arange(n) / fs
    Y = np.zeros((n, m, 2), np.float32)
    for chan, slot, _, t_ans, t_hang, t_fade in calls:
        mod, act = soak.multicall_mod(t, t_ans, t_hang, t_fade, seed=chan)
        Y[:, slot] = np.asarray(jfm(jnp.asarray(mod), sens)[0]) \
            * act[:, None]
    x, _ = jchz.synthesize(jnp.asarray(Y), jspec.chz_spec,
                           jchz.synthesizer_init(jspec.chz_spec))
    xj = np.asarray(x) + soak.band_noise(x.shape, 0.005, 7)
    station, events = _jax_station(
        soak.MULTICALL_TIMERS,
        JSystemConfig(voice_channels=tuple(c for c, *_ in calls)), True)
    slot_map = {slot: chan for chan, slot, *_ in calls}
    for chan, _, st0, *_ in calls:
        station._start_supervision(chan, st0)
        if st0 == ALERTING:
            station.supervisors[chan].begin_alert()
    rx = JRx(jspec, max_bursts=2, threshold=0.55, min_rssi=0.05,
             supervision_slots=tuple(sorted(slot_map)),
             on_supervision=lambda s, lv, pw: station.push_supervision(
                 slot_map[s], lv, pw))
    blk = soak.VOICE_BLOCK_HOPS * P
    for off in range(0, n * P, blk):
        rx.push(xj[off: off + blk])
    rx.flush()
    jtl, checks, problems = soak.multicall_verdict(events, station, calls,
                                                   4.4)
    checks["sixteen_concurrent"] = True
    assert tl == jtl and len(tl) == 22
    assert v["ok"] and v["checks"] == checks and v["problems"] == problems


def _sup_frames(n, sat, guard, power):
    """(F, 5) measured-feed frames: SAT on scc 1 at ``sat``, the guard
    column at ``guard``."""
    lv = np.zeros((n, 5), np.float32)
    lv[:, 1], lv[:, 4] = sat, guard
    lv[:, [0, 2, 3]] = 0.004
    return lv, np.full(n, power, np.float32)


def test_dead_carrier_sat_flicker_is_no_return():
    """Found by the voice soak: on a dead carrier one frame's guard bins
    can dip under the carrier gate while the 120 ms SAT aggregate
    passes.  The JAX supervisor reads that frame as SAT back (and
    restarts the fade timer); the port's needs 30 ms of SAT after a
    declared loss.  A real return gives both the same sat_back, dated
    by its first frame."""
    from amps_tpu.control import supervision as jsup
    from amps_tpu_torch.control import supervision as tsup
    script = [_sup_frames(20, 0.05, 0.005, 0.05),     # conversation
              _sup_frames(30, 0.004, 0.1, 1.6),       # dead carrier
              _sup_frames(1, 0.05, 0.02, 1.6),        # a slipping frame
              _sup_frames(40, 0.004, 0.1, 1.6),
              _sup_frames(20, 0.05, 0.005, 0.05)]     # SAT back
    got = {}
    for name, m in (("jax", jsup), ("port", tsup)):
        sup = m.ChannelSupervisor(355, 1)
        for lv, pw in script:
            sup.push_frames(lv, pw)
        got[name] = [(e.kind, round(e.t, 2)) for e in sup.events]
    assert got["jax"] == [("sat_lost", 0.22), ("sat_back", 0.5),
                          ("sat_lost", 0.53), ("sat_back", 0.91)]
    assert got["port"] == [("sat_lost", 0.22), ("sat_back", 0.91)]
