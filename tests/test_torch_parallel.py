"""The port's sharded station (``amps_tpu_torch.parallel``) against the
JAX package's on the virtual 8-device CPU mesh, and against the port's
own single-device receiver and transmitter: the counterparts of
tests/test_parallel.py.

Tolerances: integers and booleans (starts, valid, words, word_ok, dcc,
bad-symbol counts, report lists) exactly; f32 planes (quality,
chan_power, rssi, carried IQ) to 2e-4; the TX wideband to 2e-5 of its
peak (the JAX test's bound against the single-device transmitter); at
bf16 the decoded words of the valid bursts.  Both packages get
fold="bank"."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amps_tpu.eval.traffic import (MobileEvent, random_events,
                                   synthesize_reverse_band)
from amps_tpu.parallel import pipeline as jpl
from amps_tpu.parallel.mesh import MeshSpec as JMeshSpec
from amps_tpu.parallel.mesh import make_mesh as jmake_mesh
from amps_tpu.parallel.stream import ShardedReceiver as JShardedReceiver
from amps_tpu.rx import correlator as jcorrelator
from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.kernels.analysis import analyze_block
from amps_tpu_torch.parallel import halo
from amps_tpu_torch.parallel import pipeline as pl
from amps_tpu_torch.parallel import stream as pstream
from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from amps_tpu_torch.parallel.stream import (ShardedReceiver,
                                            ShardedTransceiver)
from amps_tpu_torch.runtime.streamer import MultichannelReceiver

torch.set_num_threads(2)

ATOL = 2e-4
TX_RTOL = 2e-5
HOP = 4                       # M = 8


def _specs(T=8, **kw):
    kw = dict(num_channels=8, taps_per_phase=T, fold="bank", **kw)
    return jpl.MultichannelSpec(**kw), pl.MultichannelSpec(**kw)


def _jmesh(t, c):
    return jmake_mesh(JMeshSpec(time=t, chan=c), jax.devices()[:t * c])


def _mesh(t, c):
    return make_mesh(MeshSpec(time=t, chan=c), ["cpu"])


def _close(a, b, atol=ATOL):
    """Equal where not finite (an empty slot's quality), within atol
    elsewhere."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    fa, fb = np.isfinite(a), np.isfinite(b)
    assert np.array_equal(fa, fb)
    assert np.array_equal(a[~fa], b[~fb])
    assert np.abs(a[fa] - b[fb]).max(initial=0.0) <= atol


def _same_reports(got, want, atol=ATOL, rssi_rtol=1e-4):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.channel, a.abs_symbol, a.dcc) == (b.channel, b.abs_symbol,
                                                    b.dcc)
        assert np.array_equal(a.words, b.words), (a.channel, a.abs_symbol)
        assert np.array_equal(a.word_ok, b.word_ok)
        assert np.array_equal(a.bad_symbols, b.bad_symbols)
        assert abs(a.quality - b.quality) <= atol
        assert abs(a.rssi - b.rssi) <= rssi_rtol * max(1.0, abs(b.rssi))


def _dedup(found, sps):
    """(channel, abs, ...) hits in (channel, position) order without a
    re-find within half a capture of the previous kept one."""
    kept, last = [], {}
    for b in sorted(found, key=lambda b: (b[0], b[1])):
        if b[0] in last and abs(b[1] - last[b[0]]) < \
                jcorrelator.CAPTURE_SYMBOLS * sps // 2:
            continue
        last[b[0]] = b[1]
        kept.append(b)
    return kept


def _found(out, nh_row, halo_n, base_row=0):
    """Every valid slot of a step's output whose Word A decoded, as
    (channel, abs, words, word_ok) bytes (the receivers' word-A gate)."""
    o = {k: np.asarray(out[k]) for k in ("valid", "starts", "words",
                                         "word_ok")}
    got = set()
    for r, c, k in zip(*np.nonzero(o["valid"] & o["word_ok"][..., 0])):
        got.add((int(c), (base_row + r) * nh_row - halo_n
                 + int(o["starts"][r, c, k]), o["words"][r, c, k].tobytes(),
                 o["word_ok"][r, c, k].tobytes()))
    return got


# ---------------------------------------------------------------------------
# the sharded analysis and the receive step


@pytest.mark.parametrize("t,c", [(2, 2), (4, 2), (8, 1)])
def test_sharded_analysis_matches_unsharded(t, c):
    """Ring halo + per-worker analysis kernel (its plain version here) at
    each worker's parity + the per-row all_to_all reproduce the
    single-device channel-major analysis, as the JAX package's
    test_flattened_ring_all_to_all_matches_single checks its own."""
    import amps_tpu.dsp.channelizer as jchz
    M, T, P, W = 8, 4, HOP, t * c
    L = M * T
    x = np.random.default_rng(5).normal(0, 1, (64 * W * P, 2)).astype(
        np.float32)
    spec = chz.ChannelizerSpec(M, T)
    want, _ = chz.analyze(torch.as_tensor(x), spec,
                          chz.analyzer_init(spec, device="cpu"),
                          chmajor=True, planar=True)
    jwant, _ = jchz.analyze(x, jchz.ChannelizerSpec(M, T),
                            jchz.analyzer_init(jchz.ChannelizerSpec(M, T)),
                            chmajor=True, planar=True)
    mesh = _mesh(t, c)
    parts = list(torch.as_tensor(x).chunk(W))
    n_sub = parts[0].shape[0] // P
    xe = halo.halo_exchange_left(mesh, parts, L - P, halo.RING)
    ypl = [analyze_block(e, M, T, (w * n_sub) % 2, planar=True)
           for w, e in enumerate(xe)]
    mine = halo.all_to_all(mesh, ypl, "chan", split_axis=1, concat_axis=2)
    got = torch.cat([torch.cat(mine[r * c:(r + 1) * c], dim=1)
                     for r in range(t)], dim=2)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5
    assert np.abs(got.numpy() - np.asarray(jwant)).max() <= ATOL


@functools.cache
def _band8():
    """tests/test_parallel.py's band: ten random accesses on channels
    1-7 and one on channel 0 across hop 49920, a row boundary for every
    time axis of 2, 4 and 8 rows."""
    js, _ = _specs(T=4)
    events = random_events(10, js, 99840, seed=3, channels=range(1, 8))
    events.append(MobileEvent("origination", 0, 49920 - 6000, "5551234567",
                              "7025551000", esn=12345))
    return synthesize_reverse_band(events, js, 99840,
                                   noise_sigma=0.001), events


@pytest.mark.parametrize("t,c", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_rx_step_matches_jax(t, c):
    js, ts = _specs(T=4)
    x, events = _band8()
    hal = jpl.full_demod_halo(js)
    assert pl.full_demod_halo(ts) == hal == 10344
    jout, jst = jpl.make_sharded_rx_stream_step(
        _jmesh(t, c), js, hal, max_bursts=4)(jnp.asarray(x),
                                             jpl.sharded_stream_state(js, hal))
    jout, jst = jax.device_get((jout, jst))
    out, st = pl.make_sharded_rx_stream_step(_mesh(t, c), ts, hal,
                                             max_bursts=4)(
        torch.as_tensor(x), pl.sharded_stream_state(ts, hal, "cpu"))
    for k in ("starts", "valid", "words", "word_ok"):
        assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k
    # the DCC and bad-symbol counts of noise-only slots follow roundoff
    valid = out["valid"].numpy()
    for k in ("dcc_bits", "bad_symbols"):
        assert np.array_equal(out[k].numpy()[valid],
                              np.asarray(jout[k])[valid]), k
    for k in ("quality", "chan_power", "rssi"):
        _close(out[k].float().numpy(), jout[k])
    assert np.array_equal(st["hist"].numpy(), jst["hist"])
    _close(st["iq_carry"].numpy(), jst["iq_carry"])
    assert st["parity"] == int(jst["parity"]) == 0
    # every access decoded once, the boundary one included
    got = _dedup(_found(out, 99840 // t, hal), ts.chan_sps)
    assert len(got) == len(events)
    bw = next(np.frombuffer(g[2], np.uint8).reshape(7, 36) for g in got
              if g[0] == 0)
    want = np.stack(events[-1].words())
    assert np.array_equal(bw[: len(want)], want)


def test_sharded_rx_step_bf16_decodes_same_words():
    """io_bf16 and corr_bf16 on both sides: the same bursts with the same
    words."""
    js, ts = _specs(T=4, io_bf16=True, corr_bf16=True)
    x, events = _band8()
    hal = jpl.full_demod_halo(js)
    jout, _ = jpl.make_sharded_rx_stream_step(_jmesh(2, 2), js, hal,
                                              max_bursts=4)(
        jnp.asarray(x), jpl.sharded_stream_state(js, hal))
    out, _ = pl.make_sharded_rx_stream_step(_mesh(2, 2), ts, hal,
                                            max_bursts=4)(
        torch.as_tensor(x), pl.sharded_stream_state(ts, hal, "cpu"))
    got = _dedup(_found(out, 49920, hal), 3)
    want = _dedup(_found(jax.device_get(jout), 49920, hal), 3)
    assert len(got) == len(events)
    assert [(g[0], g[2], g[3]) for g in got] == \
        [(w[0], w[2], w[3]) for w in want]


def test_rx_step_refuses_short_rows_and_ragged_blocks():
    _, ts = _specs(T=4)
    step = pl.make_sharded_rx_stream_step(_mesh(2, 2), ts, max_bursts=1)
    st = pl.sharded_stream_state(ts, pl.full_demod_halo(ts), "cpu")
    with pytest.raises(ValueError, match="demod halo"):
        step(torch.zeros((4 * 1000 * HOP, 2)), st)
    with pytest.raises(ValueError, match="multiple of workers"):
        step(torch.zeros((4 * 5200 * HOP + 2, 2)), st)


# ---------------------------------------------------------------------------
# the transmit side, full duplex and the closed loop


def _tx_inputs(nblocks, seed=99):
    from amps_tpu.tx.focc import FoccStream as JFocc
    sps, M = 3, 8
    n_hops = 18 * 463 * 2 * sps                       # one superframe
    rng = np.random.default_rng(seed)
    twin = JFocc(sps=sps)
    wps = [np.broadcast_to(p, (M,) + p.shape).copy()
           for p in (twin.next_word_pairs() for _ in range(nblocks))]
    srcs = []
    for _ in range(nblocks):
        s = np.zeros((n_hops, M, 2), np.float32)
        s[:, 4] = rng.normal(0, 0.3, (n_hops, 2))
        srcs.append(s)
    mode = np.full((M,), jpl.TX_SILENT, np.int32)
    mode[1], mode[4] = jpl.TX_FOCC, jpl.TX_SOURCE
    return wps, srcs, mode


def test_full_duplex_step_matches_jax():
    """rx_external + tx_sources on a 2x2 mesh for three blocks: the TX
    wideband (FOCC slot, source slot, silence) within 2e-5 of its peak,
    the reports exactly, and the carried state equal to JAX's after
    every block (the analyzer history exactly, the IQ and synthesis
    carries to tolerance, both parities)."""
    js, ts = _specs()
    hal, nb, row = jpl.full_demod_halo(js), 3, 12480
    block = 2 * row
    events = [MobileEvent("origination", 2, 700, "5551234567", "7025551000",
                          esn=7),
              MobileEvent("page_response", 3, row - 5000, "4155559876"),
              MobileEvent("registration", 6, block - 4000, "2125550000",
                          esn=5),
              MobileEvent("page_response", 5, 2 * block + 3000,
                          "7735550000")]
    x = synthesize_reverse_band(events, js, nb * block, noise_sigma=0.001)
    wps, srcs, mode = _tx_inputs(nb)
    jstep = jpl.make_sharded_bs_stream_step(_jmesh(2, 2), js, hal,
                                            max_bursts=2, rx_external=True,
                                            tx_sources=True)
    tstep = pl.make_sharded_bs_stream_step(_mesh(2, 2), ts, hal,
                                           max_bursts=2, rx_external=True,
                                           tx_sources=True)
    jst = jpl.sharded_stream_state(js, hal)
    st = pl.sharded_stream_state(ts, hal, "cpu")
    found = set()
    for b in range(nb):
        xb = x[b * block * HOP:(b + 1) * block * HOP]
        jout, jst = jstep(jnp.asarray(wps[b]), jst, jnp.asarray(mode),
                          jnp.asarray(srcs[b]), jnp.asarray(xb))
        jout, jst = jax.device_get((jout, jst))
        out, st = tstep(wps[b], st, mode, srcs[b], torch.as_tensor(xb))
        jtx = np.asarray(jout["tx_wideband"])
        assert out["tx_wideband"].shape == jtx.shape
        assert np.abs(out["tx_wideband"].numpy() - jtx).max() <= \
            TX_RTOL * max(np.abs(jtx).max(), 1.0)
        for k in ("starts", "valid", "words", "word_ok"):
            assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k
        _close(out["quality"].numpy(), jout["quality"])
        assert np.array_equal(st["hist"].numpy(), jst["hist"])
        _close(st["iq_carry"].numpy(), jst["iq_carry"])
        assert np.abs(st["syn_carry"].numpy() - jst["syn_carry"]).max() <= \
            TX_RTOL * max(np.abs(jtx).max(), 1.0)
        assert (st["parity"], st["tx_parity"]) == (int(jst["parity"]),
                                                   int(jst["tx_parity"]))
        found |= _found(out, row, hal, base_row=2 * b)
    assert len(_dedup(found, 3)) == len(events)
    # 24960 RX hops a block keep the RX parity even; 50004 TX hops too
    assert (st["parity"], st["tx_parity"]) == (0, 0)


@pytest.mark.parametrize("t,c", [(2, 2), (4, 1)])
def test_sharded_tx_matches_single_device(t, c):
    """The port's own counterpart of test_sharded_tx_matches_single_device:
    the sharded TX wideband, streamed over three blocks with a
    blank-and-burst source slot (voice + SAT, then the FVC alert), equals
    the single-device MultichannelTransmitter."""
    from amps_tpu_torch.codec import words as W
    from amps_tpu_torch.control.fields import parse_min
    from amps_tpu_torch.control.station import BaseStation
    from amps_tpu_torch.runtime.sources import VoiceFvcSlot
    from amps_tpu_torch.runtime.streamer import MultichannelTransmitter
    from amps_tpu_torch.tx.focc import STREAM_BOTH, FoccStream
    _, ts = _specs()
    M, sps, nb = 8, 3, 3
    n_hops = 18 * 463 * 2 * sps
    station = BaseStation(sps=sps)
    slot = VoiceFvcSlot(station, device="cpu")
    src_blocks = [slot(n_hops)]
    station.handle_command("fvc alert")
    station.handle_command("fvc on")
    src_blocks += [slot(n_hops) for _ in range(nb - 1)]
    min1, min2 = parse_min("5551234567")
    page = [np.asarray(W.focc_word1(True, 0, min1)),
            np.asarray(W.focc_word2_general(min2, 0, 0, 0))]
    tx = MultichannelTransmitter(ts, control_channels=[1], device="cpu")
    twin = FoccStream(sps=sps)
    tx.focc[1].push_words(STREAM_BOTH, page)
    twin.push_words(STREAM_BOTH, page)
    blk = {"b": 0}
    tx.set_channel_source(4, lambda n: src_blocks[blk["b"]])
    single = []
    for b in range(nb):
        blk["b"] = b
        single.append(tx.next_block())
    mode = np.full((M,), pl.TX_SILENT, np.int32)
    mode[1], mode[4] = pl.TX_FOCC, pl.TX_SOURCE
    step = pl.make_sharded_bs_stream_step(_mesh(t, c), ts, demod_halo=128,
                                          max_bursts=1, tx_sources=True)
    st = pl.sharded_stream_state(ts, 128, "cpu")
    for b in range(nb):
        p = twin.next_word_pairs()
        src = np.zeros((n_hops, M, 2), np.float32)
        src[:, 4] = src_blocks[b]
        out, st = step(np.broadcast_to(p, (M,) + p.shape).copy(), st, mode,
                       src)
        want = single[b]
        assert (out["tx_wideband"] - want).abs().max() <= \
            TX_RTOL * max(float(want.abs().max()), 1.0), (t, c, b)


def test_tx_hops_must_divide_by_the_ring():
    _, ts = _specs()
    step = pl.make_sharded_bs_stream_step(_mesh(4, 2), ts, demod_halo=128,
                                          max_bursts=1)
    from amps_tpu_torch.tx.focc import superframe_word_pairs
    wp = np.broadcast_to(superframe_word_pairs(), (8, 18, 2, 28)).copy()
    with pytest.raises(ValueError, match="must divide by the worker ring"):
        step(wp, pl.sharded_stream_state(ts, 128, "cpu"))


def test_sharded_bs_step_runs_and_finds_focc_energy():
    from amps_tpu_torch.tx.focc import superframe_word_pairs
    _, ts = _specs(T=4)
    pairs = superframe_word_pairs()[:4]
    word_pairs = np.broadcast_to(pairs, (8,) + pairs.shape).copy()
    starts, valid, quality, words, word_ok = pl.make_sharded_bs_step(
        _mesh(4, 2), ts, demod_halo=32, max_bursts=1)(word_pairs)
    assert quality.shape == (4, 8, 1) and words.shape == (4, 8, 1, 7, 36)
    assert torch.isfinite(quality).all()


def test_closed_loop_matches_steps_and_jax():
    """make_sharded_closed_loop_stream with external traffic (a burst
    across the block boundary) on a 4x2 mesh: block by block equal to
    the manual steps (counts exactly, quality_max bit for bit: the same
    operations), and the counts of the JAX package's fused scan."""
    from amps_tpu.tx.focc import superframe_word_pairs
    js, ts = _specs(T=4)
    hal, frames, nb = jpl.full_demod_halo(js), 4, 2
    block = 4 * 10560
    pairs = superframe_word_pairs()[:frames]
    wp = np.broadcast_to(pairs, (8,) + pairs.shape).copy()
    events = [MobileEvent("page_response", 2, 5000, "4155559876"),
              MobileEvent("registration", 6, 24000, "9165554321", esn=9),
              MobileEvent("origination", 4, block - 5000, "5551234567",
                          "7025551000", esn=77)]
    x = synthesize_reverse_band(events, js, nb * block, noise_sigma=0.001)
    x_rx = x.reshape(nb, block * HOP, 2)
    mesh = _mesh(4, 2)
    run, block_samples = pl.make_sharded_closed_loop_stream(
        mesh, ts, nb, frames=frames, max_bursts=2, demod_halo=hal,
        rx_external=True)
    n_valid, q_max, n_ok = (v.numpy() for v in run(wp, x_rx))
    assert n_valid.shape == (nb,)
    total_words = sum(len(ev.words()) for ev in events)
    assert int(n_valid.sum()) >= len(events)
    assert int(n_ok.sum()) >= total_words
    step = pl.make_sharded_bs_stream_step(mesh, ts, hal, max_bursts=2,
                                          rx_external=True)
    st = pl.sharded_stream_state(ts, hal, "cpu")
    for b in range(nb):
        out, st = step(wp, st, torch.as_tensor(x_rx[b]))
        assert out["tx_wideband"].shape[0] == block_samples
        assert int(out["valid"].sum()) == n_valid[b]
        assert float(out["quality"].max()) == q_max[b]
        assert int(out["word_ok"].sum()) == n_ok[b]
    jrun, _ = jpl.make_sharded_closed_loop_stream(
        _jmesh(4, 2), js, nb, frames=frames, max_bursts=2, demod_halo=hal,
        rx_external=True)
    jv, jq, jok = jax.device_get(jrun(wp, x_rx))
    assert np.array_equal(jv, n_valid) and np.array_equal(jok, n_ok)
    assert np.abs(jq - q_max).max() <= ATOL


# ---------------------------------------------------------------------------
# ShardedReceiver / ShardedTransceiver


@functools.cache
def _stream3():
    """tests/test_parallel.py's three-block stream: eight random accesses
    on channels 2-7, one across the row boundary at hop 12480 and one
    across the block boundary at hop 24960."""
    js, _ = _specs()
    total = 3 * 24960
    events = random_events(8, js, total, seed=11, channels=range(2, 8))
    events.append(MobileEvent("origination", 0, 12480 - 5000, "5551234567",
                              "7025551000", esn=777))
    events.append(MobileEvent("page_response", 1, 24960 - 4000,
                              "4155559876"))
    return synthesize_reverse_band(events, js, total,
                                   noise_sigma=0.001), events


def test_sharded_receiver_matches_single_device_and_jax():
    js, ts = _specs()
    x, events = _stream3()
    kw = dict(max_bursts=4, threshold=0.55, policy="first_ok", min_rssi=0.05)
    mr = MultichannelReceiver(ts, device="cpu", **kw)
    single = []
    for i in range(6):
        single += mr.push(x[i * 12480 * HOP:(i + 1) * 12480 * HOP])
    single += mr.flush()
    sr = ShardedReceiver(_mesh(2, 2), ts, **kw)
    jsr = JShardedReceiver(_jmesh(2, 2), js, **kw)
    got, jgot = [], []
    for b in range(3):
        xb = x[b * 24960 * HOP:(b + 1) * 24960 * HOP]
        got += sr.push(xb)
        jgot += jsr.push(xb)
    assert len(got) == len(events)
    _same_reports(got, single, atol=1e-3, rssi_rtol=1e-3)
    _same_reports(got, jgot)
    assert all(r.word_ok[:2].all() for r in got)
    assert sr.reports == got


def test_sharded_report_compaction_overflow():
    """max_reports=1 with two bursts in one row window: the overflow is
    counted and the full planes are fetched, so delivery is lossless and
    equal to the default width's."""
    _, ts = _specs()
    js, _ = _specs()
    events = [MobileEvent("page_response", 2, 500, "5551234567"),
              MobileEvent("page_response", 5, 800, "4155559876")]
    x = synthesize_reverse_band(events, js, 24960, noise_sigma=0.001)
    sr = ShardedReceiver(_mesh(2, 2), ts, max_bursts=4, threshold=0.55)
    full = sr.push(x) + sr.flush()
    assert len(full) == 2 and sr.report_overflows == 0
    assert {r.channel for r in full} == {2, 5}
    sr1 = ShardedReceiver(_mesh(2, 2), ts, max_bursts=4, threshold=0.55,
                          max_reports=1)
    got = sr1.push(x) + sr1.flush()
    assert sr1.report_overflows >= 1
    _same_reports(got, full, atol=0.0, rssi_rtol=0.0)
    for r in got:
        ev = events[0] if r.channel == 2 else events[1]
        want = np.stack(ev.words())
        assert np.array_equal(r.words[: len(want)], want)


def test_sharded_flush_reports_tail_pending_burst():
    """A burst whose capture runs past the last block: deferred by the
    guard, reported by flush() as by the single-device flush(pad_tail);
    flush is idempotent and closes the receiver."""
    js, ts = _specs()
    total = 2 * 24960
    ev = MobileEvent("page_response", 3, total - 6000, "4155559876")
    x = synthesize_reverse_band([ev], js, total, noise_sigma=0.001)
    kw = dict(max_bursts=4, threshold=0.55, policy="first_ok", min_rssi=0.05)
    sr = ShardedReceiver(_mesh(2, 2), ts, **kw)
    pushed = []
    for b in range(2):
        pushed += sr.push(x[b * 24960 * HOP:(b + 1) * 24960 * HOP])
    assert pushed == []
    flushed = sr.flush()
    assert len(flushed) == 1 and flushed[0].channel == 3
    want = np.stack(ev.words())
    assert flushed[0].word_ok[: len(want)].all()
    assert np.array_equal(flushed[0].words[: len(want)], want)
    assert sr.flush() == []
    with pytest.raises(RuntimeError, match="push after flush"):
        sr.push(x[:24960 * HOP])
    mr = MultichannelReceiver(ts, device="cpu", **kw)
    for i in range(4):
        assert mr.push(x[i * 12480 * HOP:(i + 1) * 12480 * HOP]) == []
    _same_reports(flushed, mr.flush(pad_tail=True), atol=1e-3,
                  rssi_rtol=1e-3)


def test_sharded_stream_variable_block_lengths():
    """Blocks of 2 x 10560 and then 2 x 14880 hops: absolute positions
    follow the consumed samples, as in the single-device receiver and the
    JAX ShardedReceiver."""
    js, ts = _specs()
    ha, hb = 2 * 10560, 2 * 14880
    events = [MobileEvent("page_response", 2, 4000, "4155559876"),
              MobileEvent("origination", 5, ha + 9000, "5551234567",
                          "7025551000", esn=42)]
    x = synthesize_reverse_band(events, js, ha + hb, noise_sigma=0.001)
    kw = dict(max_bursts=4, threshold=0.55, policy="first_ok", min_rssi=0.05)
    mr = MultichannelReceiver(ts, device="cpu", **kw)
    single = mr.push(x[:ha * HOP]) + mr.push(x[ha * HOP:])
    single += mr.flush(pad_tail=True)
    sr = ShardedReceiver(_mesh(2, 2), ts, **kw)
    got = sr.push(x[:ha * HOP]) + sr.push(x[ha * HOP:]) + sr.flush()
    jsr = JShardedReceiver(_jmesh(2, 2), js, **kw)
    jgot = jsr.push(x[:ha * HOP]) + jsr.push(x[ha * HOP:]) + jsr.flush()
    assert len(got) == len(single) == len(events)
    # the single-device windows differ from the rows here, and with them
    # the 384-hop power blocks of the rssi: positions and words only
    for a, b in zip(got, single):
        assert (a.channel, a.abs_symbol) == (b.channel, b.abs_symbol)
        assert np.array_equal(a.words, b.words)
        assert np.array_equal(a.word_ok, b.word_ok)
    _same_reports(got, jgot)


@functools.lru_cache(maxsize=None)
def _supervision_band():
    """One slot ringing (SAT + ST) until 0.4 s, then SAT + voice, carrier
    dead from 0.9 s: 4 blocks of 2 x 11520 hops."""
    from amps_tpu.dsp import channelizer as jchz
    from amps_tpu.dsp.fm import fm_modulate
    js, _ = _specs()
    fs = float(js.pipe.chan_rate)
    sens = 2.0 * np.pi * js.pipe.deviation_hz / fs
    n = 4 * 2 * 11520
    t = np.arange(n) / fs
    sat = 0.05 * np.cos(2 * np.pi * 6000.0 * t)
    st = 0.05 * np.cos(2 * np.pi * 10000.0 * t)
    voice = 0.3 * np.cos(2 * np.pi * 1000.0 * t)
    m = np.where(t < 0.4, sat + st, sat + voice)
    iq = np.array(fm_modulate(jnp.asarray(m, jnp.float32), sens)[0])
    iq[t >= 0.9] = 0.0
    Y = np.zeros((n, 8, 2), np.float32)
    Y[:, 5] = iq
    x, _ = jchz.synthesize(jnp.asarray(Y), js.chz_spec,
                           jchz.synthesizer_init(js.chz_spec))
    return np.asarray(x)


@pytest.mark.parametrize("bf16", [False, True])
def test_sharded_supervision_matches_single_device_and_jax(bf16):
    """The supervision tap: ring -> answer -> conversation -> fade ->
    release, the same timeline from the port's ShardedReceiver, its
    MultichannelReceiver and the JAX ShardedReceiver, at f32 and at the
    bf16 dtypes."""
    from amps_tpu.control.supervision import ChannelSupervisor as JSup
    from amps_tpu.control.supervision import SupervisionConfig as JCfg
    from amps_tpu_torch.control.supervision import (ALERTING,
                                                    ChannelSupervisor,
                                                    SupervisionConfig)
    js, ts = _specs(io_bf16=bf16, corr_bf16=bf16)
    x = _supervision_band()
    blk = 2 * 11520 * HOP

    def run(make_rx, sup_cls, cfg_cls):
        cfg = dataclasses.replace(cfg_cls(), fade_timeout_s=0.3)
        sup = sup_cls(5, scc=1, config=cfg, state=ALERTING)
        sup.begin_alert()
        rx = make_rx(supervision_slots=(5,),
                     on_supervision=lambda s, lv, pw: sup.push_frames(lv, pw))
        for b in range(4):
            rx.push(x[b * blk:(b + 1) * blk])
        return [(e.kind, e.channel, round(e.t, 2)) for e in sup.events]

    sharded = run(lambda **kw: ShardedReceiver(_mesh(2, 2), ts, **kw),
                  ChannelSupervisor, SupervisionConfig)
    single = run(lambda **kw: MultichannelReceiver(ts, device="cpu", **kw),
                 ChannelSupervisor, SupervisionConfig)
    jsharded = run(lambda **kw: JShardedReceiver(_jmesh(2, 2), js, **kw),
                   JSup, JCfg)
    kinds = [k for k, _, _ in sharded]
    assert "answer" in kinds and "release" in kinds, sharded
    assert sharded == single == jsharded


def test_sharded_supervision_tap_matches_jax_rows():
    """The gathered rows of the watched slots against the JAX step's
    one-hot selection + psum, sample by sample (a tone-carrying slot and
    the slot of another chan rank)."""
    js, ts = _specs()
    x = _supervision_band()[:2 * 11520 * HOP]
    hal = jpl.full_demod_halo(js)
    jout, _ = jpl.make_sharded_rx_stream_step(
        _jmesh(2, 2), js, hal, supervision_slots=(5, 1))(
        jnp.asarray(x), jpl.sharded_stream_state(js, hal))
    out, _ = pl.make_sharded_rx_stream_step(
        _mesh(2, 2), ts, hal, supervision_slots=(5, 1))(
        torch.as_tensor(x), pl.sharded_stream_state(ts, hal, "cpu"))
    got, want = out["sup_demod"].numpy(), np.asarray(jout["sup_demod"])
    assert got.shape == want.shape == (2, 2, 11520)
    # slot 5 carries the tone; slot 1 is roundoff noise, whose phase two
    # correct f32 orders put anywhere: only its shape is held
    assert np.abs(got[:, 0] - want[:, 0]).max() <= 1e-3


@pytest.mark.parametrize("package", ["port", "jax"])
def test_overflow_fetch_precedes_supervision(package, monkeypatch):
    """ADVICE.md r5 finding 3: a device failure while fetching the full
    report planes (the overflow path).  The port fetches them before any
    supervision frame goes out, so nothing of the block is delivered; the
    JAX package has already delivered the block's supervision frames
    when the fetch fails."""
    js, ts = _specs()
    events = [MobileEvent("page_response", 2, 500, "5551234567"),
              MobileEvent("page_response", 5, 800, "4155559876")]
    x = synthesize_reverse_band(events, js, 24960, noise_sigma=0.001)
    frames = []
    kw = dict(max_bursts=4, threshold=0.55, max_reports=1,
              supervision_slots=(6,),
              on_supervision=lambda s, lv, pw: frames.append(s))
    if package == "port":
        rx = ShardedReceiver(_mesh(2, 2), ts, **kw)

        def fail(planes):
            raise RuntimeError("device lost")
        monkeypatch.setattr(pstream.streamer, "_flatten_full", fail)
    else:
        rx = JShardedReceiver(_jmesh(2, 2), js, **kw)
        calls = {"n": 0}
        real = jax.device_get

        def fail(tree):
            calls["n"] += 1
            if calls["n"] == 2:          # the full-plane fetch
                raise RuntimeError("device lost")
            return real(tree)
        monkeypatch.setattr(jax, "device_get", fail)
    with pytest.raises(RuntimeError, match="device lost"):
        rx.push(x)
    assert rx.reports == []
    assert frames == ([] if package == "port" else [6])


def test_transceiver_superframes_per_block():
    _, ts = _specs()
    assert ShardedTransceiver(_mesh(2, 2), ts).superframes_per_block == 1
    # 50004 hops a superframe: 8 workers need two
    assert ShardedTransceiver(_mesh(4, 2), ts).superframes_per_block == 2
    with pytest.raises(ValueError, match="already carries FOCC"):
        ShardedTransceiver(_mesh(2, 2), ts, control_channels=[1]
                           ).set_channel_source(1, lambda n: None)


def test_full_call_over_sharded_rf():
    """A whole call where the mobile hears FOCC and FVC from the sharded
    wideband (page -> response -> voice assignment -> FVC alert -> ring
    -> answer -> release) and its RECC burst travels through the sharded
    RX side of the same full-duplex ShardedTransceiver step."""
    from amps_tpu_torch.control.station import BaseStation
    from amps_tpu_torch.dsp.fm import fm_modulate_symbols, quadrature_demod
    from amps_tpu_torch.ms import SimMobile
    from amps_tpu_torch.runtime.sources import VoiceFvcSlot
    _, ts = _specs()
    sps, RXH = ts.chan_sps, 20704
    station = BaseStation(sps=sps)
    trx = ShardedTransceiver(
        _mesh(2, 2), ts, control_channels=[1], threshold=0.5, min_rssi=0.05,
        on_burst=lambda r: station.handle_burst(r.words, r.word_ok,
                                                r.bad_symbols))
    assert trx.superframes_per_block == 1
    station.focc = trx.focc[1]
    trx.set_channel_source(4, VoiceFvcSlot(station, device="cpu"))
    mob = SimMobile("5551234567", sps=sps)
    ear = {"s": chz.analyzer_init(ts.chz_spec, device="cpu")}
    silence = torch.zeros((RXH * HOP, 2))

    def forward(x_rx=None):
        tx, _ = trx.push(silence if x_rx is None else x_rx)
        Y, ear["s"] = chz.analyze(tx, ts.chz_spec, ear["s"], chmajor=True)
        mob.hear_focc(quadrature_demod(Y[1])[0].numpy(), sps=sps)
        mob.hear_fvc(quadrature_demod(Y[4])[0].numpy(), sps=sps)

    def reverse():
        while mob.outbox:
            _, syms = mob.outbox.pop(0)
            bb, _ = fm_modulate_symbols(torch.as_tensor(syms.astype(np.int8)),
                                        ts.fm_sensitivity)
            Y = torch.zeros((RXH, 8, 2))
            Y[2000: 2000 + bb.shape[0], 3] = bb
            x, _ = chz.synthesize(Y, ts.chz_spec,
                                  chz.synthesizer_init(ts.chz_spec,
                                                       device="cpu"))
            forward(x)

    station.handle_command("page 5551234567")
    forward()
    assert "paged" in mob.log
    reverse()
    assert station.supervisors[355].state == "alerting"
    forward()
    assert mob.voice_chan == 355 and mob.state == "ringing", mob.log
    station.push_supervision(355, *mob.supervision_frames(30))
    mob.answer()
    station.push_supervision(355, *mob.supervision_frames(30))
    assert station.supervisors[355].state == "conversation"
    mob.hang_up()
    station.push_supervision(355, *mob.supervision_frames(200))
    assert 355 not in station.supervisors
    assert mob.log == ["paged", "assigned 355", "ringing", "answered",
                       "hang_up"], mob.log
    assert trx.flush() == []


def test_weak_scaling_runs_at_every_size():
    from amps_tpu_torch.eval.scaling import weak_scaling
    res = weak_scaling((1, 2, 4), iters=1, devices=["cpu"])
    assert sorted(res) == [1, 2, 4]
    for size, r in res.items():
        assert r["workers"] == size and r["devices"] == 1
        assert r["wideband_samples"] == 2 * size * 2778 * 4
        assert r["samples_per_sec"] > 0
    assert res[1]["efficiency"] == 1.0


def test_dryrun_multichip_on_the_cpu():
    from amps_tpu_torch.dryrun import dryrun_multichip
    s = dryrun_multichip(4, device="cpu")
    assert s["mesh"] == (2, 2) and s["bursts"] == 4
    assert s["loop_words_ok"] >= 7
