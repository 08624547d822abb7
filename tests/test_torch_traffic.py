"""The port's multi-mobile traffic (``amps_tpu_torch.eval.traffic``):
``random_events`` draws the JAX package's event list from one seed, the
reverse band of ``MobileEvent``s matches the JAX band, and the soak --
every event found once, decoded and dispatched by the station under its
capacity rule -- runs on the port, streamed block by block and through
the executor over the native ring."""

import threading

import numpy as np
import pytest
import torch

from amps_tpu.eval import traffic as jtraffic
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu_torch.control.station import BaseStation
from amps_tpu_torch.eval.traffic import (BurstEvent, MobileEvent,
                                         random_events,
                                         synthesize_reverse_band)
from amps_tpu_torch.parallel.pipeline import MultichannelSpec
from amps_tpu_torch.runtime.executor import ThreadedExecutor
from amps_tpu_torch.runtime.native_rt import Ring
from amps_tpu_torch.runtime.sdr import RingIQSink, RingIQSource, source_reader
from amps_tpu_torch.runtime.streamer import MultichannelReceiver

torch.set_num_threads(1)

KW = dict(num_channels=8, taps_per_phase=8)
SPEC = MultichannelSpec(**KW)
SOAK_HOPS = 140_000


@pytest.mark.parametrize("seed", [0, 7, 23])
def test_random_events_match_jax(seed):
    want = jtraffic.random_events(12, JSpec(**KW), SOAK_HOPS, seed=seed)
    got = random_events(12, SPEC, SOAK_HOPS, seed=seed)
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert all(isinstance(e, MobileEvent) for e in got)
    for a, b in zip(got, want):
        assert np.array_equal(np.stack(a.words()), np.stack(b.words()))


def test_reverse_band_of_mobile_events_matches_jax():
    events = random_events(5, SPEC, 30_000, seed=3)
    want = np.asarray(jtraffic.synthesize_reverse_band(
        [jtraffic.MobileEvent(**vars(e)) for e in events], JSpec(**KW),
        30_000, noise_sigma=0.01))
    got = synthesize_reverse_band(events, SPEC, 30_000, noise_sigma=0.01,
                                  device="cpu")
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-5
    # a MobileEvent and a BurstEvent of the same words give the same band
    ev = events[0]
    burst = BurstEvent(ev.channel, ev.start_hop, np.stack(ev.words()))
    assert torch.equal(
        synthesize_reverse_band([ev], SPEC, 30_000, device="cpu"),
        synthesize_reverse_band([burst], SPEC, 30_000, device="cpu"))


@pytest.mark.parametrize("text,want", [
    ("origination:5551234567:5551230000",
     lambda ms: ms.origination_words("5551234567", "5551230000")),
    ("page_response:7735550000",
     lambda ms: ms.page_response_words("7735550000")),
    ("registration:7735550000:0x77",
     lambda ms: ms.registration_words("7735550000", esn=0x77)),
    ("registration:7735550000",
     lambda ms: ms.registration_words("7735550000")),
])
def test_mobile_event_parse_gives_the_jax_words(text, want):
    """The command-line forms of ``bs --simulate`` and ``monitor
    --synthesize``: the parsed event's words are the JAX package's."""
    from amps_tpu.tx import recc_ms as jrecc_ms
    ev = MobileEvent.parse(text, channel=3, start_hop=1000)
    assert (ev.kind, ev.channel, ev.start_hop) == (text.split(":")[0], 3,
                                                   1000)
    assert np.array_equal(np.stack(ev.words()), np.stack(want(jrecc_ms)))


def test_mobile_event_parse_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="handoff"):
        MobileEvent.parse("handoff:5551234567")


def _expected_focc(events, station):
    """FOCC responses under the station's capacity rule: registrations
    always answer (+1), a served page response +1, a served origination
    +2 (assignment + loopback page), an intercept origination +2 with no
    channel, an over-capacity response/origination +0.  Returns (count,
    whether capacity was reached)."""
    free = set(station._vc_plan)
    expect = 0
    for ev in sorted(events, key=lambda e: e.start_hop):
        if ev.kind == "registration":
            expect += 1
        elif ev.kind == "page_response":
            if free:
                free.pop()
                expect += 1
        elif ev.dialed and ev.dialed[0] == "0":
            expect += 2
        elif free:
            free.pop()
            expect += 2
    return expect, not free


def _check_soak(events, reports, station):
    assert len(reports) == len(events), (len(reports), len(events))
    assert sorted(r.channel for r in reports) == \
        sorted(e.channel for e in events)
    expect, full = _expected_focc(events, station)
    focc = [e for e in station.events if e.kind == "focc_words"]
    assert len(focc) == expect, (len(focc), expect)
    if full:
        assert any("no free voice channel" in str(e.payload)
                   for e in station.events if e.kind == "debug")
    assert all(r.word_ok[:2].all() for r in reports)


def test_multi_mobile_soak():
    events = random_events(12, SPEC, SOAK_HOPS, seed=7)
    assert len(events) >= 8
    x = synthesize_reverse_band(events, SPEC, SOAK_HOPS, noise_sigma=0.02,
                                device="cpu")
    st = BaseStation(sps=SPEC.chan_sps)
    rx = MultichannelReceiver(
        SPEC, on_burst=lambda r: st.handle_burst(r.words, r.word_ok),
        threshold=0.6, max_bursts=6, min_rssi=0.05, device="cpu")
    P = SPEC.chz_spec.hop
    reports = []
    for off in range(0, x.shape[0], 16384 * P):
        reports += rx.push(x[off: off + 16384 * P])
    _check_soak(events, reports, st)


def test_soak_through_executor_over_native_ring():
    """A writer thread stands in for the radio process: it feeds the band
    into a ring smaller than the band (backpressure) and marks the end;
    the executor drains it into the receiver."""
    total = 60_000
    events = random_events(6, SPEC, total, seed=11)
    x = synthesize_reverse_band(events, SPEC, total, noise_sigma=0.02,
                                device="cpu")
    st = BaseStation(sps=SPEC.chan_sps)
    rx = MultichannelReceiver(
        SPEC, on_burst=lambda r: st.handle_burst(r.words, r.word_ok),
        threshold=0.6, max_bursts=6, min_rssi=0.05, device="cpu")
    ring = Ring(1 << 20)
    src = RingIQSource(ring, timeout_s=5.0)

    def radio():
        RingIQSink(ring).write(x)
        src.mark_eof()

    t = threading.Thread(target=radio)
    t.start()
    stats = ThreadedExecutor(rx_source=source_reader(src, 1 << 16),
                             rx_push=rx.push).start().join(timeout=300)
    t.join(30)
    rx.flush(pad_tail=True)
    assert stats.rx_samples == x.shape[0]
    _check_soak(events, rx.reports, st)
