"""The port's mobile-station simulator against the JAX package's: the
FOCC frame decoder and word parser, the FVC word decoder, and SimMobile's
state machine over a scripted call.  The decoders are host code on the
same symbols: exact.  ``rvc_baseband`` FM-modulates with an f32 cumsum
(summation order differs between backends): 2e-3 on unit-modulus IQ."""

import dataclasses

import numpy as np
import pytest
import torch

from amps_tpu.codec import words as JW
from amps_tpu.control import fields as jfields
from amps_tpu.control.station import BaseStation
from amps_tpu.ms import focc_rx as jfocc_rx
from amps_tpu.ms import fvc_rx as jfvc_rx
from amps_tpu.ms import mobile as jmobile
from amps_tpu.rx import correlator, decoder
from amps_tpu.tx.focc import STREAM_BOTH
from amps_tpu.tx.fvc import FvcStream
from amps_tpu_torch.ms import focc_rx as tfocc_rx
from amps_tpu_torch.ms import fvc_rx as tfvc_rx
from amps_tpu_torch.ms import mobile as tmobile

torch.set_num_threads(1)

SPS = 5


def _frames(frames):
    return [tuple(np.asarray(v).tolist() for v in dataclasses.astuple(f))
            for f in frames]


def _page_station():
    bs = BaseStation()
    min1, min2 = jfields.parse_min("5551234567")
    bs.focc.push_words(STREAM_BOTH, [np.asarray(JW.focc_word1(True, 0, min1)),
                                     np.asarray(JW.focc_word2_general(
                                         min2, 0, 0, 0))], repeats=2)
    bs.focc.mark_busy(1)
    return bs


@pytest.mark.parametrize("sigma,cut", [(0.0, 0), (0.6, 0), (0.6, 1237)])
def test_focc_decode_and_parse_match_jax(sigma, cut):
    """A busy superframe carrying a page, with noise and a cut start."""
    bs = _page_station()
    syms = np.concatenate([np.asarray(bs.focc.next_superframe_symbols(),
                                      np.float32) for _ in range(2)])
    rng = np.random.default_rng(cut)
    x = (syms + rng.normal(0, sigma, syms.shape)).astype(np.float32)[cut:]
    want, wc = jfocc_rx.decode_focc_stream(x, SPS, return_consumed=True)
    got, gc = tfocc_rx.decode_focc_stream(x, SPS, return_consumed=True)
    assert gc == wc and _frames(got) == _frames(want)
    assert len(want) >= 30 and any(f.busy for f in want)
    for f in want:
        for w in (f.word_a, f.word_b):
            assert tfocc_rx.parse_focc_word(w) == jfocc_rx.parse_focc_word(w)
    types = {tfocc_rx.parse_focc_word(f.word_a)["type"] for f in got}
    assert "word1" in types


@pytest.mark.parametrize("cut,sigma", [(0, 0.0), (SPS, 0.4), (17, 0.7)])
def test_fvc_decode_matches_jax(cut, sigma):
    words = np.stack([np.asarray(JW.fvc_word1_general(1, 0, 0, 1)),
                      np.asarray(JW.fvc_word1_voice_channel(1, 1, 0, 356))])
    fvc = FvcStream(sps=SPS)
    fvc.set_words(words, timer=0)
    blk = fvc.next_block(2 * 1032 * 2 * SPS + 501).astype(np.float32)
    rng = np.random.default_rng(cut)
    x = (blk + rng.normal(0, sigma, blk.shape)).astype(np.float32)[cut:]
    want = jfvc_rx.decode_fvc_words(x, SPS)
    got = tfvc_rx.decode_fvc_words(x, SPS)
    assert [g.tolist() for g in got] == [np.asarray(w).tolist()
                                         for w in want]
    assert len(got) == 2
    first = tfvc_rx.decode_fvc_stream(x, SPS)
    assert np.array_equal(first, np.asarray(jfvc_rx.decode_fvc_stream(x,
                                                                      SPS)))


def _deliver(bs, syms):
    """Mobile RECC burst symbols -> station via the JAX decode stack."""
    lead = np.tile(np.array([1, -1], np.int8), 300)
    stream = np.concatenate(
        [lead, syms, np.zeros(correlator.CAPTURE_SYMBOLS * SPS, np.int8)]
    ).astype(np.float32)
    starts, valid, q, hard, soft = correlator.find_and_extract(
        stream, SPS, max_bursts=1, threshold=0.5)
    assert bool(np.asarray(valid)[0])
    dec = decoder.decode_bursts(np.asarray(hard)[0])
    bs.handle_burst(np.asarray(dec.words), np.asarray(dec.word_ok))


def _state(mob):
    return (mob.state, mob.voice_chan, mob.sat_scc, mob.recc_busy,
            list(mob.log), [(k, np.asarray(b).tolist()) for k, b in
                            mob.outbox],
            mob._st_release_frames, mob._focc_tail.tolist())


def test_sim_mobile_matches_jax_over_a_call():
    """Registration, origination, page, response, assignment, alert,
    answer, handoff and release: two mobiles (the JAX package's and the
    port's) hear the same symbols and must keep the same state, log,
    outbox and supervision frames; the JAX mobile's bursts drive the
    station."""
    bs = BaseStation()
    mobs = [m.SimMobile("5551234567", esn=0xDEADBEEF, sps=SPS)
            for m in (jmobile, tmobile)]

    def check():
        assert _state(mobs[1]) == _state(mobs[0])

    def focc():
        sf = np.asarray(bs.focc.next_superframe_symbols(), np.float32)
        for m in mobs:
            m.hear_focc(sf[:20001])
            m.hear_focc(sf[20001:])
        check()

    def fvc(n=1032 * 2 * SPS * 2 + 333):
        blk = bs.fvc.next_block(n).astype(np.float32)
        for m in mobs:
            m.hear_fvc(blk)
        check()

    def send():
        kind, burst = mobs[0].outbox.pop(0)
        mobs[1].outbox.pop(0)
        _deliver(bs, burst)

    def frames(n):
        lv = [m.supervision_frames(n) for m in mobs]
        for a, b in zip(*lv):
            assert np.array_equal(a, b)
        bs.push_supervision(mobs[0].voice_chan, *lv[0])
        check()

    for m in mobs:
        m.register()
    check()
    send()
    focc()
    assert "audit_confirmed" in mobs[1].log
    for m in mobs:
        m.originate("16505551234")          # RECC busy: deferred
    check()
    focc()
    bs.handle_command("page 5551234567")
    focc()
    send()
    focc()
    assert mobs[1].voice_chan == 355
    fvc()
    assert mobs[1].state == "ringing"
    frames(30)
    for m in mobs:
        m.answer()
    frames(30)
    bs.handoff(355, 356)
    fvc()
    assert mobs[1].voice_chan == 356
    iq = [m.rvc_baseband(3000, 60_000.0, 0.8) for m in mobs]
    assert np.abs(iq[1] - iq[0]).max() < 2e-3
    for m in mobs:
        m.hang_up()
    check()
    frames(200)
    assert mobs[1].log == mobs[0].log
    assert "hang_up" in mobs[1].log
