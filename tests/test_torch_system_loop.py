"""The slice as a whole: a full call over channelized RF in both
directions, run in the JAX package and in the port (on the CPU) from the
same start.  The mobile hears the transmitter's wideband output through
the analysis bank and FM discriminator; its RECC bursts travel through
the synthesis bank into the streaming receiver and on to the station.

Held: identical ``mob.log``, station event sequences (kinds and
payloads, not ``StationEvent.t``) and supervisor states at each step,
and the forward superframes within 2e-4 of their peak (the synthesis of
the two packages sums in other f32 orders; the transmitter tests hold
the same).  The JAX side is ``tests/test_system_loop.py``'s own
scenario, its ear the JAX default analysis (hop-major, ``fold="conv"``);
the port's ear is ``dsp.channelizer.analyze`` (K1's plain version on the
CPU)."""

import dataclasses
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.codec import bch as jbch
from amps_tpu.control import station as jstation
from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp import fm as jfm
from amps_tpu.ms import mobile as jmobile
from amps_tpu.parallel import pipeline as jpl
from amps_tpu.ref import words_ref
from amps_tpu.runtime import sources as jsrc
from amps_tpu.runtime import streamer as jstreamer
from amps_tpu.tx import recc_ms as jrecc
from amps_tpu_torch import convert
from amps_tpu_torch.control import station as tstation
from amps_tpu_torch.dsp import channelizer as tchz
from amps_tpu_torch.dsp import fm as tfm
from amps_tpu_torch.kernels import analysis as KA
from amps_tpu_torch.ms import fvc_rx as tfvc_rx
from amps_tpu_torch.ms import mobile as tmobile
from amps_tpu_torch.parallel import pipeline as tpl
from amps_tpu_torch.runtime import sources as tsrc
from amps_tpu_torch.runtime import streamer as tstreamer

torch.set_num_threads(1)

M = 8
FOCC_SLOT = 1
FVC_SLOT = 4          # carries AMPS channel 355's forward voice/FVC
REVERSE_SLOT = 3      # the mobile's reverse channel in the RX bank
TX_PEAK_RTOL = 2e-4


def _norm(v):
    """A payload as plain Python (arrays as lists, dataclasses as their
    class name and fields)."""
    if isinstance(v, torch.Tensor) or hasattr(v, "__array__"):
        return np.asarray(v).tolist()
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, tuple(_norm(getattr(v, f.name))
                                        for f in dataclasses.fields(v)))
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v


def events(station):
    return [(e.kind, _norm(e.payload)) for e in station.events]


def _jax_ear(spec):
    state = {"s": jchz.analyzer_init(spec.chz_spec)}

    def ear(blk):
        Y, state["s"] = jchz.analyze(np.asarray(blk), spec.chz_spec,
                                     state["s"])
        Y = np.asarray(Y)                          # (hops, M, 2)
        return [np.asarray(jfm.quadrature_demod(Y[:, k])[0])
                for k in (FOCC_SLOT, FVC_SLOT)]
    return ear


def _port_ear(spec):
    state = {"s": tchz.analyzer_init(spec.chz_spec, device="cpu")}

    def ear(blk):
        Y, state["s"] = tchz.analyze(blk, spec.chz_spec, state["s"],
                                     chmajor=True)
        return [tfm.quadrature_demod(Y[k])[0].numpy()       # (M, hops, 2)
                for k in (FOCC_SLOT, FVC_SLOT)]
    return ear


JAX = types.SimpleNamespace(
    spec=jpl.MultichannelSpec(num_channels=M, taps_per_phase=8),
    station=jstation, mobile=jmobile, sources=jsrc, streamer=jstreamer,
    ear=_jax_ear, kw={}, chz=jchz,
    modulate=lambda syms, sens: np.asarray(jfm.fm_modulate_symbols(
        syms.astype(np.int8), sens)[0]),
    synth_init=jchz.synthesizer_init)
PORT = types.SimpleNamespace(
    spec=tpl.MultichannelSpec(num_channels=M, taps_per_phase=8,
                              fold="bank"),
    station=tstation, mobile=tmobile, sources=tsrc, streamer=tstreamer,
    ear=_port_ear, kw={"device": "cpu"}, chz=tchz,
    modulate=lambda syms, sens: tfm.fm_modulate_symbols(
        torch.as_tensor(syms.astype(np.int8)), sens)[0].numpy(),
    synth_init=lambda s: tchz.synthesizer_init(s, device="cpu"))


def run_call(pkg):
    """tests/test_system_loop.py's call in package ``pkg``; returns what
    is compared: the forward superframes, the station states and event
    sequences after each step, and the mobile's log."""
    spec, sps = pkg.spec, pkg.spec.chan_sps
    station = pkg.station.BaseStation(sps=sps)
    tx = pkg.streamer.MultichannelTransmitter(
        spec, control_channels=[FOCC_SLOT], **pkg.kw)
    station.focc = tx.focc[FOCC_SLOT]
    tx.set_channel_source(FVC_SLOT, pkg.sources.VoiceFvcSlot(station, **pkg.kw))
    rx = pkg.streamer.MultichannelReceiver(
        spec, threshold=0.5, min_rssi=0.05,
        on_burst=lambda r: station.handle_burst(r.words, r.word_ok,
                                                r.bad_symbols), **pkg.kw)
    mob = pkg.mobile.SimMobile("5551234567", sps=sps)
    ear = pkg.ear(spec)
    out = {"superframes": [], "steps": []}

    def step(name):
        out["steps"].append((name, events(station), list(mob.log),
                             mob.state, mob.voice_chan,
                             {c: s.state
                              for c, s in station.supervisors.items()},
                             (station.fvc_mute, station.audio_mute)))

    def forward():
        blk = tx.next_block()
        out["superframes"].append(np.asarray(blk))
        focc_demod, fvc_demod = ear(blk)
        mob.hear_focc(focc_demod, sps=sps)
        mob.hear_fvc(fvc_demod, sps=sps)

    def reverse():
        while mob.outbox:
            kind, syms = mob.outbox.pop(0)
            bb = pkg.modulate(syms, 2 * np.pi * spec.pipe.deviation_hz
                              / spec.pipe.chan_rate)
            hops = len(bb) + 4000
            Y = np.zeros((hops, M, 2), np.float32)
            Y[2000: 2000 + len(bb), REVERSE_SLOT] = bb
            x, _ = pkg.chz.synthesize(Y, spec.chz_spec,
                                      pkg.synth_init(spec.chz_spec))
            x = np.asarray(x)
            P = spec.chz_spec.hop
            rx.push(x[: (len(x) // P) * P])

    station.handle_command("page 5551234567")
    forward()
    step("page")
    reverse()
    step("response")
    forward()
    step("assignment")
    station.push_supervision(355, *mob.supervision_frames(30))
    step("ringing")
    mob.answer()
    station.push_supervision(355, *mob.supervision_frames(30))
    step("answer")
    station.handle_command("handoff 355 356")
    forward()
    step("handoff")
    station.push_supervision(356, *mob.supervision_frames(50))
    step("new channel")
    mob.hang_up()
    station.push_supervision(356, *mob.supervision_frames(200))
    step("release")
    out["log"] = list(mob.log)
    return out


@pytest.fixture(scope="module")
def calls():
    return run_call(JAX), run_call(PORT)


def test_full_call_over_channelized_rf_matches_jax(calls):
    want, got = calls
    assert want["log"] == ["paged", "assigned 355", "ringing", "answered",
                           "handoff 355->356", "hang_up"]
    assert got["log"] == want["log"]
    for g, w in zip(got["steps"], want["steps"]):
        assert g == w, w[0]
    assert len(got["steps"]) == len(want["steps"]) == 8
    last = got["steps"][-1]
    assert 356 not in last[5] and "release" in [e[0] for e in last[1]]


def test_forward_superframes_match_jax(calls):
    want, got = calls
    assert len(got["superframes"]) == len(want["superframes"]) == 3
    for g, w in zip(got["superframes"], want["superframes"]):
        assert g.shape == w.shape == (50004 * M // 2, 2)
        peak = np.abs(w).max()
        assert np.abs(g - w).max() <= TX_PEAK_RTOL * peak


def _decode_fvc_alert(demod, sps):
    """tests/test_fvc_rf.py's decode: word sync + a BCH-clean 40-bit word
    at the best symbol phase."""
    from amps_tpu.codec.manchester import manchester_decode_bits
    wsync = np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], np.uint8)
    nsym = len(demod) // sps
    for p in range(sps):
        m = demod[p: p + nsym * sps - sps].reshape(-1, sps).mean(-1)
        hard = (m >= 0).astype(np.uint8)
        bits = np.asarray(manchester_decode_bits(
            hard[: len(hard) - len(hard) % 2])[0])
        for off in range(len(bits) - 51):
            if np.array_equal(bits[off: off + 11], wsync):
                dec, ok = jbch.focc_bch_decode(bits[off + 11: off + 51][None])
                if bool(np.asarray(ok)[0]):
                    return np.asarray(dec)[0]
    return None


def test_fvc_alert_over_rf_matches_jax():
    """tests/test_fvc_rf.py in both packages: the station alerts a mobile
    on slot 2; the FVC word decodes from either package's wideband RF,
    through the JAX analysis and through the port's."""
    outs = []
    for pkg in (JAX, PORT):
        st = pkg.station.BaseStation(sps=pkg.spec.chan_sps)
        tx = pkg.streamer.MultichannelTransmitter(pkg.spec,
                                                  control_channels=[1],
                                                  **pkg.kw)
        st.focc = tx.focc[1]
        tx.set_channel_source(2, pkg.sources.VoiceFvcSlot(st, **pkg.kw))
        words, ok = np.zeros((7, 36), np.uint8), np.zeros(7, bool)
        for i, w in enumerate(jrecc.page_response_words("5551234567")):
            words[i], ok[i] = w, True
        st.handle_burst(words, ok)
        assert st.fvc_mute is False
        outs.append((st, np.asarray(tx.next_block())))
    (jst, jrf), (tst, trf) = outs
    assert np.abs(trf - jrf).max() <= TX_PEAK_RTOL * np.abs(jrf).max()
    spec = PORT.spec.chz_spec
    y_port, _ = tchz.analyze(torch.as_tensor(trf), spec,
                             tchz.analyzer_init(spec, device="cpu"),
                             chmajor=True)
    d_port = tfm.quadrature_demod(y_port[2][None])[0][0].numpy()
    ych, _ = jchz.analyze(jrf, JAX.spec.chz_spec,
                          jchz.analyzer_init(JAX.spec.chz_spec), chmajor=True)
    d_jax = np.asarray(jfm.quadrature_demod(jnp.asarray(
        np.asarray(ych)[2][None]))[0])[0]
    want = words_ref.fvc_word1_general(jst.system.scc, 0, 0, 1)   # alert
    sps = PORT.spec.chan_sps
    for d in (d_port, d_jax):
        info28 = _decode_fvc_alert(d[2000:40000], sps)
        assert info28 is not None and np.array_equal(info28, want)
    got = tfvc_rx.decode_fvc_words(d_port[2000:40000], sps)
    assert got and np.array_equal(got[0], want)


def test_port_ear_continues_a_jax_ear():
    """The mobile's ear handed over mid-stream: a JAX ear analyzes the
    first superframe, the port's continues from its AnalyzerState
    (convert.analyzer_state_from_numpy) and matches the JAX ear's second
    superframe within 2e-4, on the CPU without a kernel launch."""
    spec = JAX.spec
    tx = jstreamer.MultichannelTransmitter(spec, control_channels=[1, 6])
    blocks = [np.asarray(tx.next_block()) for _ in range(2)]
    jst = jchz.analyzer_init(spec.chz_spec)
    _, jst = jchz.analyze(blocks[0], spec.chz_spec, jst, chmajor=True,
                          fold="bank")
    want, _ = jchz.analyze(blocks[1], spec.chz_spec, jst, chmajor=True,
                           fold="bank")
    tst = convert.analyzer_state_from_numpy(np.asarray(jst.history),
                                            jst.hop_idx, device="cpu")
    before = KA.LAUNCHES
    got, tst2 = tchz.analyze(torch.as_tensor(blocks[1]), PORT.spec.chz_spec,
                             tst, chmajor=True)
    assert KA.LAUNCHES == before
    assert tst2.hop_idx == 2 * 50004
    want = np.asarray(want)
    assert got.shape == want.shape == (M, 50004, 2)
    assert np.abs(got.numpy() - want).max() < 2e-4
