"""The port's control plane against the JAX package's: RECC word fields,
the forward BCH decode, SAT/ST supervision and the base station's call
control.  All of it is host code: every comparison is exact, apart from
``StationEvent.t`` (``time.monotonic`` at emission), which is left out."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.codec import bch as jbch
from amps_tpu.control import fields as jfields
from amps_tpu.control import station as jstation
from amps_tpu.control import supervision as jsup
from amps_tpu.tx import recc_ms as jrecc
from amps_tpu_torch.codec import bch as tbch
from amps_tpu_torch.control import fields as tfields
from amps_tpu_torch.control import station as tstation
from amps_tpu_torch.control import supervision as tsup
from amps_tpu_torch.tx import recc_ms as trecc


def norm(v):
    """A payload as plain Python: arrays and tensors as lists, dataclasses
    as (class name, fields) without a ``StationEvent.t``."""
    if isinstance(v, torch.Tensor):
        return v.tolist()
    if isinstance(v, (np.ndarray, np.generic)) or hasattr(v, "__array__"):
        return np.asarray(v).tolist()
    if dataclasses.is_dataclass(v):
        return (type(v).__name__,
                tuple(norm(getattr(v, f.name)) for f in dataclasses.fields(v)
                      if not (type(v).__name__ == "StationEvent"
                              and f.name == "t")))
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    return v


def events(st):
    return [(e.kind, norm(e.payload)) for e in st.events]


# -- fields ------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_fields_parse_and_encode_match_jax(seed):
    rng = np.random.default_rng(seed)
    for bits in rng.integers(0, 2, (64, 36)).astype(np.uint8):
        for cls in ("RxWordA", "RxWordB", "RxWordC", "RxWordCalled"):
            assert norm(getattr(tfields, cls).parse(bits)) == \
                norm(getattr(jfields, cls).parse(bits))
        assert tfields.RxWordCalled.parse(bits).digits() == \
            jfields.RxWordCalled.parse(bits).digits()
        b28 = bits[:28]
        assert norm(tfields.FvcVoiceChannel.parse(b28)) == \
            norm(jfields.FvcVoiceChannel.parse(b28))
    for _ in range(50):
        s = "".join(str(d) for d in rng.integers(0, 10, 10))
        assert tfields.parse_min(s) == jfields.parse_min(s)
        assert tfields.calc_min(*tfields.parse_min(s)) == \
            jfields.calc_min(*jfields.parse_min(s))
        dialed = "".join(str(d) for d in rng.integers(0, 10,
                                                     rng.integers(1, 9)))
        assert tfields.encode_called_digits(dialed) == \
            jfields.encode_called_digits(dialed)
    for bad in ("", "12345", "55512345678", "55512a4567"):
        assert tfields.parse_min(bad) == jfields.parse_min(bad)


# -- forward BCH decode -------------------------------------------------------

def test_focc_bch_decode_every_syndrome():
    """Every 12-bit syndrome of the (40, 28) code: the direct LUT index
    equals the JAX package's lookup and the corrected words agree."""
    idx = np.arange(4096, dtype=np.int32)
    want_g = np.asarray(jbch.packed_lut_lookup(
        jnp.asarray(idx), jbch._decode_table_packed(40)))
    got_g = tbch.lut_lookup(torch.as_tensor(idx), 40)
    assert np.array_equal(got_g.numpy(), want_g)
    words = np.random.default_rng(9).integers(0, 2, (4096, 40)).astype(
        np.uint8)
    want = np.asarray(jbch.apply_error_pattern(jnp.asarray(words),
                                               jnp.asarray(want_g), 28))
    got = tbch.apply_error_pattern(torch.as_tensor(words), got_g, 28)
    assert np.array_equal(got.numpy(), want)


def test_focc_bch_decode_matches_jax():
    rng = np.random.default_rng(10)
    info = rng.integers(0, 2, (600, 28)).astype(np.uint8)
    rx = tbch.focc_bch_encode(torch.as_tensor(info)).numpy()
    for i in range(len(rx)):    # 0..4 errors: decodable and not
        rx[i, rng.choice(40, i % 5, replace=False)] ^= 1
    want_w, want_ok = (np.asarray(a) for a in jbch.focc_bch_decode(rx))
    got_w, got_ok = tbch.focc_bch_decode(torch.as_tensor(rx))
    assert np.array_equal(got_w.numpy(), want_w)
    assert np.array_equal(got_ok.numpy(), want_ok)
    assert np.array_equal(got_w.numpy()[::5], info[::5])
    assert got_ok.numpy()[(np.arange(600) % 5) <= 2].all()


# -- supervision --------------------------------------------------------------

def _frames(rng, n, guard):
    """Random supervision frames around the gates' thresholds."""
    levels = rng.uniform(0, 0.08, (n, 5 if guard else 4)).astype(np.float32)
    if guard:
        levels[:, 4] = rng.uniform(0, 0.06, n)
    power = rng.choice([0.0, 1e-7, 1e-3, 0.5, 1.5, 3.0], n).astype(
        np.float32)
    return levels, power


@pytest.mark.parametrize("guard", [False, True])
def test_classify_frames_matches_jax(guard):
    rng = np.random.default_rng(guard)
    levels, power = _frames(rng, 4000, guard)
    for scc in range(3):
        want = jsup.classify_frames(levels, power, scc,
                                    jsup.SupervisionConfig())
        got = tsup.classify_frames(levels, power, scc,
                                   tsup.SupervisionConfig())
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


def _call_frames(n, scc, st, power=1e-3, sat=0.05):
    levels = np.zeros((n, 4), np.float32)
    levels[:, scc] = sat
    if st:
        levels[:, 3] = 0.05
    return levels, np.full(n, power, np.float32)


def _supervisor_script(rng, scc):
    """Alert (None), ring, answer, flash, fades, noise and release
    frames."""
    script = [None, _call_frames(40, scc, True),
              _call_frames(30, scc, False), _call_frames(40, scc, False),
              _call_frames(50, scc, True), _call_frames(20, scc, False),
              _frames(rng, 300, False), _call_frames(60, scc, False),
              _call_frames(100, scc, False, power=0.0),
              _call_frames(200, scc, True), _call_frames(700, scc, False,
                                                         sat=0.0)]
    return script


@pytest.mark.parametrize("seed", range(3))
def test_channel_supervisor_matches_jax(seed):
    """The same frames give the same event sequence (kind, channel,
    reason, t) and states."""
    scc = seed % 3
    sups = [m.ChannelSupervisor(355, scc) for m in (jsup, tsup)]
    for step in _supervisor_script(np.random.default_rng(seed), scc):
        for s in sups:
            if step is None:
                s.begin_alert()
            else:
                s.push_frames(*step)
        assert sups[0].state == sups[1].state
    assert [norm(e) for e in sups[1].events] == \
        [norm(e) for e in sups[0].events]
    assert len(sups[0].events) >= 2


# -- base station ---------------------------------------------------------------

def _burst(words36):
    words = np.zeros((7, 36), np.uint8)
    ok = np.zeros(7, bool)
    for i, w in enumerate(words36):
        words[i], ok[i] = w, True
    return words, ok


def _bursts(rm):
    return {
        "page_response": _burst(rm.page_response_words("5551234567")),
        "registration": _burst(rm.registration_words("2135551212",
                                                     esn=0xDEADBEEF)),
        "origination": _burst(rm.origination_words("4155550123",
                                                   "2125557890")),
        "origination_zero": _burst(rm.origination_words("4155550123",
                                                        "0123")),
    }


SCRIPT = [
    ("command", "page 5551234567"),
    ("burst", "page_response"),
    ("superframe", None),
    ("fvc", 3000),
    ("supervision", (355, True)),
    ("supervision", (355, False)),
    ("command", "handoff 355 356"),
    ("fvc", 20000),
    ("burst", "registration"),
    ("superframe", None),
    ("burst", "origination"),
    ("burst", "origination_zero"),
    ("superframe", None),
    ("noise", None),
    ("command", "fvc on"),
    ("command", "fvc alert"),
    ("fvc", 7000),
    ("command", "fvc off"),
    ("command", "release 356"),
    ("command", "release 999"),
    ("command", "handoff x"),
    ("command", "bogus"),
    ("superframe", None),
    ("fvc", 70000),
]


@pytest.mark.parametrize("per_channel_fvc", [False, True])
def test_base_station_matches_jax(per_channel_fvc):
    """The same bursts, commands and supervision frames give the same
    event kinds and payloads, FOCC word pairs, FVC samples, mutes and
    supervisors."""
    sts = [m.BaseStation(sps=3, per_channel_fvc=per_channel_fvc)
           for m in (jstation, tstation)]
    bursts = [_bursts(jrecc), _bursts(trecc)]
    for k in bursts[0]:
        assert np.array_equal(bursts[0][k][0], bursts[1][k][0]), k
    rng = np.random.default_rng(5)
    noise = rng.integers(0, 2, (7, 36)).astype(np.uint8)
    for kind, arg in SCRIPT:
        outs = []
        for st, b in zip(sts, bursts):
            if kind == "command":
                st.handle_command(arg)
            elif kind == "burst":
                st.handle_burst(*b[arg])
            elif kind == "noise":
                st.handle_burst(noise, np.ones(7, bool),
                                bad_symbols=np.full(8, 120))
            elif kind == "superframe":
                outs.append(np.asarray(st.focc.next_word_pairs()))
            elif kind == "fvc":
                chans = sorted(st.fvc_streams) if per_channel_fvc else [None]
                outs.append([st.fvc_for(c).next_block(arg) for c in chans])
            elif kind == "supervision":
                chan, ringing = arg
                st.push_supervision(chan, *_call_frames(
                    30, st.system.scc, ringing))
        if outs:
            assert norm(outs[0]) == norm(outs[1]), kind
        assert events(sts[1]) == events(sts[0]), (kind, arg)
        assert (sts[1].fvc_mute, sts[1].audio_mute) == \
            (sts[0].fvc_mute, sts[0].audio_mute)
        assert sts[1].fvc_mutes == sts[0].fvc_mutes
        assert {c: s.state for c, s in sts[1].supervisors.items()} == \
            {c: s.state for c, s in sts[0].supervisors.items()}
    kinds = {e[0] for e in events(sts[0])}
    assert {"focc_words", "fvc_words", "handoff", "release",
            "command"} <= kinds
