"""The port's mobile RECC words and bursts, the FVC blank-and-burst
transmitter, and the voice channel's DSP (filter design, interpolation,
FM modulation and demodulation, preemphasis, the voice+SAT baseband and
the blank-and-burst slot source) against the JAX package's.

Bits, symbols and filter taps are exact.  Tolerances elsewhere:
  * quadrature_demod: 1e-6 (the same fast_atan2 on f32 products that a
    compiler may contract into FMAs);
  * polyphase_interpolate: 1e-5 absolute on unit-scale input (f32
    convolutions summed in other orders; cuDNN's TF32 is off);
  * fm_modulate: the phase is an f32 cumsum whose summation order
    differs between backends, so its error grows with the running phase:
    held to 1e-5 of the final |phase|, the IQ to 2e-3 over 20000 samples;
  * preemphasis runs as a float64 IIR on the host where the JAX package
    scans in float32: 1e-4 relative to the output's peak;
  * voice_channel_baseband and VoiceFvcSlot inherit the above: 2e-3 on
    unit-modulus IQ."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.control import station as jstation
from amps_tpu.dsp import fir as jfir
from amps_tpu.dsp import fm as jfm
from amps_tpu.dsp import windows as jwin
from amps_tpu.runtime import sources as jsrc
from amps_tpu.tx import fvc as jfvc
from amps_tpu.tx import recc_ms as jrecc
from amps_tpu.tx import voice as jvoice
from amps_tpu_torch.control import station as tstation
from amps_tpu_torch.dsp import fir as tfir
from amps_tpu_torch.dsp import fm as tfm
from amps_tpu_torch.dsp import windows as twin
from amps_tpu_torch.eval import traffic as ttraffic
from amps_tpu_torch.runtime import sources as tsrc
from amps_tpu_torch.tx import fvc as tfvc
from amps_tpu_torch.tx import recc_ms as trecc
from amps_tpu_torch.tx import voice as tvoice

torch.set_num_threads(1)

IQ_ATOL = 2e-3


# -- RECC words and bursts ---------------------------------------------------

def _word_lists(m):
    return [m.page_response_words("5551234567"),
            m.page_response_words("0005550000", scm=5),
            m.registration_words("2135551212", esn=0xDEADBEEF),
            m.registration_words("2135551212"),
            m.origination_words("4155550123", "2125557890"),
            m.origination_words("4155550123", "16505551234", esn=7),
            [m.ms_word_a(2, True, False, True, False, 9, 0x123456),
             m.ms_word_b(1, 3, 2, 0xD, True, False, 9, 1, 2, 3, 0x2D3),
             m.ms_word_c_serial(0, 0xCAFE), m.ms_word_called(0, "911")]]


def test_recc_words_and_bursts_match_jax():
    for want, got in zip(_word_lists(jrecc), _word_lists(trecc)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        for dcc in range(4):
            assert np.array_equal(trecc.burst_bits(got, dcc),
                                  np.asarray(jrecc.burst_bits(want, dcc)))
            for sps in (1, 3, 5):
                b = trecc.burst_symbols(got, dcc, sps)
                assert np.array_equal(b, np.asarray(
                    jrecc.burst_symbols(want, dcc, sps)))
                assert b.dtype == np.int8
    assert ttraffic.burst_symbols is trecc.burst_symbols
    with pytest.raises(ValueError):
        trecc.burst_bits([np.zeros(36, np.uint8)] * 8)


# -- FVC ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,sps", [((1, 28), 1), ((2, 28), 3),
                                       ((3, 2, 28), 5)])
def test_fvc_burst_symbols_match_jax(shape, sps):
    words = np.random.default_rng(sps).integers(0, 2, shape).astype(np.uint8)
    want = np.asarray(jfvc.fvc_burst_symbols(words, sps))
    got = tfvc.fvc_burst_symbols(torch.as_tensor(words), sps)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)


def test_fvc_stream_blocks_and_timer_match_jax():
    """Repeats, the timer's "fvc off" at a burst boundary, replacement,
    clearing and the idle zero fill, over blocks of odd sizes."""
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2, (2, 28)).astype(np.uint8)
    cmds = ([], [])
    streams = [m.FvcStream(sps=3, on_command=c.append)
               for m, c in ((jfvc, cmds[0]), (tfvc, cmds[1]))]
    script = [("set", (words[:1], 2)), 5000, 7001, 6192, 10000, 3,
              ("set", (words, 0)), 20000, 13000, ("clear", None), 999,
              ("set", (words[1:], 1)), 6192 * 2 + 17, 500]
    for step in script:
        outs = []
        for s in streams:
            if isinstance(step, int):
                outs.append(s.next_block(step))
            elif step[0] == "set":
                s.set_words(*step[1])
            else:
                s.clear()
        if outs:
            assert outs[1].dtype == np.int8
            assert np.array_equal(outs[1], outs[0]), step
        assert cmds[1] == cmds[0]
    assert cmds[0] == ["fvc off", "fvc off"]


# -- filter design, interpolation, FM -------------------------------------------

@pytest.mark.parametrize("args", [
    (1.0, 240_000, 7200.0, 720.0, "hamming"),
    (15.0, 240_000, 7200.0, 720.0, "hamming"),
    (1.0, 60_000, 12_000.0, 3_000.0, "blackman"),
    (2.0, 48_000, 5_000.0, 2_000.0, "hann", 31),
])
def test_firdes_low_pass_matches_jax(args):
    want = jwin.firdes_low_pass(*args)
    got = twin.firdes_low_pass(*args)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("fs,transition", [(240_000, 720.0), (60_000, 3_000.0),
                                           (48_000, 2_000.0), (16_000, 700.0),
                                           (400_000, 25_000.0)])
@pytest.mark.parametrize("window", ["hamming", "hann", "blackman",
                                    "blackman_harris", "rectangular"])
def test_compute_ntaps_matches_jax(fs, transition, window):
    """GR's tap count for every window: the same odd integer."""
    got = twin.compute_ntaps(fs, transition, window)
    assert got == jwin.compute_ntaps(fs, transition, window) and got % 2


@pytest.mark.parametrize("shape,up,down,fs_in", [
    ((1600,), 15, 4, 16_000.0),      # the voice path: audio -> channel rate
    ((2, 900), 15, 4, 16_000.0),
    ((1000,), 3, 2, 40_000.0),
    ((1200,), 2, 5, 60_000.0)])
def test_rational_resample_matches_jax(shape, up, down, fs_in):
    """Polyphase interpolation by ``up`` then every ``down``-th sample:
    the same length, within polyphase_interpolate's 1e-5 on unit-scale
    input."""
    x = np.random.default_rng(up * down).normal(0, 1, shape).astype(
        np.float32)
    want = np.asarray(jvoice.rational_resample(jnp.asarray(x), up, down,
                                               fs_in))
    got = tvoice.rational_resample(torch.as_tensor(x), up, down, fs_in)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert want.shape[-1] == -(-shape[-1] * up // down)
    assert np.abs(got.numpy() - want).max() < 1e-5


@pytest.mark.parametrize("interp", [4, 15])
def test_polyphase_interpolate_matches_jax(interp):
    """Two chained blocks with the carried history."""
    rng = np.random.default_rng(interp)
    taps = jwin.firdes_low_pass(interp, 16_000 * interp, 7200, 720)
    x = rng.normal(0, 1, (2, 700)).astype(np.float32)
    jh = th = None
    for blk in (x[:, :333], x[:, 333:]):
        want, jh = jfir.polyphase_interpolate(jnp.asarray(blk), taps,
                                              interp, jh)
        got, th = tfir.polyphase_interpolate(torch.as_tensor(blk), taps,
                                             interp, th)
        assert got.shape == want.shape == (2, blk.shape[1] * interp)
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
        assert np.array_equal(th.numpy(), np.asarray(jh))


def test_fm_modulate_matches_jax():
    x = np.random.default_rng(4).normal(0.2, 1, (2, 20000)).astype(np.float32)
    want, wph = jfm.fm_modulate(jnp.asarray(x), 0.8, 1.25)
    got, gph = tfm.fm_modulate(torch.as_tensor(x), 0.8, 1.25)
    wph = np.asarray(wph)
    assert got.shape == want.shape == (2, 20000, 2)
    assert np.abs(gph.numpy() - wph).max() <= 1e-5 * np.abs(wph).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() < IQ_ATOL


@pytest.mark.parametrize("with_prev", [False, True])
def test_quadrature_demod_matches_jax(with_prev):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (3, 5000, 2)).astype(np.float32)
    prev = rng.normal(0, 1, (3, 2)).astype(np.float32) if with_prev else None
    want, wl = jfm.quadrature_demod(jnp.asarray(x), 0.7,
                                    None if prev is None
                                    else jnp.asarray(prev))
    got, gl = tfm.quadrature_demod(torch.as_tensor(x), 0.7, prev)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6
    assert np.array_equal(gl.numpy(), np.asarray(wl))
    if not with_prev:
        assert (got[:, 0] == 0).all()


# -- voice ----------------------------------------------------------------------

def test_preemphasis_matches_jax():
    audio = np.random.default_rng(6).normal(0, 0.3, 13_000).astype(
        np.float32)
    want, wst = jvoice.preemphasis(jnp.asarray(audio), 16_000, state=0.2)
    got, gst = tvoice.preemphasis(audio, 16_000, state=0.2)
    peak = np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4 * peak
    assert abs(gst - float(wst)) <= 1e-4 * peak


@pytest.mark.parametrize("sat", [False, True])
def test_voice_channel_baseband_matches_jax(sat):
    audio = (0.3 * np.sin(2 * np.pi * 1000 * np.arange(4000) / 16_000)
             + np.random.default_rng(7).normal(0, 0.05, 4000)).astype(
                 np.float32)
    want, wph = jvoice.voice_channel_baseband(audio, sat=sat, phase0=0.5,
                                              t0=0.125)
    got, gph = tvoice.voice_channel_baseband(audio, sat=sat, phase0=0.5,
                                             t0=0.125, device="cpu")
    assert got.shape == want.shape == (15_000, 2)
    assert np.abs(got.numpy() - np.asarray(want)).max() < IQ_ATOL
    assert abs(float(gph) - float(wph)) < IQ_ATOL


def test_voice_fvc_slot_matches_jax():
    """The blank-and-burst source: voice + SAT, then FVC data after the
    alert, then voice again, with an audio source; block by block."""
    audio = np.random.default_rng(8).normal(0, 0.2, 40_000).astype(
        np.float32)

    def source():
        pos = [0]

        def take(n):
            out = audio[pos[0]: pos[0] + n]
            pos[0] += n
            return out
        return take

    sts = [m.BaseStation(sps=3) for m in (jstation, tstation)]
    slots = [jsrc.VoiceFvcSlot(sts[0], audio_source=source()),
             tsrc.VoiceFvcSlot(sts[1], audio_source=source(), device="cpu")]
    script = [9000, "fvc alert", "fvc on", 12001, 6192 * 3, "fvc off", 9000]
    for step in script:
        if isinstance(step, str):
            for st in sts:
                st.handle_command(step)
            continue
        want, got = (s(step) for s in slots)
        assert got.shape == want.shape == (step, 2)
        assert np.abs(got - np.asarray(want)).max() < IQ_ATOL, step
    assert slots[1]._fvc_accum == slots[0]._fvc_accum


def test_voice_slot_defaults_to_the_card(monkeypatch):
    """The slot and the voice baseband modulate on the current CUDA
    device unless the CPU is named; without CUDA the default raises."""
    st = tstation.BaseStation(sps=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsrc.VoiceFvcSlot(st)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvoice.voice_channel_baseband(np.zeros(400, np.float32))
    slot = tsrc.VoiceFvcSlot(st, device="cpu")
    assert slot.device == torch.device("cpu")
    out = slot(1500)
    assert isinstance(out, np.ndarray) and out.shape == (1500, 2)
