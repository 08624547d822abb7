"""The port's reverse-voice-channel monitor (``rx.voice``) and audio
sources (``runtime.sources``) against the JAX package's on the CPU, with
the checks of tests/test_voice.py and tests/test_sources.py on the port.

Tolerances.  The deemphasis runs as a float64 host recursion against the
JAX package's float32 scan: the scan's rounding error of ~6e-8 a step is
damped by the pole 0.565 (sum 1/(1-0.565) = 2.3 steps), so 1e-6 on
unit-scale audio.  Tone projections are f32 sums of 600 to 7200 terms:
1e-5 absolute on levels up to ~1."""

import wave

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.config import PipelineConfig as JPipe
from amps_tpu.config import SystemConfig as JSystem
from amps_tpu.runtime import sources as jsrc
from amps_tpu.rx import voice as jv
from amps_tpu.tx.voice import voice_channel_baseband as jvoice
from amps_tpu_torch.config import PipelineConfig, SystemConfig
from amps_tpu_torch.control.station import BaseStation
from amps_tpu_torch.dsp.fm import quadrature_demod
from amps_tpu_torch.runtime import sources as tsrc
from amps_tpu_torch.rx import voice as tv

torch.set_num_threads(1)

PIPE = PipelineConfig()
SENS = 2 * np.pi * PIPE.deviation_hz / PIPE.chan_rate


def _tone(freq, seconds, amp=0.3, fs=16000):
    t = np.arange(int(seconds * fs)) / fs
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _voice_iq(scc=1, seconds=0.25, freq=1000):
    iq, _ = jvoice(_tone(freq, seconds), JSystem(scc=scc), JPipe())
    return np.asarray(iq)


def test_constants_and_basis_equal_jax():
    assert tv.SUPERVISION_TONES_HZ == jv.SUPERVISION_TONES_HZ
    assert tv.GUARD_TONES_HZ == jv.GUARD_TONES_HZ
    assert (tv.ST_INDEX, tv.GUARD_INDEX) == (jv.ST_INDEX, jv.GUARD_INDEX)
    for n in (600, 7200):
        assert np.array_equal(tv._supervision_basis(n, 60000.0),
                              jv._supervision_basis(n, 60000.0))


@pytest.mark.parametrize("state", [0.0, 0.37])
def test_deemphasis_matches_jax_scan(state):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 0.5, 5000).astype(np.float32)
    want, wlast = jv.deemphasis(jnp.asarray(x), 16000.0, state=state)
    got, glast = tv.deemphasis(torch.as_tensor(x), 16000.0, state=state)
    assert got.dtype == torch.float32 and got.shape == (5000,)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6
    assert abs(glast - float(wlast)) <= 1e-6
    # two chained blocks equal one
    a, s = tv.deemphasis(x[:2000], 16000.0, state=state)
    b, s2 = tv.deemphasis(x[2000:], 16000.0, state=s)
    assert (torch.cat([a, b]) - got).abs().max() <= 1e-7 and s2 == glast


def test_sat_levels_and_detect_scc_match_jax():
    for scc in (0, 1, 2):
        iq = _voice_iq(scc)
        d = quadrature_demod(torch.as_tensor(iq))[0] / SENS
        rows = torch.stack([d, 0.5 * d])
        want = jv.sat_levels(jnp.asarray(rows.numpy()), PIPE.chan_rate)
        got = tv.sat_levels(rows, PIPE.chan_rate)
        for k in (0, 1, 2):
            assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= 1e-5
        idx, arr = tv.detect_scc(rows, PIPE.chan_rate)
        widx, warr = jv.detect_scc(jnp.asarray(rows.numpy()), PIPE.chan_rate)
        assert idx.tolist() == np.asarray(widx).tolist() == [scc, scc]
        assert np.abs(arr.numpy() - np.asarray(warr)).max() <= 1e-5
        # tests/test_voice.py: SAT near its 0.05, the others near zero
        lv = arr[0].numpy()
        assert abs(lv[scc] - 0.05) < 0.01
        assert all(lv[k] < 0.02 for k in range(3) if k != scc)


def test_nbfm_demod_audio_matches_jax():
    iq = _voice_iq(1)
    want, wsat = jv.nbfm_demod_audio(jnp.asarray(iq))
    got, gsat = tv.nbfm_demod_audio(torch.as_tensor(iq))
    assert got.shape == want.shape == (len(iq) * 4 // 15,)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5
    for k in (0, 1, 2):
        assert abs(float(gsat[k]) - float(wsat[k])) <= 1e-5
    # tests/test_voice.py: nearly all the audio's energy at 1 kHz
    oa = got.numpy()
    n = len(oa)
    seg = oa[n // 3: 2 * n // 3] - np.mean(oa[n // 3: 2 * n // 3])
    t = np.arange(len(seg)) / 16000.0
    c, s = np.cos(2 * np.pi * 1000 * t), np.sin(2 * np.pi * 1000 * t)
    assert np.hypot(seg @ c, seg @ s) / (np.linalg.norm(seg)
                                         * np.linalg.norm(c)) > 0.95


@pytest.mark.parametrize("n,batch", [(600 * 30 + 123, ()), (600 * 12, (3,)),
                                     (600 * 7 + 5, (2,))])
def test_supervision_levels_match_jax(n, batch):
    """Whole SAT groups with a ragged tail, exactly one group, and fewer
    frames than a group (the fine-grid SAT then stays)."""
    rng = np.random.default_rng(n)
    t = np.arange(n) / 60000.0
    x = (0.05 * np.cos(2 * np.pi * 6000.0 * t)
         + 0.3 * np.cos(2 * np.pi * 10000.0 * t) * (t > n / 120000.0)
         + rng.normal(0, 0.1, batch + (n,))).astype(np.float32)
    wl, wp = jv.supervision_levels(jnp.asarray(x), 600, 60000.0)
    gl, gp = tv.supervision_levels(torch.as_tensor(x), 600, 60000.0)
    assert gl.shape == wl.shape == batch + (n // 600, 5)
    assert gp.shape == wp.shape == batch + (n // 600,)
    assert np.abs(gl.numpy() - np.asarray(wl)).max() <= 1e-5
    assert np.abs(gp.numpy() - np.asarray(wp)).max() <= 1e-5
    if n >= 7200:
        assert abs(float(gl[..., 0, 1].mean()) - 0.05) < 0.01
    assert abs(float(gl[..., -1, tv.ST_INDEX].mean()) - 0.3) < 0.02


def _write_wav(path, data, width, nch=1, rate=16000):
    with wave.open(path, "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


@pytest.mark.parametrize("width,nch", [(2, 1), (1, 1), (2, 2)])
def test_wav_audio_source_matches_jax(tmp_path, width, nch):
    path = str(tmp_path / "t.wav")
    tone = 0.5 * np.sin(2 * np.pi * 440 * np.arange(800 * nch) / 16000)
    data = ((tone * 32767).astype(np.int16) if width == 2
            else (tone * 127 + 128).astype(np.uint8))
    _write_wav(path, data, width, nch)
    a, b = tsrc.WavAudioSource(path), jsrc.WavAudioSource(path)
    for n in (2000, 37, 801):               # loops past the 800 samples
        got, want = a(n), b(n)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    first = tsrc.WavAudioSource(path)(1600)
    assert np.allclose(first[:800], first[800:], atol=2e-4)
    assert np.abs(first).max() > 0.4
    with pytest.raises(ValueError, match="Hz"):
        tsrc.WavAudioSource(path, rate=8000)


def test_wav_audio_source_rejects_wide_samples(tmp_path):
    path = str(tmp_path / "w.wav")
    _write_wav(path, np.zeros(30, np.uint8), 3)
    with pytest.raises(ValueError, match="sample width"):
        tsrc.WavAudioSource(path)


def test_rvc_rebroadcast_matches_jax_and_keeps_the_tone():
    """tests/test_voice.py's RVC loop: a mobile's tone + SAT on the
    monitored slot comes out of the re-broadcast slot; the source's audio
    and its supervision reading match the JAX source's."""
    n_aud = 8192
    t = np.arange(n_aud) / PIPE.audio_rate
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    rvc_iq = np.asarray(jvoice(tone, JSystem(), JPipe(), sat=True)[0])

    def slot_reader():
        pos = {"i": 0}

        def rvc_slot(n_hops):
            blk = rvc_iq[pos["i"]: pos["i"] + n_hops]
            pos["i"] += n_hops
            return np.pad(blk, ((0, n_hops - len(blk)), (0, 0)))
        return rvc_slot

    jre = jsrc.RvcRebroadcastSource(slot_reader(), JSystem(), JPipe())
    tre = tsrc.RvcRebroadcastSource(slot_reader(), SystemConfig(), PIPE,
                                    device="cpu")
    for n in (8000, 100):
        want, got = jre(n), tre(n)
        assert got.shape == want.shape == (n,)
        assert np.abs(got - want).max() <= 2e-5
    jre(8000), tre(8000)
    assert np.abs(tre.last_levels - jre.last_levels).max() <= 1e-5
    assert np.abs(tre.last_power - jre.last_power).max() <= 1e-5
    # end to end through the voice slot
    station = BaseStation(SystemConfig(), PIPE)
    station.handle_command("fvc off")
    rebro = tsrc.RvcRebroadcastSource(slot_reader(), SystemConfig(), PIPE,
                                      device="cpu")
    slot = tsrc.VoiceFvcSlot(station, audio_source=rebro, device="cpu")
    out = slot(30000)
    assert rebro.last_levels[:, 1].mean() > 0.02      # SCC 1 SAT present
    audio = tv.nbfm_demod_audio(out)[0].numpy()[2000:]
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    freqs = np.fft.rfftfreq(len(audio), 1.0 / PIPE.audio_rate)
    peak = freqs[np.argmax(spec * (freqs > 100))]
    assert abs(peak - 440.0) < 15.0, peak


def test_rvc_source_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsrc.RvcRebroadcastSource(lambda n: np.zeros((n, 2), np.float32))
