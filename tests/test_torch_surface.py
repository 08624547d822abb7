"""The rest of ``amps_tpu``'s public surface in the port, against the JAX
functions on the CPU at small sizes: the Manchester decoder and slicer,
the batched RECC word parsers, the packed syndrome lookups, the
correlator's trigger gate, burst rssi and batched capture, the
single-burst decoder, the root-raised-cosine design, the riq helpers,
``sat_levels(block=)`` and ``native_rt.available``.  Integers and
booleans match exactly; floats within the stated tolerances."""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.codec import bch as jbch
from amps_tpu.codec import manchester as jman
from amps_tpu.codec import words as jwords
from amps_tpu.dsp import iq as jiq
from amps_tpu.dsp import windows as jwin
from amps_tpu.ref import frames_ref
from amps_tpu.rx import correlator as jcorr
from amps_tpu.rx import decoder as jdec
from amps_tpu.rx import voice as jvoice
from amps_tpu_torch.codec import bch as tbch
from amps_tpu_torch.codec import manchester as tman
from amps_tpu_torch.codec import words as twords
from amps_tpu_torch.control import fields
from amps_tpu_torch.dsp import iq as tiq
from amps_tpu_torch.dsp import windows as twin
from amps_tpu_torch.rx import correlator as tcorr
from amps_tpu_torch.rx import decoder as tdec
from amps_tpu_torch.rx import voice as tvoice
from amps_tpu_torch.runtime import native_rt

torch.set_num_threads(1)

SPS = 3
PRE = 2 * (30 + 11)   # symbols of a burst before its capture


def _eq(got, want):
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n", [96, 97])
def test_manchester_decode_bits_and_slicer(n):
    """Sliced symbols (even and odd length, batched) decode to the same
    bits and bad counts; the slicer maps >= 0 to 1, as the JAX one."""
    rng = np.random.default_rng(n)
    s01 = rng.integers(0, 2, (3, 4, n)).astype(np.uint8)
    jb, jbad = jman.manchester_decode_bits(s01)
    tb, tbad = tman.manchester_decode_bits(torch.as_tensor(s01))
    assert tb.dtype == torch.uint8 and tbad.dtype == torch.int32
    _eq(tb, jb)
    _eq(tbad, jbad)
    soft = rng.normal(0, 1, (5, n)).astype(np.float32)
    soft[0, :4] = 0.0
    _eq(tman.slice_symbols(torch.as_tensor(soft)),
        jman.slice_symbols(soft))


_PARSERS = [("parse_recc_word_a", fields.RxWordA),
            ("parse_recc_word_b", fields.RxWordB),
            ("parse_recc_word_c_serial", fields.RxWordC),
            ("parse_recc_word_called", fields.RxWordCalled)]


@pytest.mark.parametrize("name,cls", _PARSERS, ids=[p[0] for p in _PARSERS])
def test_recc_word_parsers(name, cls):
    """Batched (5, 4, 36) words: every field equals the JAX parser's, and
    row by row the host parser's (control/fields.py)."""
    bits = np.random.default_rng(len(name)).integers(
        0, 2, (5, 4, 36)).astype(np.uint8)
    bits[0, 0] = 1                          # every field at its maximum
    want = getattr(jwords, name)(jnp.asarray(bits))
    got = getattr(twords, name)(torch.as_tensor(bits))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == (5, 4)
        _eq(got[key].numpy().astype(np.int64),
            np.asarray(want[key]).astype(np.int64))
    for idx in np.ndindex(5, 4):
        row = cls.parse(bits[idx])
        for key in got:
            assert int(got[key][idx]) == int(getattr(row, key)), (idx, key)


def test_recc_syndrome_packed_and_lut_lookup():
    """Codewords with 0-3 bit errors give the JAX packed LUT values; the
    direct index equals the JAX one-hot lookup on all 4096 indices."""
    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, (64, 36)).astype(np.uint8)
    rx = np.asarray(jbch.recc_bch_encode(info)).copy()
    for r in range(64):
        rx[r, rng.choice(48, r % 4, replace=False)] ^= 1
    _eq(tbch.recc_syndrome_packed(torch.as_tensor(rx)),
        jbch.recc_syndrome_packed(rx))
    table = jbch.recc_decode_table_packed()
    idx = np.arange(4096, dtype=np.int32).reshape(64, 64)
    _eq(tbch.packed_lut_lookup(torch.as_tensor(idx), table),
        jbch.packed_lut_lookup(jnp.asarray(idx), table))


def _phases_with_bursts(seed):
    """(2, SPS, nsym) phase streams: noise, with a whole RECC burst at
    symbol 300 of channel 0 and one at symbol 40 of channel 1 (its
    trigger cut by the stream head)."""
    rng = np.random.default_rng(seed)
    nsym = 4200
    demod = rng.normal(0, 0.3, (2, nsym * SPS)).astype(np.float32)
    for c, at in ((0, 300), (1, 40)):
        words = [rng.integers(0, 2, 36).astype(np.uint8)]
        sym = frames_ref.recc_burst_symbols(1, words, SPS).astype(np.float32)
        skip = max(0, PRE - at) * SPS
        sym = sym[skip:]
        a = (at - PRE) * SPS + skip
        demod[c, a:a + len(sym)] += 0.8 * sym - 0.1
    return np.array(jcorr.symbol_phase_streams(jnp.asarray(demod), SPS))


def _starts():
    """Starts (SAMPLE units) on the bursts' captures and elsewhere: before
    the trigger fits, misaligned, and near the stream end."""
    return np.array([[300 * SPS, 300 * SPS + 1, 10, 4000 * SPS + 2],
                     [40 * SPS, 2, 1000 * SPS, 4150 * SPS]], np.int32)


def test_trigger_errors_and_gate():
    ph = _phases_with_bursts(1)
    st = _starts()
    want = np.asarray(jcorr.trigger_errors(jnp.asarray(ph), jnp.asarray(st),
                                           SPS))
    got = tcorr.trigger_errors(torch.as_tensor(ph), torch.as_tensor(st), SPS)
    assert got.dtype == torch.int32
    _eq(got, want)
    assert want[0, 0] == 0 and want[1, 0] == 0 and want[1, 2] > 6
    valid = np.ones(st.shape, bool)
    valid[0, 3] = False
    for max_err in (jcorr.MAX_TRIGGER_ERRORS, 0, -1):
        _eq(tcorr.apply_trigger_gate(torch.as_tensor(valid),
                                     torch.as_tensor(ph),
                                     torch.as_tensor(st), SPS, max_err),
            jcorr.apply_trigger_gate(jnp.asarray(valid), jnp.asarray(ph),
                                     jnp.asarray(st), SPS, max_err))
    assert tcorr.apply_trigger_gate(torch.as_tensor(valid), None, None, SPS,
                                    -1).all() == bool(valid.all())


def test_burst_rssi():
    rng = np.random.default_rng(2)
    pw = rng.exponential(1.0, (3, 20000)).astype(np.float32)
    st = np.array([[0, 384, 9000], [5, 19000, 12345], [777, 1, 16000]],
                  np.int32)
    want = np.asarray(jcorr.burst_rssi(jnp.asarray(pw), jnp.asarray(st),
                                       SPS))
    got = tcorr.burst_rssi(torch.as_tensor(pw), torch.as_tensor(st), SPS)
    assert np.allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_extract_bursts_batched():
    """The capture from a padded demod: hard symbols exact, soft within
    f32 roundoff of the JAX one-hot capture; past the end reads zero."""
    rng = np.random.default_rng(4)
    n = (jcorr.CAPTURE_SYMBOLS + 600) * SPS
    demod = rng.normal(0, 1, (2, n)).astype(np.float32)
    st = np.array([[0, 301, 1500], [7, 100 * SPS, n - 30]], np.int32)
    jh, js = jcorr.extract_bursts_batched(jnp.asarray(demod),
                                          jnp.asarray(st), SPS)
    th, ts = tcorr.extract_bursts_batched(torch.as_tensor(demod),
                                          torch.as_tensor(st), SPS)
    _eq(th, jh)
    assert np.abs(ts.numpy() - np.asarray(js)).max() <= 1e-6
    assert not ts[1, 2, 100:].any()


def test_decode_burst():
    """A single capture: the planted words with bit errors, and noise."""
    rng = np.random.default_rng(5)
    words = [rng.integers(0, 2, 36).astype(np.uint8) for _ in range(3)]
    sym = frames_ref.recc_burst_symbols(2, words, 1)[PRE:]
    cap = np.zeros(jcorr.CAPTURE_SYMBOLS, np.uint8)
    cap[:len(sym)] = sym > 0
    cap[[20, 21, 700, 1203]] ^= 1
    noise = rng.integers(0, 2, jcorr.CAPTURE_SYMBOLS).astype(np.uint8)
    for c in (cap, noise):
        for policy, gate in (("first_ok", None), ("majority", 6)):
            want = jdec.decode_burst(jnp.asarray(c), policy, gate)
            got = tdec.decode_burst(torch.as_tensor(c), policy, gate)
            for a, b in zip(got, want):
                _eq(a, b)
    got = tdec.decode_burst(torch.as_tensor(cap))
    assert got.word_ok[:3].all()
    _eq(got.words[:3], np.stack(words))


@pytest.mark.parametrize("fs,rate,alpha,ntaps",
                         [(48000.0, 4800.0, 0.35, 101),
                          (40000.0, 10000.0, 0.25, 64),
                          (60000.0, 10000.0, 0.5, 33)])
def test_firdes_root_raised_cosine(fs, rate, alpha, ntaps):
    """Designed in float64 like the JAX function (the second case hits the
    |4 alpha t| = 1 limit): equal to 1e-12."""
    want = jwin.firdes_root_raised_cosine(1.5, fs, rate, alpha, ntaps)
    got = twin.firdes_root_raised_cosine(1.5, fs, rate, alpha, ntaps)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got.astype(np.float64) - want).max() <= 1e-12


def test_riq_helpers():
    rng = np.random.default_rng(6)
    a = rng.normal(0, 1, (3, 50, 2)).astype(np.float32)
    b = rng.normal(0, 1, (3, 50, 2)).astype(np.float32)
    ph = rng.uniform(-4, 4, (3, 50)).astype(np.float32)
    s = rng.normal(0, 1, (3, 50)).astype(np.float32)
    z = a[..., 0] + 1j * a[..., 1]
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    pairs = [(tiq.from_complex(z), jiq.from_complex(z)),
             (tiq.from_complex(a[..., 0]), jiq.from_complex(a[..., 0])),
             (tiq.expj(torch.as_tensor(ph)), jiq.expj(ph)),
             (tiq.mul(ta, tb), jiq.mul(jnp.asarray(a), jnp.asarray(b))),
             (tiq.mul_conj(ta, tb), jiq.mul_conj(jnp.asarray(a),
                                                jnp.asarray(b))),
             (tiq.conj(ta), jiq.conj(jnp.asarray(a))),
             (tiq.angle(ta), jiq.angle(jnp.asarray(a))),
             (tiq.abs2(ta), jiq.abs2(jnp.asarray(a))),
             (tiq.scale(ta, torch.as_tensor(s)), jiq.scale(jnp.asarray(a),
                                                           s))]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-6
    for x in (ta, a):
        back = tiq.to_complex(x)
        assert np.array_equal(back, jiq.to_complex(a))


def test_sat_levels_takes_block():
    """``block`` is accepted, as by the JAX function, and changes
    nothing in either package."""
    fs = 48000.0
    t = np.arange(4800) / fs
    demod = (0.3 * np.cos(2 * np.pi * 6000.0 * t)
             + np.random.default_rng(7).normal(0, 0.05, t.size)
             ).astype(np.float32)
    want = jvoice.sat_levels(demod, fs, block=480)
    got = tvoice.sat_levels(torch.as_tensor(demod), fs, block=480)
    plain = tvoice.sat_levels(torch.as_tensor(demod), fs)
    for scc in (0, 1, 2):
        assert abs(float(got[scc]) - float(want[scc])) <= 1e-5
        assert float(got[scc]) == float(plain[scc])
    assert float(got[1]) > 10 * float(got[0])


def test_native_available(monkeypatch, tmp_path):
    """True where g++ builds the library; False when g++ is missing,
    while a caller that loads the library still gets the error."""
    assert native_rt.available()
    native_rt.load.cache_clear()
    monkeypatch.setattr(native_rt, "library_path",
                        lambda: tmp_path / "libampsrt_missing.so")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    try:
        assert native_rt.available() is False
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native_rt.load()
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native_rt.recc_bch_encode(np.zeros(36, np.uint8))
    finally:
        native_rt.load.cache_clear()


def test_canonical_tx_drive_through_manchester_decode():
    """The canonical TX drive of the verify notes, written against the
    port: a page through FoccStream, fm_modulate and rx_frontend,
    integrate and dump at 10 samples a Manchester symbol (200 ksps),
    slice_symbols and manchester_decode_bits; the paged word is frame 4's
    word A, and no pair is bad."""
    from amps_tpu_torch.config import PipelineConfig
    from amps_tpu_torch.control.fields import parse_min
    from amps_tpu_torch.rx.frontend import rx_frontend, rx_lpf_taps
    from amps_tpu_torch.tx.focc import _FRAME_SRC, STREAM_BOTH, FoccStream
    from amps_tpu_torch.tx.modulator import fm_modulate, tx_interp_taps

    pipe = PipelineConfig()
    bs = FoccStream(sps=pipe.sps)
    min1, min2 = parse_min("5551234567")
    page = [twords.focc_word1(True, 0, min1),
            twords.focc_word2_general(min2, 0, 0, 0)]
    bs.push_words(STREAM_BOTH, page)
    syms = bs.next_superframe_symbols()[:6 * 463 * 2 * pipe.sps]
    iq, _ = fm_modulate(syms.to(torch.int8), pipe)      # riq at 400 ksps
    demod, _ = rx_frontend(iq, pipe, center_freq=0.0)   # 200 ksps
    delay = ((len(tx_interp_taps()) - 1) // 2
             + (len(rx_lpf_taps()) - 1) // 2) // 2
    n = (demod.shape[0] - delay) // 20 * 20
    soft = demod[delay:delay + n].reshape(-1, 10).mean(-1)
    bits, bad = tman.manchester_decode_bits(tman.slice_symbols(soft))
    frame4 = bits[4 * 463:5 * 463].numpy()[_FRAME_SRC >= 0]
    assert np.array_equal(frame4[21:49], page[0].numpy())
    assert int(bad) == 0
