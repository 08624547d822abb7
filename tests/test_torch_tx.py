"""The port's FOCC transmit chain against the JAX package on the CPU:
word builders, the (40, 28) BCH encode, frame bits and the superframe
templates bit-exact; FoccStream's queue, repeat and busy semantics;
the two-template FSK map bit-exact against the port's own modulator;
and the wideband output of tx_multichannel_block and of two
MultichannelTransmitter blocks (with a baseband source slot) within
atol 2e-4 (f32 summation order of the synthesis bank, the tolerance of
the JAX kernel tests)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.codec import bch as jbch
from amps_tpu.codec import words as JW
from amps_tpu.dsp import fm as jfm
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu.parallel.pipeline import tx_multichannel_block as jtx_block
from amps_tpu.ref import words_ref
from amps_tpu.runtime.streamer import MultichannelTransmitter as JTx
from amps_tpu.tx import focc as jfocc
from amps_tpu_torch.codec import bch as tbch
from amps_tpu_torch.codec import words as TW
from amps_tpu_torch.codec.bits import expandbits
from amps_tpu_torch.codec.manchester import manchester_encode_symbols
from amps_tpu_torch.dsp import fm as tfm
from amps_tpu_torch.parallel.pipeline import MultichannelSpec as TSpec
from amps_tpu_torch.parallel.pipeline import tx_multichannel_block
from amps_tpu_torch.runtime.streamer import MultichannelTransmitter as TTx
from amps_tpu_torch.tx import focc as tfocc

torch.set_num_threads(1)

SENS = 2 * np.pi * 8000 / 60000     # FSK phase step at the channel rate

# builder name -> arguments (scalars, then a batch of each)
BUILDERS = {
    "focc_word1": (True, 2, 0xABCDE1),
    "focc_word2_general": (0x2F3, 3, 5, 17),
    "focc_word2_voice_channel": (1, 0x155, 6, 355),
    "fvc_word1_voice_channel": (2, 1, 5, 1023),
    "fvc_word1_general": (3, 1, 2, 19),
    "overhead_word_1": (1, 16, True, False, True, 3),
    "overhead_word_2": (2, 1, 0, 1, 1, 3, 23, 1, 0, 23, 1),
    "access_type_parameters_global_action": (3, True),
    "registration_increment_global_action": (1, 100, False),
    "registration_id": (0, 500, True),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_word_builders_bit_exact(name):
    args = BUILDERS[name]
    want = np.asarray(getattr(JW, name)(*args))
    got = getattr(TW, name)(*args)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    rng = np.random.default_rng(len(name))
    # batched: every integer argument a (5,) array within its range
    batch = [rng.integers(0, 2, 5).astype(bool) if isinstance(a, bool)
             else rng.integers(0, 2 * max(int(a), 1), 5) for a in args]
    want_b = np.asarray(getattr(JW, name)(*[jnp.asarray(b) for b in batch]))
    got_b = getattr(TW, name)(*[torch.as_tensor(b) for b in batch])
    assert np.array_equal(got_b.numpy(), want_b)


def test_control_filler_word():
    assert np.array_equal(TW.control_filler_word().numpy(),
                          np.asarray(JW.control_filler_word()))
    assert np.array_equal(TW.CONTROL_FILLER, JW.CONTROL_FILLER)


def test_expandbits_matches_jax():
    from amps_tpu.codec.bits import expandbits as jexp
    vals = np.array([0, 1, 6, 0xABCDE1, (1 << 24) - 1])
    assert np.array_equal(expandbits(torch.as_tensor(vals), 24).numpy(),
                          np.asarray(jexp(jnp.asarray(vals, jnp.uint32), 24)))
    assert expandbits(6, 3).tolist() == [1, 1, 0]


def test_focc_bch_encode_matches_jax():
    info = np.random.default_rng(2).integers(0, 2, (7, 3, 28)).astype(
        np.uint8)
    got = tbch.focc_bch_encode(torch.as_tensor(info))
    assert got.shape == (7, 3, 40)
    assert np.array_equal(got.numpy(), np.asarray(jbch.focc_bch_encode(info)))


@pytest.mark.parametrize("busy_idle", [0, 1])
def test_focc_frame_bits_match_jax(busy_idle):
    wp = np.random.default_rng(busy_idle).integers(
        0, 2, (3, 18, 2, 28)).astype(np.uint8)
    got = tfocc.focc_frame_bits(torch.as_tensor(wp), busy_idle)
    want = np.asarray(jfocc.focc_frame_bits(jnp.asarray(wp), busy_idle))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    syms = tfocc.focc_frames_symbols(wp, 2, busy_idle)
    assert np.array_equal(
        syms.numpy(), np.asarray(jfocc.focc_frames_symbols(wp, 2, busy_idle)))


def test_superframe_templates_match_jax():
    assert np.array_equal(tfocc.superframe_word_pairs(),
                          jfocc.superframe_word_pairs())
    assert np.array_equal(tfocc.registration_superframe_word_pairs(),
                          jfocc.registration_superframe_word_pairs())
    assert np.array_equal(tfocc._FRAME_SRC, jfocc._FRAME_SRC)


def _page_words():
    min1, min2 = words_ref.parse_min("5551234567")
    return (TW.focc_word1(True, 0, min1).numpy(),
            TW.focc_word2_general(min2, 0, 0, 0).numpy())


def test_focc_stream_injection_repeat_and_busy():
    """Queued words replace filler slots in order (both streams, A, B);
    repeats re-send once per later superframe; mark_busy flips the
    busy/idle bits of the next superframe only -- each step against the
    JAX FoccStream fed the same calls."""
    w1, w2 = _page_words()
    t, j = tfocc.FoccStream(sps=1), jfocc.FoccStream(sps=1)
    for st in (t, j):
        st.push_words(jfocc.STREAM_BOTH, [w1, w2], repeats=2)
        st.push_words(jfocc.STREAM_A, [w2])
        st.push_words(jfocc.STREAM_B, [w1])
        st.mark_busy(1)
    assert t.queue_depth() == j.queue_depth() == 4
    first = t.next_word_pairs()
    assert np.array_equal(first, j.next_word_pairs())
    assert np.array_equal(first[4, 0], w1) and np.array_equal(first[4, 1], w1)
    assert np.array_equal(first[6, 0], w2)
    assert np.array_equal(first[6, 1], TW.CONTROL_FILLER)
    assert np.array_equal(first[7, 1], w1)
    assert t.queue_depth() == j.queue_depth() == 2      # the repeats
    for _ in range(3):
        a, b = t.next_superframe_symbols(), j.next_superframe_symbols()
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(t.next_word_pairs(), t._template)


def test_focc_stream_rejects_bad_input():
    st = tfocc.FoccStream()
    with pytest.raises(ValueError):
        st.push_words(7, [np.zeros(28, np.uint8)])
    with pytest.raises(ValueError):
        st.push_words(tfocc.STREAM_A, [np.zeros(27, np.uint8)])


def test_focc_stream_debug_sink(tmp_path):
    sink = tmp_path / "debug.bits"
    st = tfocc.FoccStream(sps=1, debug_sink=str(sink), debug_limit=2000)
    a = st.next_superframe_symbols().numpy()
    st.next_superframe_symbols()
    st.close()
    assert np.array_equal(np.frombuffer(sink.read_bytes(), np.int8),
                          a[:2000].astype(np.int8))


def test_symbols_from_bitfile_matches_jax(tmp_path):
    p = tmp_path / "out.bits"
    p.write_bytes(b"10x1" + bytes([0, 1, 7]))
    for sps in (1, 3):
        assert np.array_equal(tfocc.symbols_from_bitfile(str(p), sps),
                              jfocc.symbols_from_bitfile(str(p), sps))


@pytest.mark.parametrize("accum0", [0, 5, [0, -3, 2]])
def test_fsk_manchester_baseband_bit_exact(accum0):
    bits = np.random.default_rng(3).integers(0, 2, (3, 463)).astype(np.uint8)
    a0 = torch.as_tensor(accum0, dtype=torch.int32)
    got, acc = tfm.fsk_manchester_baseband(torch.as_tensor(bits), 3, SENS, a0)
    want, _ = tfm.fm_modulate_symbols(
        manchester_encode_symbols(torch.as_tensor(bits), 3), SENS,
        a0[..., None] if a0.ndim else a0)
    assert torch.equal(got, want)
    assert torch.equal(acc, a0.expand(3))
    if np.ndim(accum0) == 0:
        jwant, _ = jfm.fsk_manchester_baseband(bits, 3, SENS, accum0)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=1e-6)


def _specs(M=16):
    kw = dict(num_channels=M, taps_per_phase=8, fold="bank")
    return JSpec(**kw), TSpec(**kw)


def test_tx_multichannel_block_matches_jax():
    jspec, tspec = _specs()
    wp = np.random.default_rng(4).integers(0, 2, (16, 2, 2, 28)).astype(
        np.uint8)
    want = np.asarray(jtx_block(jnp.asarray(wp), jspec))
    got = tx_multichannel_block(wp, tspec)
    assert got.shape == want.shape == (2 * 463 * 2 * 3 * 8, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


class _Tone:
    """A deterministic baseband source: a carrier at 0.05 rad/sample."""

    def __init__(self):
        self.t = 0

    def __call__(self, n):
        ph = 0.05 * (self.t + np.arange(n))
        self.t += n
        return np.stack([np.cos(ph), np.sin(ph)], -1).astype(np.float32)


def test_transmitter_two_blocks_match_jax():
    jspec, tspec = _specs()
    w1, w2 = _page_words()
    ctrl = [0, 2, 9, 15]
    txs = (JTx(jspec, control_channels=ctrl), TTx(tspec, control_channels=ctrl, device="cpu"))
    for tx in txs:
        tx.set_channel_source(5, _Tone())
        tx.focc[2].push_words(jfocc.STREAM_BOTH, [w1, w2], repeats=2)
    for _ in range(2):
        want = np.asarray(txs[0].next_block())
        got = txs[1].next_block()
        assert got.shape == want.shape == (18 * 463 * 2 * 3 * 8, 2)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    assert txs[1]._state.hop_idx == txs[0]._state.hop_idx == 2 * 18 * 463 * 6
    np.testing.assert_allclose(txs[1]._state.carry.numpy(),
                               np.asarray(txs[0]._state.carry), atol=2e-4)


def test_transmitter_without_control_channels_raises():
    with pytest.raises(ValueError):
        TTx(_specs()[1], control_channels=[], device="cpu").next_block()
