"""The single-channel chain of the port (``tx.modulator`` ->
``rx.frontend`` -> the sample-domain ``rx.correlator`` functions ->
``rx.decoder``) against the JAX package's on the CPU, and the checks of
tests/test_timing.py and of the canonical TX drive on the port.

The modulator's interpolator and the front end's filter are f32 sums of
~70 and ~300 products in library orders: 2e-5 on the unit-scale TX IQ
(gain 1/4 after zero-stuffing), 1e-4 on the demod, whose discriminator
follows a gain-3 filter.  Detection is held exactly (starts, valid, the
sliced symbols of valid bursts), quality to 1e-4."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.config import PipelineConfig as JPipe
from amps_tpu.rx import correlator as jcorr
from amps_tpu.rx import frontend as jfe
from amps_tpu.tx import modulator as jmod
from amps_tpu.tx import recc_ms
from amps_tpu_torch.codec import words as W
from amps_tpu_torch.config import PipelineConfig
from amps_tpu_torch.rx import correlator as tcorr
from amps_tpu_torch.rx import decoder
from amps_tpu_torch.rx import frontend as tfe
from amps_tpu_torch.tx import modulator as tmod
from amps_tpu_torch.tx.focc import (_FRAME_SRC, FRAME_BITS, STREAM_BOTH,
                                    FoccStream, focc_frame_bits)

torch.set_num_threads(1)

PIPE = PipelineConfig()


def _burst_stream(shift=0):
    words = recc_ms.page_response_words("5551234567")
    syms = recc_ms.burst_symbols(words, 0, PIPE.sps)
    idle = np.tile(np.array([1, -1], np.int8), 400)
    stream = np.concatenate([idle, syms, np.tile(idle, 5)]).astype(np.int8)
    return words, stream


def test_taps_equal_jax():
    assert np.array_equal(tmod.tx_interp_taps(), jmod.tx_interp_taps())
    assert np.array_equal(tfe.rx_lpf_taps(), jfe.rx_lpf_taps())
    assert len(tmod.tx_interp_taps()) == 193 and len(tfe.rx_lpf_taps()) == 299


def test_fsk_baseband_and_fm_modulate_match_jax():
    rng = np.random.default_rng(1)
    syms = rng.choice(np.array([-1, 1], np.int8), (2, 3000))
    wbb, wacc = jmod.fsk_baseband(syms, JPipe())
    gbb, gacc = tmod.fsk_baseband(syms, PIPE)
    assert np.abs(gbb.numpy() - np.asarray(wbb)).max() <= 1e-6
    assert np.array_equal(gacc.numpy(), np.asarray(wacc))
    want, (wa, wh) = jmod.fm_modulate(syms, JPipe())
    got, (ga, gh) = tmod.fm_modulate(syms, PIPE)
    assert got.shape == want.shape == (2, 12000, 2)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5
    assert np.array_equal(ga.numpy(), np.asarray(wa))
    assert np.abs(gh.numpy() - np.asarray(wh)).max() <= 1e-6
    # streaming: two blocks with the carried state equal one
    a, (acc, hist) = tmod.fm_modulate(syms[:, :1000], PIPE)
    b, _ = tmod.fm_modulate(syms[:, 1000:], PIPE, acc, hist)
    assert (torch.cat([a, b], 1) - got).abs().max() <= 1e-6
    # and the second block continues the JAX package's state
    _, (jacc, jhist) = jmod.fm_modulate(syms[:, :1000], JPipe())
    b2, _ = tmod.fm_modulate(syms[:, 1000:], PIPE, np.asarray(jacc),
                             np.asarray(jhist))
    assert (b2 - b).abs().max() <= 2e-5


@pytest.mark.parametrize("center", [0.0, -160_000.0])
def test_rx_frontend_matches_jax_and_streams(center):
    _, stream = _burst_stream()
    iq = tmod.fm_modulate(stream[:6000], PIPE)[0].numpy()
    if center:
        n = np.arange(len(iq))
        lo = np.exp(2j * np.pi * center * n / PIPE.rx_rate)
        z = (iq[:, 0] + 1j * iq[:, 1]) * lo
        iq = np.stack([z.real, z.imag], -1).astype(np.float32)
    want, wst = jfe.rx_frontend(jnp.asarray(iq), JPipe(), center_freq=center)
    got, gst = tfe.rx_frontend(torch.as_tensor(iq), PIPE, center_freq=center)
    assert got.shape == want.shape == (len(iq) // 2,)
    # past the filters' ramp-up (before it the discriminator sees ~0)
    assert np.abs(got.numpy() - np.asarray(want))[300:].max() <= 1e-4
    assert gst.phase_idx == wst.phase_idx == len(iq)
    a, st = tfe.rx_frontend(torch.as_tensor(iq[:10000]), PIPE, center)
    b, st2 = tfe.rx_frontend(torch.as_tensor(iq[10000:]), PIPE, center, st)
    assert st2.phase_idx == len(iq)
    assert (torch.cat([a, b]) - got)[300:].abs().max() <= 1e-4
    # from the JAX package's state
    _, jst = jfe.rx_frontend(jnp.asarray(iq[:10000]), JPipe(), center)
    b3, _ = tfe.rx_frontend(
        torch.as_tensor(iq[10000:]), PIPE, center,
        tfe.RxFrontendState(torch.as_tensor(np.asarray(jst.fir_history)),
                            jst.phase_idx,
                            torch.as_tensor(np.asarray(jst.demod_prev))))
    assert (b3 - b).abs().max() <= 1e-4


def _demod(shift=0):
    words, stream = _burst_stream()
    iq = tmod.fm_modulate(stream, PIPE)[0].numpy()
    iq = np.concatenate([np.zeros((shift, 2), np.float32), iq])
    n = len(iq) - len(iq) % 2
    demod, _ = tfe.rx_frontend(torch.as_tensor(iq[:n]), PIPE, center_freq=0.0)
    return words, demod.numpy()


def test_find_bursts_and_extract_match_jax():
    """Two bursts in one demod stream (the second a copy, later), batched
    over two rows: starts, valid and the sliced symbols of the valid
    captures exact, quality and soft symbols within 1e-4."""
    words, d = _demod()
    sps = 10
    pad = np.zeros(tcorr.CAPTURE_SYMBOLS * sps, np.float32)
    row = np.concatenate([d, d[1000:], pad])
    demod = np.stack([row, np.roll(row, 3)])
    ws, wv, wq = (np.asarray(a) for a in
                  jcorr.find_bursts(jnp.asarray(demod), sps, 3, 0.5))
    gs, gv, gq = (a.numpy() for a in
                  tcorr.find_bursts(torch.as_tensor(demod), sps, 3, 0.5))
    assert gs.dtype == ws.dtype and gs.shape == ws.shape == (2, 3)
    assert np.array_equal(gv, wv) and wv.sum() == 4
    # the two copies score alike, so their order in K may swap
    for r in range(2):
        assert sorted(gs[r][wv[r]]) == sorted(ws[r][wv[r]])
    assert np.abs(np.sort(gq, -1) - np.sort(wq, -1))[:, 1:].max() <= 1e-4
    wh, wsoft = jcorr.extract_burst_symbols(jnp.asarray(row),
                                            jnp.asarray(ws[0]), sps)
    gh, gsoft = tcorr.extract_burst_symbols(torch.as_tensor(row),
                                            torch.as_tensor(ws[0]), sps)
    assert gh.dtype == torch.uint8 and gh.shape == (3, tcorr.CAPTURE_SYMBOLS)
    assert np.abs(gsoft.numpy() - np.asarray(wsoft)).max() <= 1e-5
    assert np.array_equal(gh.numpy()[wv[0]], np.asarray(wh)[wv[0]])
    want = jcorr.find_and_extract(jnp.asarray(demod), sps, 3, 0.5)
    got = tcorr.find_and_extract(torch.as_tensor(demod), sps, 3, 0.5)
    for r in range(2):
        g = {int(s): h for s, v, h in zip(got[0][r], got[1][r],
                                          got[3][r].numpy()) if v}
        w = {int(s): h for s, v, h in zip(np.asarray(want[0][r]),
                                          np.asarray(want[1][r]),
                                          np.asarray(want[3][r])) if v}
        assert sorted(g) == sorted(w) and len(g) == 2
        assert all(np.array_equal(g[k], w[k]) for k in g)
    for k in np.flatnonzero(got[1][0].numpy()):
        dec = decoder.decode_bursts(got[3][0, k])
        assert dec.word_ok[:2].all()
        assert np.array_equal(dec.words[0].numpy(), words[0])


def test_extract_clamps_like_jax():
    """A start whose capture would pass the stream's end is moved back
    (the JAX package's dynamic_slice clamp)."""
    rng = np.random.default_rng(4)
    sps = 10
    d = rng.normal(0, 1, (tcorr.CAPTURE_SYMBOLS + 50) * sps).astype(np.float32)
    starts = np.array([7, 403, len(d) - 20], np.int32)
    wh, ws = jcorr.extract_burst_symbols(jnp.asarray(d), jnp.asarray(starts),
                                         sps)
    gh, gs = tcorr.extract_burst_symbols(torch.as_tensor(d),
                                         torch.as_tensor(starts), sps)
    assert np.abs(gs.numpy() - np.asarray(ws)).max() <= 1e-5
    assert (gh.numpy() != np.asarray(wh)).mean() <= 1e-3   # mean-slice ties
    with pytest.raises(ValueError, match="capture needs"):
        tcorr.extract_burst_symbols(torch.as_tensor(d[:1000]),
                                    torch.as_tensor(starts), sps)


@pytest.mark.parametrize("shift", [0, 1, 3, 7, 9, 14])
def test_decode_at_any_sample_phase(shift):
    """tests/test_timing.py on the port: the RF capture shifted by any
    number of samples at 400 ksps still decodes bit-exact."""
    words, demod = _demod(shift)
    sps = 10
    pad = np.zeros(tcorr.CAPTURE_SYMBOLS * sps, np.float32)
    starts, valid, q, hard, _ = tcorr.find_and_extract(
        torch.as_tensor(np.concatenate([demod, pad])), sps, 1, 0.5)
    assert bool(valid[0]), f"no burst at shift {shift}"
    dec = decoder.decode_bursts(hard[0])
    assert dec.word_ok[:2].all(), f"decode failed at {shift}"
    assert np.array_equal(dec.words[0].numpy(), words[0])
    assert np.array_equal(dec.words[1].numpy(), words[1])


def test_canonical_tx_drive():
    """A station paging a mobile, read back through the RX front end:
    FoccStream -> fm_modulate -> rx_frontend -> integrate and dump at 10
    samples a symbol at 200 ksps -> every frame bit, the paged words in
    frame 4's message positions."""
    bs, mirror = FoccStream(sps=PIPE.sps), FoccStream(sps=PIPE.sps)
    page = [W.focc_word1(True, 0, 0x5A5A5A).numpy(),
            W.focc_word2_general(0x2D3, 0, 0, 0).numpy()]
    for s in (bs, mirror):
        s.push_words(STREAM_BOTH, page)
    nfr = 6
    syms = bs.next_superframe_symbols()[: nfr * FRAME_BITS * 2 * PIPE.sps]
    iq, _ = tmod.fm_modulate(syms.to(torch.int8), PIPE)
    demod, _ = tfe.rx_frontend(iq, PIPE, center_freq=0.0)
    delay = ((len(tmod.tx_interp_taps()) - 1) // 2
             + (len(tfe.rx_lpf_taps()) - 1) // 2) // 2
    nb = (demod.shape[0] - delay) // 20 - 1
    sym = demod[delay: delay + nb * 20].reshape(nb, 2, 10).mean(-1)
    bits = (sym[:, 0] - sym[:, 1] < 0).to(torch.uint8)
    want = focc_frame_bits(torch.as_tensor(mirror.next_word_pairs()[:nfr]))
    assert torch.equal(bits, want[:nb])
    msg = bits[4 * FRAME_BITS: 5 * FRAME_BITS].numpy()[_FRAME_SRC >= 0]
    assert np.array_equal(msg[21:49], page[0])
    assert np.array_equal(msg[61:89], page[0])      # both streams
    nxt = want[5 * FRAME_BITS: 6 * FRAME_BITS].numpy()[_FRAME_SRC >= 0]
    assert np.array_equal(nxt[21:49], page[1])       # past the read-back
