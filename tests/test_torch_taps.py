"""Prototype filters longer than 16 taps a phase (T > 16), against the
JAX package on the CPU.

The CUDA kernels fold T > 16 taps in chunks of 16 (K1-K3) and run K4 as
one launch a chunk of 16 gain rows, summed with each chunk's hop shift
(``kernels.synth.tap_chunks``); on the CPU each wrapper computes its
plain version, so these tests hold the plain K1-K4 against the JAX
package's XLA functions at T = 17, 24, 32 and 33, a torch model of K4's
chunk recombination (the plain T <= 16 synthesis standing in for each
chunk launch) against the plain T-tap version and the JAX synthesis,
and the slice at M = 64, T = 32 -- the one-shot block, the streaming
receiver, the transmitter, one closed-loop block, the channelizer's
streaming calls, the receiver's and transmitter's checkpoints in the
JAX layout -- and the 2x2 sharded step at M = 8, T = 24.  The CUDA
kernels at these T are held to their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 32).

Tolerances: tests/test_pallas.py's atol 2e-4 for the f32 analysis and
synthesis; the discriminator within 1e-4 of the JAX f32 chain past the
bank's ramp-up (a sample on fast_atan2's octant seam within its step of
0.0417, such samples at most 1e-5 of the plane), its last sample within
2e-4; f32 phase streams within 1e-4 (a seam sample moves the sps = 3
symbols it enters by a third of the step); the chunked sum within 1e-4
of the output's RMS of the plain T-tap version (chip_smoke.py's
SYNTH_RTOL: f32 sums of up to 2T terms, which cancel to the output, in
another order); integers, booleans and report lists exactly; the
transmitter's wideband within 2e-4 (2e-5 of its peak through the
sharded step, as tests/test_torch_parallel.py holds it)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp.fm import quadrature_demod_planar as jdemod
from amps_tpu.eval.traffic import MobileEvent, synthesize_reverse_band
from amps_tpu.parallel import pipeline as jpl
from amps_tpu.parallel.mesh import MeshSpec as JMeshSpec
from amps_tpu.parallel.mesh import make_mesh as jmake_mesh
from amps_tpu.runtime import state as jstate
from amps_tpu.runtime.streamer import MultichannelReceiver as JRx
from amps_tpu.runtime.streamer import MultichannelTransmitter as JTx
from amps_tpu.runtime.streamer import make_closed_loop_stream as jloop
from amps_tpu.rx import correlator as jcor
from amps_tpu.tx.focc import superframe_word_pairs
from amps_tpu_torch.dsp import channelizer as tchz
from amps_tpu_torch.kernels import analysis as KA
from amps_tpu_torch.kernels import rx_front as K2
from amps_tpu_torch.kernels import rx_phases as K3
from amps_tpu_torch.kernels import synth as K4
from amps_tpu_torch.parallel import pipeline as pl
from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from amps_tpu_torch.runtime import state as tstate
from amps_tpu_torch.runtime import streamer as S
from amps_tpu_torch.runtime.streamer import MultichannelReceiver as TRx
from amps_tpu_torch.runtime.streamer import MultichannelTransmitter as TTx
from amps_tpu_torch.tx.focc import STREAM_BOTH

torch.set_num_threads(1)

LONG_T = (17, 24, 32, 33)
WIDTHS = (8, 64, 256)
NH = 40                    # hops of a kernel comparison
ATAN_SEAM = 0.0417
SEAM_FRACTION = 1e-5


def _ramp(T):
    """Hops of the bank's ramp-up from a zero history."""
    return 2 * T + 2


def _x_ext(M, T, Nh, seed, sigma=0.5):
    """A block with its history: random IQ throughout (a nonzero carry)."""
    P = M // 2
    return np.random.default_rng(seed).normal(
        0, sigma, ((Nh + 2 * T - 1) * P, 2)).astype(np.float32)


def _fsk_band(M, T, Nh, seed):
    """History-prepended wideband whose M channels all carry random-data
    FSK at 3 hops a symbol, through the port's plain synthesis."""
    from amps_tpu_torch.dsp.fm import fm_modulate_symbols
    rng = np.random.default_rng(seed)
    syms = np.repeat(rng.choice(np.array([-1, 1], np.int8), (M, -(-Nh // 3))),
                     3, axis=1)[:, :Nh]
    bb, _ = fm_modulate_symbols(torch.as_tensor(syms),
                                2 * np.pi * 8000 / 60000)
    carry = torch.zeros((M * T - M // 2, 2))
    x, _ = tchz._synthesize_block(bb.transpose(0, 1).contiguous(), M, T, 0,
                                  carry)
    return torch.cat([carry, x]).contiguous()


def _jax_planes(x_ext, M, T, parity):
    """The JAX package's bank analysis of a history-prepended block:
    (2, M, Nh)."""
    spec = jchz.ChannelizerSpec(M, T)
    L, P = M * T, M // 2
    state = jchz.AnalyzerState(jnp.asarray(x_ext[: L - P]), parity)
    y, _ = jchz.analyze(jnp.asarray(x_ext[L - P:]), spec, state, chmajor=True,
                        fold="bank", planar=True)
    return np.asarray(y)


def _held_to_demod_atol(err, ref, atol):
    a = np.abs(ref)
    seam = (np.abs(a - np.pi / 4) < 0.025) \
        | (np.abs(a - 3 * np.pi / 4) < 0.025)
    on_seam = (err > atol) & seam
    assert np.where(on_seam, 0.0, err).max() <= atol
    assert on_seam.sum() <= SEAM_FRACTION * err.size + 1
    assert err.max() <= ATAN_SEAM + atol


CASES = [(M, T) for T in LONG_T for M in WIDTHS]


@pytest.mark.parametrize("M,T", CASES)
def test_plain_k1_matches_jax_long_filter(M, T):
    """K1's plain version (the wrapper on a CPU tensor) against the JAX
    bank analysis, random IQ with a random history, both parities, riq
    and planar out: atol 2e-4."""
    x = _x_ext(M, T, NH, M + T)
    for parity in (0, 1):
        want = _jax_planes(x, M, T, parity)
        got = KA.analyze_block(torch.as_tensor(x), M, T, parity,
                               planar=True).numpy()
        assert got.shape == want.shape == (2, M, NH)
        assert np.abs(got - want).max() < 2e-4, parity
        riq = KA.analyze_block(torch.as_tensor(x), M, T, parity).numpy()
        assert np.array_equal(riq, np.moveaxis(got, 0, -1))


@functools.cache
def _fsk_case(M, T):
    """The FSK band K2 and K3 are held on (a ragged symbol at sps = 3)
    and the JAX bank analysis of it at each parity."""
    Nh = 2 * _ramp(T) + 3 * 8 + 1
    x = _fsk_band(M, T, Nh, M + T)
    return x, {p: _jax_planes(x.numpy(), M, T, p) for p in (0, 1)}


@pytest.mark.parametrize("M,T", CASES)
def test_plain_k2_matches_jax_long_filter(M, T):
    """K2's plain version on FSK in every channel, a random previous
    sample, both parities, against the JAX analysis and discriminator:
    demod within 1e-4 past the ramp-up (fast_atan2's seam rule), the last
    sample within 2e-4, the power series within 5% as 384-hop means."""
    x, planes = _fsk_case(M, T)
    Nh, r = x.shape[0] // (M // 2) - (2 * T - 1), _ramp(T)
    prev = np.random.default_rng(M).normal(0, 1, (M, 2)).astype(np.float32)
    for parity, ypl in planes.items():
        want_d, (lr, li), want_p = jdemod(
            jnp.asarray(ypl[0]), jnp.asarray(ypl[1]),
            prev=(jnp.asarray(prev[:, 0]), jnp.asarray(prev[:, 1])),
            return_power="series")
        d, last, pw = K2.analyze_demod(x, M, T, parity, torch.as_tensor(prev))
        assert d.shape == pw.shape == (M, Nh)
        want_d = np.asarray(want_d)[:, r:]
        _held_to_demod_atol(np.abs(d.numpy()[:, r:] - want_d), want_d, 1e-4)
        assert np.abs(last.numpy() - np.stack([lr, li], -1)).max() < 2e-4
        blk = np.asarray(jcor.window_power_blocks([jnp.asarray(pw.numpy())]))
        want_blk = np.asarray(jcor.window_power_blocks([want_p]))
        assert (np.abs(blk - want_blk) / want_blk).max() < 0.05


@pytest.mark.parametrize("M,T", CASES)
def test_plain_k3_matches_jax_long_filter(M, T):
    """K3's plain version on FSK in every channel, a ragged symbol, f32
    phases, both parities: within 1e-4 of the JAX f32 chain's phase
    streams past the ramp-up (a seam sample moves its symbols by a third
    of the step), the channel power within 5% of the JAX chain's."""
    sps = 3
    x, planes = _fsk_case(M, T)
    Nh = x.shape[0] // (M // 2) - (2 * T - 1)
    js = -(-_ramp(T) // sps)
    for parity, ypl in planes.items():
        ph, cp, pw_blk = K3.analyze_phases(x, M, T, sps, parity,
                                           torch.float32)
        demod, _, pw = jdemod(jnp.asarray(ypl[0]), jnp.asarray(ypl[1]),
                              return_power="series")
        want = np.asarray(jcor.symbol_phase_streams(demod, sps))
        assert ph.shape == want.shape == (M, sps, (Nh - sps + 1) // sps)
        err = np.abs(ph.numpy() - want)[..., js:]
        assert err.max() <= ATAN_SEAM / sps + 1e-4
        assert (err > 1e-4).sum() <= sps * SEAM_FRACTION * err.size + sps
        want_blk = np.asarray(jcor.window_power_blocks([pw]))
        want_cp = np.asarray(jcor.power_from_blocks(jnp.asarray(want_blk),
                                                    Nh))
        assert (np.abs(pw_blk.numpy() - want_blk) / want_blk).max() < 0.05
        assert (np.abs(cp.numpy() - want_cp) / want_cp).max() < 0.05


@pytest.mark.parametrize("M,T", CASES)
def test_plain_k4_matches_jax_long_filter(M, T):
    """K4's plain version (the wrapper on CPU tensors) against the JAX
    synthesis, random channel basebands with a random carry in, both
    parities: output and new carry within atol 2e-4."""
    rng = np.random.default_rng(M + T)
    Y = rng.normal(0, 1, (NH, M, 2)).astype(np.float32)
    carry = rng.normal(0, 0.1, (M * T - M // 2, 2)).astype(np.float32)
    for parity in (0, 1):
        want, state = jchz.synthesize(
            jnp.asarray(Y), jchz.ChannelizerSpec(M, T),
            jchz.SynthesizerState(jnp.asarray(carry), parity))
        got, got_carry = K4.synthesize_block(torch.as_tensor(Y), M, T, parity,
                                             torch.as_tensor(carry))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
        np.testing.assert_allclose(got_carry.numpy(), np.asarray(state.carry),
                                   atol=2e-4)


# ---- K4's chunk recombination, modelled on the CPU ----

def _chunked_synthesis(Y, M, T, parity, carry):
    """What synth_launch computes for T > 16, with the plain synthesis of
    T_c taps on the chunk's gain rows (a zero carry) standing in for each
    chunk launch: the chunk planes of Nh + 2T_c - 1 hops laid one after
    another in a scratch of ``scratch_values`` (after its zero carry),
    then output hop h = the sum over chunks c, ascending, of
    part_c[h - 2·t0_c], then the carry-in for h < 2T - 1; split into the
    block (Nh hops) and the new carry."""
    P, Nh = M // 2, Y.shape[0]
    taps = tchz.prototype_taps(M, T).reshape(T, M)
    zero = (2 * K4.CHUNK_TAPS - 1) * P
    scratch = torch.full((K4.scratch_values(M, T, Nh), 2), float("nan"))
    scratch[:zero] = 0
    offs, at = [], zero
    for t0, tc in K4.tap_chunks(T):
        x, c = tchz._synthesize_block(Y, M, tc, parity,
                                      scratch[:(2 * tc - 1) * P], 0,
                                      taps=taps[t0: t0 + tc].reshape(-1))
        n = (Nh + 2 * tc - 1) * P
        scratch[at: at + n] = torch.cat([x, c])
        offs.append((t0, at, Nh + 2 * tc - 1))
        at += n
    assert at == scratch.shape[0]
    out = torch.zeros(((Nh + 2 * T - 1) * P, 2))
    for t0, off, hops in offs:
        out[2 * t0 * P: (2 * t0 + hops) * P] += scratch[off: off + hops * P]
    out[: (2 * T - 1) * P] += carry
    return out[: Nh * P], out[Nh * P:]


@pytest.mark.parametrize("T", [17, 32, 33, 64])
@pytest.mark.parametrize("M", [8, 64])
def test_k4_chunk_recombination_matches_plain_and_jax(M, T):
    """The chunked sum (chunks of 16 gain rows, each shifted by 32 hops a
    chunk, the carry-in after them) equals the plain T-tap synthesis
    within 1e-4 of the output's RMS and the JAX synthesis within 2e-4,
    carry in and out, both parities; a call launches ceil(T/16)
    chunks."""
    assert K4.chunk_launches(T) == -(-T // 16) == len(K4.tap_chunks(T))
    assert sum(tc for _, tc in K4.tap_chunks(T)) == T
    Nh = 37
    rng = np.random.default_rng(M * T)
    Y = torch.as_tensor(rng.normal(0, 1, (Nh, M, 2)).astype(np.float32))
    carry = torch.as_tensor(rng.normal(0, 0.3, (M * T - M // 2, 2))
                            .astype(np.float32))
    for parity in (0, 1):
        x, c = _chunked_synthesis(Y, M, T, parity, carry)
        rx, rc = K4.synthesize_block_reference(Y, M, T, parity, carry)
        rms = rx.pow(2).mean().sqrt().item()
        assert x.shape == rx.shape and c.shape == rc.shape
        assert (x - rx).abs().max().item() <= 1e-4 * rms
        assert (c - rc).abs().max().item() <= 1e-4 * rms
        want, state = jchz.synthesize(
            jnp.asarray(Y.numpy()), jchz.ChannelizerSpec(M, T),
            jchz.SynthesizerState(jnp.asarray(carry.numpy()), parity))
        np.testing.assert_allclose(x.numpy(), np.asarray(want), atol=2e-4)
        np.testing.assert_allclose(c.numpy(), np.asarray(state.carry),
                                   atol=2e-4)


def test_k4_chunk_geometry():
    """T <= 16 is one launch of its own taps and no scratch; past it
    chunks of 16 rows and the rest, the scratch a zero carry of 31 hops
    and each chunk's plane; the ring past T = 16 is that of 16."""
    assert K4.tap_chunks(16) == [(0, 16)] and K4.scratch_values(64, 16, 9) == 0
    assert K4.tap_chunks(33) == [(0, 16), (16, 16), (32, 1)]
    assert K4.scratch_values(64, 33, 9) == (31 + 2 * (9 + 31) + 9 + 1) * 32
    for M in (8, 1024, 1536, 8192):
        assert K4.column_groups(M, 64) == K4.column_groups(M, 16)
        assert K4.thread_columns(M, 33) == K4.thread_columns(M, 16)


# ---- the slice at M = 64, T = 32 ----

M64, T32 = 64, 32
KW32 = dict(num_channels=M64, taps_per_phase=T32, fold="bank")


def _specs(**kw):
    return jpl.MultichannelSpec(**KW32, **kw), pl.MultichannelSpec(**KW32,
                                                                    **kw)


def _key(r):
    return (r.channel, r.abs_symbol, r.words.tolist(), r.word_ok.tolist(),
            np.asarray(r.bad_symbols).tolist(), r.dcc)


BURST = (30 + 11 + 7 + 2 * 240) * 2 * 3       # a 2-word burst, hops


CAPTURE = jcor.CAPTURE_SYMBOLS * 3          # a receiver's capture window, hops
PUSH = 4095                                 # odd: the parity flips


@functools.cache
def _band(hops=3600):
    """Three page responses (2 words), each ending 2T hops (the banks'
    delay) and more before the band does: in 3600 hops for the one-shot
    block, or in three pushes' worth (12285 hops) for the receiver, whose
    report waits for the burst's whole capture window."""
    js, _ = _specs()
    events = [MobileEvent("page_response", 1, 120, "4155559876"),
              MobileEvent("page_response", M64 // 2 + 3, 250, "2125550000"),
              MobileEvent("page_response", M64 - 2, 300, "7735550000")]
    assert max(e.start_hop for e in events) + BURST + 2 * T32 <= hops
    return np.asarray(synthesize_reverse_band(events, js, hops,
                                              noise_sigma=0.001)), events


def _pushes():
    """The receiver's band in three pushes of PUSH hops, every burst's
    capture window inside it."""
    x, events = _band(3 * PUSH)
    assert max(e.start_hop for e in events) + CAPTURE + 2 * T32 <= 3 * PUSH
    n = PUSH * M64 // 2
    return [x[i: i + n] for i in range(0, len(x), n)], events


def test_rx_block_matches_jax_at_t32():
    """rx_multichannel_block, f32 planes: starts, valid, words and
    word_ok equal the JAX block's, every planted burst found with its
    words."""
    x, events = _band()
    js, ts = _specs()
    want = jax.device_get(jpl.rx_multichannel_block(jnp.asarray(x), js,
                                                    max_bursts=2,
                                                    threshold=0.55))
    got = {k: v.numpy() for k, v in
           pl.rx_multichannel_block(torch.as_tensor(x), ts,
                                    max_bursts=2).items()}
    for k in ("starts", "valid", "words", "word_ok"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and np.array_equal(got[k], w), k
    for ev in events:
        w = np.stack(ev.words())
        assert got["valid"][ev.channel, 0]
        assert np.array_equal(got["words"][ev.channel, 0, :len(w)], w)
    assert got["valid"].sum() == len(events)


def test_receiver_three_pushes_match_jax_at_t32():
    """The band in three pushes (4095 hops each, odd: the parity flips)
    and a padded flush: the port's reports are the JAX receiver's, each
    planted burst once."""
    blocks, events = _pushes()
    js, ts = _specs()
    assert len(blocks) == 3
    jr = JRx(js, threshold=0.5, pipeline_depth=1)
    want = sum((jr.push(b) for b in blocks), []) + jr.flush(pad_tail=True)
    tr = TRx(ts, device="cpu", threshold=0.5, pipeline_depth=1)
    got = sum((tr.push(torch.as_tensor(b)) for b in blocks), []) \
        + tr.flush(pad_tail=True)
    assert [_key(r) for r in got] == [_key(r) for r in want]
    assert sorted(r.channel for r in got) == sorted(e.channel for e in events)


def _page_words():
    from amps_tpu.codec import words as W
    from amps_tpu.ref import words_ref
    min1, min2 = words_ref.parse_min("5551234567")
    return [np.asarray(W.focc_word1(True, 0, min1)),
            np.asarray(W.focc_word2_general(min2, 0, 0, 0))]


def test_transmitter_matches_jax_at_t32():
    """One superframe of the transmitter (FOCC on three slots, a page on
    one) within atol 2e-4 of the JAX transmitter's, and the same carried
    synthesis state."""
    js, ts = _specs()
    ctrl = [0, 9, 63]
    jtx = JTx(js, control_channels=ctrl)
    ttx = TTx(ts, device="cpu", control_channels=ctrl)
    for tx in (jtx, ttx):
        tx.focc[9].push_words(STREAM_BOTH, _page_words(), repeats=2)
    want = np.asarray(jtx.next_block())
    got = ttx.next_block().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(ttx._state.carry.numpy(),
                               np.asarray(jtx._state.carry), atol=2e-4)
    assert ttx._state.hop_idx == jtx._state.hop_idx


def test_closed_loop_block_matches_jax_at_t32():
    """One closed-loop block (make_closed_loop_stream over one block, its
    body closed_loop_block) on the test word pairs: no valid report and
    the JAX loop's quality peak within 2e-3 (f32 planes)."""
    js, ts = _specs()
    frames = 2
    pairs = superframe_word_pairs()[:frames]
    wp = np.broadcast_to(pairs, (M64,) + pairs.shape).copy()
    jrun, jbs = jloop(js, nblocks=1, frames=frames)
    trun, tbs = S.make_closed_loop_stream(ts, nblocks=1, frames=frames,
                                          device="cpu")
    assert tbs == jbs
    jv, jq, _ = (np.asarray(a) for a in jrun(jnp.asarray(wp)))
    tv, tq, _ = trun(wp)
    assert int(tv) == int(jv) == 0
    assert abs(float(tq) - float(jq)) <= 2e-3


def test_analyze_and_synthesize_chained_match_jax_at_t32():
    """dsp.channelizer.analyze and synthesize at T = 32 over two chained
    calls (an odd first block) against the JAX streaming calls: the
    channels within 2e-4, the wideband within 2e-4, the states carried
    (the parity and hop index exactly)."""
    spec_t, spec_j = tchz.ChannelizerSpec(M64, T32), \
        jchz.ChannelizerSpec(M64, T32)
    rng = np.random.default_rng(32)
    P = M64 // 2
    x = rng.normal(0, 0.5, (301 * P, 2)).astype(np.float32)
    ts_, js_ = tchz.analyzer_init(spec_t, device="cpu"), \
        jchz.analyzer_init(spec_j)
    for part in (x[: 151 * P], x[151 * P:]):
        ty, ts_ = tchz.analyze(torch.as_tensor(part), spec_t, ts_)
        jy, js_ = jchz.analyze(jnp.asarray(part), spec_j, js_)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4)
    assert ts_.hop_idx == int(js_.hop_idx)
    Y = rng.normal(0, 1, (301, M64, 2)).astype(np.float32)
    tss, jss = tchz.synthesizer_init(spec_t, device="cpu"), \
        jchz.synthesizer_init(spec_j)
    for part in (Y[:151], Y[151:]):
        tw, tss = tchz.synthesize(torch.as_tensor(part), spec_t, tss)
        jw, jss = jchz.synthesize(jnp.asarray(part), spec_j, jss)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=2e-4)
    np.testing.assert_allclose(tss.carry.numpy(), np.asarray(jss.carry),
                               atol=2e-4)
    assert tss.hop_idx == int(jss.hop_idx)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_receiver_checkpoint_across_packages_at_t32(tmp_path, direction):
    """A T = 32 receiver saved after its first push (save_receiver, the
    .npz both packages read) resumes in the other package: the two halves
    give the uninterrupted receiver's reports, each burst once."""
    blocks, events = _pushes()
    js, ts = _specs()
    head, tail = blocks[0], np.concatenate(blocks[1:])
    jr = JRx(js, threshold=0.5)
    want = jr.push(head) + jr.push(tail) + jr.flush(pad_tail=True)
    path = str(tmp_path / "rx.npz")
    if direction == "jax_to_port":
        a = JRx(js, threshold=0.5)
        got = a.push(head)
        jstate.save_receiver(path, a)
        b = TRx(ts, device="cpu", threshold=0.5)
        tstate.load_receiver(path, b)
        got += b.push(torch.as_tensor(tail)) + b.flush(pad_tail=True)
    else:
        a = TRx(ts, device="cpu", threshold=0.5)
        got = a.push(torch.as_tensor(head))
        tstate.save_receiver(path, a)
        b = JRx(js, threshold=0.5)
        jstate.load_receiver(path, b)
        got += b.push(tail) + b.flush(pad_tail=True)
    assert [_key(r) for r in got] == [_key(r) for r in want]
    assert sorted(r.channel for r in got) == sorted(e.channel for e in events)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_transmitter_checkpoint_across_packages_at_t32(tmp_path, direction):
    """A T = 32 transmitter's checkpoint (after one superframe, a page
    queued) resumes in the other package: the next superframe within
    atol 2e-4 of the uninterrupted transmitter's."""
    js, ts = _specs()
    ctrl = [0, 9]
    full = JTx(js, control_channels=ctrl)
    full.next_block()
    full.focc[9].push_words(STREAM_BOTH, _page_words(), repeats=2)
    path = str(tmp_path / "tx.npz")
    if direction == "jax_to_port":
        a = JTx(js, control_channels=ctrl)
        a.next_block()
        a.focc[9].push_words(STREAM_BOTH, _page_words(), repeats=2)
        jstate.save_transmitter(path, a)
        b = TTx(ts, device="cpu", control_channels=ctrl)
        tstate.load_transmitter(path, b)
        got = b.next_block().numpy()
    else:
        a = TTx(ts, device="cpu", control_channels=ctrl)
        a.next_block()
        a.focc[9].push_words(STREAM_BOTH, _page_words(), repeats=2)
        tstate.save_transmitter(path, a)
        b = JTx(js, control_channels=ctrl)
        jstate.load_transmitter(path, b)
        got = np.asarray(b.next_block())
    np.testing.assert_allclose(got, np.asarray(full.next_block()), atol=2e-4)


def test_sharded_step_matches_jax_at_t24():
    """The full-duplex step on a 2x2 mesh at M = 8, T = 24 (the JAX mesh
    of four virtual CPU devices against four port workers on the CPU),
    three blocks of reverse traffic with bursts mid-row, across the row
    boundary and across a block boundary: starts, valid, words and
    word_ok equal, the TX wideband within 2e-5 of its peak, the analyzer
    history equal and the synthesis carry within 2e-5 of the peak."""
    kw = dict(num_channels=8, taps_per_phase=24, fold="bank")
    js, ts = jpl.MultichannelSpec(**kw), pl.MultichannelSpec(**kw)
    hal, nb, row = jpl.full_demod_halo(js), 3, 12480
    block, hop = 2 * row, 4
    events = [MobileEvent("origination", 2, 700, "5551234567", "7025551000",
                          esn=7),
              MobileEvent("page_response", 3, row - 5000, "4155559876"),
              MobileEvent("registration", 6, block - 4000, "2125550000",
                          esn=5)]
    x = synthesize_reverse_band(events, js, nb * block, noise_sigma=0.001)
    frames = 2
    pairs = superframe_word_pairs()[:frames]
    wp = np.broadcast_to(pairs, (8,) + pairs.shape).copy()
    jstep = jpl.make_sharded_bs_stream_step(
        jmake_mesh(JMeshSpec(time=2, chan=2), jax.devices()[:4]), js, hal,
        max_bursts=2, rx_external=True)
    tstep = pl.make_sharded_bs_stream_step(
        make_mesh(MeshSpec(time=2, chan=2), ["cpu"]), ts, hal, max_bursts=2,
        rx_external=True)
    jst = jpl.sharded_stream_state(js, hal)
    st = pl.sharded_stream_state(ts, hal, "cpu")
    found = 0
    for b in range(nb):
        xb = x[b * block * hop:(b + 1) * block * hop]
        jout, jst = jstep(jnp.asarray(wp), jst, jnp.asarray(xb))
        jout, jst = jax.device_get((jout, jst))
        out, st = tstep(wp, st, torch.as_tensor(np.asarray(xb)))
        jtx = np.asarray(jout["tx_wideband"])
        peak = max(np.abs(jtx).max(), 1.0)
        assert np.abs(out["tx_wideband"].numpy() - jtx).max() <= 2e-5 * peak
        for k in ("starts", "valid", "words", "word_ok"):
            assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k
        assert np.array_equal(st["hist"].numpy(), jst["hist"])
        assert np.abs(st["syn_carry"].numpy() - jst["syn_carry"]).max() <= \
            2e-5 * peak
        found += int((out["valid"].numpy()
                      & out["word_ok"].numpy()[..., 0]).sum())
    assert found >= len(events)
