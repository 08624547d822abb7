"""The port's fused closed loop (``runtime.streamer.make_closed_loop_stream``
and its block body ``closed_loop_block``) against the JAX package's on
the CPU, where the two kernels run as their plain versions.

Tolerances.  ``n_valid`` and ``block_samples`` are exact.  ``quality_max``
is held to 2e-3 with f32 planes and 0.02 with bf16 planes: the peak of a
normalized correlation of a few hundred f32 (or bf16) terms summed in
two orders.  ``n_word_ok`` sums over every candidate slot, valid or not,
and a noise-free FOCC band is periodic: every frame repeats its dotting,
word sync and busy/idle bits, and the carried overlap is the previous
block's copy of the same superframe, so a channel's best candidates come
in pairs of equal quality, 5556 hops apart, whose argmax tie f32 roundoff
breaks either way (distinct random word pairs per channel do not help:
the tie is within a channel).  Even the JAX loop and the per-block JAX
reference built from the same calls disagree on it (200 against 219
here).  So ``n_word_ok`` is held exactly between ``run`` and the port's
own per-block planes, and against JAX through ``word_ok`` on the valid
slots of a loop with a planted reverse burst.  State tensors are held to
1e-4 of their RMS; on the planted channel the demod carry is compared
inside the burst, since an idle channel demodulates the f32 roundoff of
its neighbours' leakage (branch cuts of 2π).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp.fm import fm_modulate_symbols as jfm
from amps_tpu.dsp.fm import fsk_manchester_baseband as jfsk
from amps_tpu.dsp.fm import quadrature_demod_planar as jdemod
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu.runtime.streamer import make_closed_loop_stream as jloop
from amps_tpu.rx import correlator as jcorr
from amps_tpu.rx import decoder as jdec
from amps_tpu.tx import recc_ms
from amps_tpu.tx.focc import focc_frame_bits as jframe_bits
from amps_tpu.tx.focc import superframe_word_pairs
from amps_tpu_torch import convert
from amps_tpu_torch.dsp.fm import fsk_manchester_baseband as tfsk
from amps_tpu_torch.parallel.pipeline import MultichannelSpec as TSpec
from amps_tpu_torch.runtime import streamer as S
from amps_tpu_torch.tx.focc import focc_frame_bits as tframe_bits

torch.set_num_threads(1)

M, T, FRAMES = 8, 4, 2
N_HOPS = FRAMES * 463 * 2 * 3


def _specs(bf16=False, **kw):
    kw = dict(num_channels=M, taps_per_phase=T, io_bf16=bf16,
              corr_bf16=bf16, **kw)
    return JSpec(**kw), TSpec(**kw)


def _random_pairs(seed=0):
    """Distinct random 28-bit word pairs per channel and frame."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (M, FRAMES, 2, 28)).astype(np.uint8)


def _jax_Y(pairs, spec):
    """The hoisted part of the JAX loop (``_prep``): (n_hops, M, 2)."""
    sens = 2.0 * np.pi * spec.pipe.deviation_hz / spec.pipe.chan_rate
    bb, _ = jfsk(jframe_bits(jnp.asarray(pairs)), spec.chan_sps, sens)
    return np.asarray(jnp.swapaxes(bb, 0, 1))


def _jax_state0(spec):
    keep = M * T - M // 2
    ovr = (jcorr.TRIGGER_SYMBOLS + jcorr.CAPTURE_SYMBOLS) * spec.chan_sps
    return {"syn_carry": np.zeros((keep, 2), np.float32),
            "hist": np.zeros((keep, 2), np.float32),
            "carry": np.zeros((M, min(ovr, N_HOPS)), np.float32),
            "prev": np.zeros((M, 2), np.float32)}


@functools.partial(jax.jit, static_argnames=("spec", "max_bursts"))
def _jax_block(Y, st, spec, max_bursts=2, threshold=0.55):
    """One block from the public JAX calls that the loop's scan body
    makes, in its order."""
    sps = spec.chan_sps
    L, P = M * T, M // 2
    h = jnp.asarray(jchz.prototype_taps(M, T))
    split = jchz.default_split(M)
    x, syn_tail = jchz._synthesize_block(Y, h, M, T, 0, st["syn_carry"],
                                         spec.transform_bf16, split)
    x_ext = jnp.concatenate([st["hist"], x], axis=0)
    ypl = jchz._analyze_block_chmajor(x_ext, h, M, T, 0, spec.transform_bf16,
                                      split, spec.fold, planar=True)
    demod_new, (lr, li) = jdemod(ypl[0], ypl[1], 1.0,
                                 (st["prev"][:, 0], st["prev"][:, 1]))
    demod = jnp.concatenate([st["carry"], demod_new], axis=-1)
    dsp = demod.astype(jnp.bfloat16) if spec.io_bf16 else demod
    phases = jcorr.symbol_phase_streams(dsp, sps)
    starts, valid, quality = jcorr.find_bursts_phases(
        phases, sps, max_bursts, threshold, out_bf16=spec.corr_bf16)
    valid = valid & (starts + jcorr.CAPTURE_SYMBOLS * sps <= demod.shape[-1])
    ext = jcorr.extract_from_phases(
        phases, starts, sps,
        hard_dtype=jnp.bfloat16 if spec.io_bf16 else jnp.uint8,
        lead=jcorr.TRIGGER_SYMBOLS)
    valid = jcorr.apply_trigger_gate_soft(valid, ext[2],
                                          spec.max_trigger_errors, starts,
                                          sps)
    dec = jdec.decode_bursts(ext[0], repeat_gate=spec.decode_repeat_gate)
    nc = st["carry"].shape[-1]
    st2 = {"syn_carry": syn_tail, "hist": x_ext[-(L - P):],
           "carry": demod[:, -nc:], "prev": jnp.stack([lr, li], axis=-1)}
    return st2, {"starts": starts, "valid": valid, "quality": quality,
                 "words": dec.words, "word_ok": dec.word_ok}


def _jax_blocks(Ys, spec):
    """Per-block (state, planes) of the JAX reference over the blocks'
    channel planes Ys."""
    st, out = _jax_state0(spec), []
    for Y in Ys:
        st, pl = _jax_block(jnp.asarray(Y), {k: jnp.asarray(v)
                                             for k, v in st.items()}, spec)
        st = {k: np.asarray(v) for k, v in st.items()}
        out.append((st, {k: np.asarray(v) for k, v in pl.items()}))
    return out


def _port_blocks(Ys, spec, st=None):
    st = st or S.closed_loop_state0(spec, FRAMES, "cpu")
    out = []
    for Y in Ys:
        st, pl = S.closed_loop_block(torch.as_tensor(Y), st, spec)
        out.append(({k: v.numpy().copy() for k, v in st.items()},
                    {k: v.to(torch.float32).numpy() if v.is_floating_point()
                     else v.numpy() for k, v in pl.items()}))
    return out


def _sums(blocks):
    return (sum(int(pl["valid"].sum()) for _, pl in blocks),
            max(float(pl["quality"].astype(np.float32).max())
                for _, pl in blocks),
            sum(int(pl["word_ok"].sum()) for _, pl in blocks))


@pytest.mark.parametrize("nblocks", [1, 2, 3])
@pytest.mark.parametrize("bf16", [False, True])
def test_closed_loop_matches_jax(nblocks, bf16):
    """The default spec (fold "conv") and a bf16 spec, the test's word
    pairs of tests/test_runtime.py: no valid report (a FOCC loopback must
    not trigger the RECC detector) and the same peak quality."""
    jspec, tspec = _specs(bf16)
    pairs = superframe_word_pairs()[:FRAMES]
    wp = np.broadcast_to(pairs, (M,) + pairs.shape).copy()
    jrun, jbs = jloop(jspec, nblocks=nblocks, frames=FRAMES)
    trun, tbs = S.make_closed_loop_stream(tspec, nblocks=nblocks,
                                          frames=FRAMES, device="cpu")
    assert tbs == jbs == N_HOPS * M // 2
    jv, jq, _ = (np.asarray(a) for a in jrun(jnp.asarray(wp)))
    tv, tq, tw = trun(wp)
    assert all(a.ndim == 0 and a.device.type == "cpu" for a in (tv, tq, tw))
    assert tq.dtype == torch.float32
    assert int(tv) == int(jv) == 0
    assert float(tq) < 0.55
    assert abs(float(tq) - float(jq)) <= (0.02 if bf16 else 2e-3)


def test_closed_loop_sums_match_per_block_planes():
    """Distinct random word pairs per channel, f32 quality planes.  The
    per-block JAX reference is the JAX loop (n_valid equal, quality_max
    within 1e-6; n_word_ok moves with argmax ties even between these two,
    see the module docstring).  The port's ``run`` is the sum of the
    port's per-block planes, n_word_ok included, and agrees with JAX on
    n_valid and quality_max."""
    jspec, tspec = _specs()
    wp = _random_pairs(3)
    jrun, _ = jloop(jspec, nblocks=3, frames=FRAMES)
    want = tuple(np.asarray(a) for a in jrun(jnp.asarray(wp)))
    Y = _jax_Y(wp, jspec)
    ref = _sums(_jax_blocks([Y] * 3, jspec))
    assert ref[0] == int(want[0]) == 0
    assert abs(ref[1] - float(want[1])) <= 1e-6
    slots = 3 * M * 2 * 7
    assert 0 < ref[2] <= slots and 0 < int(want[2]) <= slots
    trun, _ = S.make_closed_loop_stream(tspec, nblocks=3, frames=FRAMES,
                                        device="cpu")
    got = trun(wp)
    # the port's own hoisted part (its FSK table differs from the JAX
    # one in the last bit, which is enough to move a tie)
    bb, _ = tfsk(tframe_bits(torch.as_tensor(wp)), tspec.chan_sps,
                 tspec.fm_sensitivity)
    tY = bb.transpose(0, 1).contiguous().numpy()
    assert np.abs(tY - Y).max() < 1e-6
    own = _sums(_port_blocks([tY] * 3, tspec))
    assert (int(got[0]), float(got[1]), int(got[2])) == own
    assert int(got[0]) == int(want[0])
    assert abs(float(got[1]) - float(want[1])) <= 2e-3
    assert 0 < int(got[2]) <= slots
    # graph=False is the same eager body; the CPU never captures
    again = S.make_closed_loop_stream(tspec, nblocks=3, frames=FRAMES,
                                      device="cpu", graph=False)[0](wp)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _planted(spec, chan=3, start=N_HOPS + 100, nblocks=4):
    """Per-block channel planes: FOCC on every channel but ``chan``,
    which carries one reverse burst from hop ``start`` (block 1) to past
    the boundary of blocks 1 and 2."""
    Y = _jax_Y(_random_pairs(5), spec)
    words = recc_ms.registration_words("2135551212", esn=0xBEEF)
    syms = recc_ms.burst_symbols(words, dcc=0, sps=spec.chan_sps)
    sens = 2.0 * np.pi * spec.pipe.deviation_hz / spec.pipe.chan_rate
    bb = np.asarray(jfm(np.asarray(syms, np.int8), sens)[0])
    row = np.zeros((nblocks * N_HOPS, 2), np.float32)
    row[start: start + len(bb)] = bb
    assert start + len(bb) > 2 * N_HOPS       # straddles blocks 1 | 2
    Ys = []
    for b in range(nblocks):
        Yb = Y.copy()
        Yb[:, chan] = row[b * N_HOPS: (b + 1) * N_HOPS]
        Ys.append(Yb)
    return Ys, chan, np.stack([np.asarray(w) for w in words]), \
        (start + 30, start + len(bb))


def _assert_state_close(tst, jst, b, chan, burst):
    """State after block b within 1e-4 of its RMS; the planted channel's
    demod carry (block b's own hops) inside the burst only."""
    for k in jst:
        t, j = tst[k], jst[k]
        if k == "carry":
            hops = b * N_HOPS + np.arange(N_HOPS)
            keep = np.ones(j.shape, bool)
            keep[chan] = (hops >= burst[0]) & (hops < burst[1])
            t, j = t[keep], j[keep]
        rms = np.sqrt(np.mean(j ** 2))
        assert np.sqrt(np.mean((t - j) ** 2)) <= 1e-4 * rms, (b, k)


@pytest.mark.parametrize("bf16", [False, True])
def test_block_planes_match_jax_with_boundary_burst(bf16):
    """A reverse burst across the boundary of blocks 1 and 2 is found
    whole in block 2's window (the carried overlap is block 1), once, and
    decoded; per block: ``valid`` exact, starts / words / word_ok exact on
    valid slots, the state within 1e-4 of its RMS."""
    jspec, tspec = _specs(bf16)
    Ys, chan, words, burst = _planted(jspec)
    want = _jax_blocks(Ys, jspec)
    got = _port_blocks(Ys, tspec)
    found = 0
    for b, ((jst, jpl), (tst, tpl)) in enumerate(zip(want, got)):
        v = jpl["valid"]
        assert np.array_equal(tpl["valid"], v), b
        for k in ("starts", "words", "word_ok"):
            assert np.array_equal(tpl[k][v], jpl[k][v]), (b, k)
        np.testing.assert_allclose(tpl["quality"][v],
                                   jpl["quality"].astype(np.float32)[v],
                                   atol=0.02 if bf16 else 2e-3)
        _assert_state_close(tst, jst, b, chan, burst)
        if v.any():
            assert b == 2 and v.sum() == 1 and v[chan, 0]
            assert tpl["word_ok"][chan, 0, : len(words)].all()
            assert np.array_equal(tpl["words"][chan, 0, : len(words)], words)
            found += 1
    assert found == 1


def test_block_continues_a_jax_state():
    """The port's block 2 started from the JAX state after block 1
    (``convert.closed_loop_state_from_numpy``) is the JAX block 2."""
    jspec, tspec = _specs()
    Ys, chan, _, burst = _planted(jspec)
    want = _jax_blocks(Ys[:3], jspec)
    st = convert.closed_loop_state_from_numpy(device="cpu", **want[1][0])
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in
         S.closed_loop_state0(tspec, FRAMES, "cpu").items()}
    (tst, tpl), = _port_blocks(Ys[2:3], tspec, st)
    jst, jpl = want[2]
    assert np.array_equal(tpl["valid"], jpl["valid"]) and tpl["valid"][chan, 0]
    assert tpl["starts"][chan, 0] == jpl["starts"][chan, 0]
    assert np.array_equal(tpl["words"][chan, 0], jpl["words"][chan, 0])
    _assert_state_close(tst, jst, 2, chan, burst)


@pytest.mark.parametrize("nblocks", [1, 3])
def test_search_argument_runs_every_block(nblocks):
    """The loop's search argument is the trigger search of every block,
    with the loop's K and threshold; the plain search gives the default
    loop's sums."""
    from amps_tpu_torch.rx.correlator import find_bursts_phases_reference
    tspec = _specs(True)[1]
    wp = _random_pairs(nblocks)
    calls = []

    def search(phases, sps, max_bursts, threshold, **kw):
        calls.append((tuple(phases.shape), max_bursts, threshold))
        return find_bursts_phases_reference(phases, sps, max_bursts,
                                            threshold, **kw)

    run, _ = S.make_closed_loop_stream(tspec, nblocks, FRAMES, 3, 0.5,
                                       device="cpu", search=search)
    got = run(wp)
    nsym = (2 * N_HOPS - tspec.chan_sps + 1) // tspec.chan_sps
    assert calls == [((M, tspec.chan_sps, nsym), 3, 0.5)] * nblocks
    want = S.make_closed_loop_stream(tspec, nblocks, FRAMES, 3, 0.5,
                                     device="cpu")[0](wp)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_closed_loop_geometry_and_checks(monkeypatch):
    tspec = _specs()[1]
    assert S.closed_loop_geometry(tspec, 2) == (5556, 5556 * 4, 5556)
    assert S.closed_loop_geometry(tspec, 4) == (11112, 11112 * 4, 10344)
    run, _ = S.make_closed_loop_stream(tspec, nblocks=1, device="cpu")
    with pytest.raises(ValueError, match="word_pairs"):
        run(np.zeros((M, 3, 2, 28), np.uint8))
    with pytest.raises(ValueError, match="even hop count"):
        S.closed_loop_block(torch.zeros((5, M, 2)),
                            S.closed_loop_state0(tspec, 2, "cpu"), tspec)
    with pytest.raises(ValueError, match="unknown fold"):
        S.make_closed_loop_stream(_specs(fold="fft")[1], 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.make_closed_loop_stream(tspec, nblocks=1)
