"""The port's plain analysis and synthesis banks against the JAX
package's (``fold="bank"``), including carried state across blocks."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu_torch import convert
from amps_tpu_torch.dsp import channelizer as tchz

torch.set_num_threads(1)

ATOL = 2e-4   # f32 analysis, the tolerance of tests/test_pallas.py


def _jax_analyze(x, spec, state, planar_in=False):
    y, st = jchz.analyze(jnp.asarray(x), spec, state, chmajor=True,
                         fold="bank", planar=True, planar_in=planar_in)
    return np.asarray(y), st


@pytest.mark.parametrize("M,Nh", [(16, 150), (256, 40)])
@pytest.mark.parametrize("planar_in", [False, True])
def test_analyze_matches_jax(M, Nh, planar_in):
    T = 8
    rng = np.random.default_rng(M + planar_in)
    x = rng.normal(0, 0.5, (Nh * M // 2, 2)).astype(np.float32)
    if planar_in:
        x = np.ascontiguousarray(x.T)
    jspec = jchz.ChannelizerSpec(M, T)
    want, _ = _jax_analyze(x, jspec, jchz.analyzer_init(jspec,
                                                        planar_in=planar_in),
                           planar_in)
    tspec = tchz.ChannelizerSpec(M, T)
    got, st = tchz.analyze(torch.as_tensor(x), tspec,
                           tchz.analyzer_init(tspec, planar_in=planar_in,
                                              device="cpu"),
                           planar=True, planar_in=planar_in, chmajor=True)
    assert got.shape == want.shape == (2, M, Nh)
    assert np.abs(got.numpy() - want).max() < ATOL
    assert st.hop_idx == Nh
    # channel-major interleaved output is the same planes
    got_i, _ = tchz.analyze(torch.as_tensor(x), tspec,
                            tchz.analyzer_init(tspec, planar_in=planar_in,
                                              device="cpu"),
                            planar=False, planar_in=planar_in, chmajor=True)
    assert torch.equal(got_i, torch.stack([got[0], got[1]], dim=-1))


@pytest.mark.parametrize("planar_in", [False, True])
def test_analyze_continues_jax_state(planar_in):
    """JAX block 1 -> state -> the port's block 2 == JAX block 2.  Block 1
    has an odd hop count, so block 2 starts at odd hop parity."""
    M, T = 32, 8
    P = M // 2
    rng = np.random.default_rng(11)
    x1 = rng.normal(0, 0.5, (37 * P, 2)).astype(np.float32)
    x2 = rng.normal(0, 0.5, (50 * P, 2)).astype(np.float32)
    if planar_in:
        x1, x2 = np.ascontiguousarray(x1.T), np.ascontiguousarray(x2.T)
    jspec = jchz.ChannelizerSpec(M, T)
    _, st1 = _jax_analyze(x1, jspec,
                          jchz.analyzer_init(jspec, planar_in=planar_in),
                          planar_in)
    want, _ = _jax_analyze(x2, jspec, st1, planar_in)
    state = convert.analyzer_state_from_numpy(np.asarray(st1.history),
                                              st1.hop_idx,
                                              device="cpu")
    assert state.hop_idx % 2 == 1
    got, st2 = tchz.analyze(torch.as_tensor(x2), tchz.ChannelizerSpec(M, T),
                            state, chmajor=True, planar=True,
                            planar_in=planar_in)
    assert np.abs(got.numpy() - want).max() < ATOL
    assert st2.hop_idx == 87


def test_analyze_rejects_other_folds():
    """Every fold name of the JAX package is taken (below); any other
    name raises."""
    spec = tchz.ChannelizerSpec(16, 4)
    assert tchz.FOLDS == ("conv", "shift", "bank", "bank2", "bankp")
    with pytest.raises(ValueError, match="unknown fold"):
        tchz.analyze(torch.zeros(64, 2), spec,
                     tchz.analyzer_init(spec, device="cpu"), fold="fft")


@pytest.mark.parametrize("fold", ["conv", "shift", "bank", "bank2", "bankp"])
def test_analyze_every_fold_matches_jax(fold):
    """Each fold name against the JAX analysis run with that fold, two
    streamed blocks (the second at odd parity), at the bank fold's
    tolerance: the folds are one sum in different f32 orders."""
    M, T = 16, 8
    P = M // 2
    rng = np.random.default_rng(5)
    blocks = [rng.normal(0, 0.5, (n * P, 2)).astype(np.float32)
              for n in (75, 40)]
    jspec, tspec = jchz.ChannelizerSpec(M, T), tchz.ChannelizerSpec(M, T)
    jst = jchz.analyzer_init(jspec)
    tst = tchz.analyzer_init(tspec, device="cpu")
    for x in blocks:
        want, jst = jchz.analyze(jnp.asarray(x), jspec, jst, chmajor=True,
                                 fold=fold, planar=True)
        got, tst = tchz.analyze(torch.as_tensor(x), tspec, tst, fold=fold,
                                planar=True, chmajor=True)
        assert np.abs(got.numpy() - np.asarray(want)).max() < ATOL
    assert tst.hop_idx == jst.hop_idx == 115


@pytest.mark.parametrize("M,split", [(32, 0), (32, 8), (64, 0)])
def test_synthesize_matches_jax(M, split):
    T = 8
    rng = np.random.default_rng(M + split)
    Y1 = rng.normal(0, 1, (45, M, 2)).astype(np.float32)
    Y2 = rng.normal(0, 1, (30, M, 2)).astype(np.float32)
    jspec = jchz.ChannelizerSpec(M, T)
    tspec = tchz.ChannelizerSpec(M, T)
    jst = jchz.synthesizer_init(jspec)
    tst = tchz.synthesizer_init(tspec, device="cpu")
    for Y in (Y1, Y2):     # the second block carries state at odd parity
        want, jst = jchz.synthesize(jnp.asarray(Y), jspec, jst, split=split)
        got, tst = tchz.synthesize(torch.as_tensor(Y), tspec, tst,
                                   split=split)
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
        assert np.abs(tst.carry.numpy()
                      - np.asarray(jst.carry)).max() < 1e-5
        assert tst.hop_idx == jst.hop_idx
