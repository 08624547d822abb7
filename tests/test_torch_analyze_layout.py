"""``dsp.channelizer.analyze`` takes the JAX signature and returns the JAX
layouts: hop-major (..., N/P, M, 2) by default, channel-major with
``chmajor``, planar planes with ``chmajor`` and ``planar``; leading batch
dimensions in every layout, at M = 8 and 64; ``bf16`` and ``split``
accepted and changing nothing in the port's f32 transform.  Also the
spec's rates and ``channel_index``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu_torch.dsp import channelizer as tchz

torch.set_num_threads(1)

ATOL = 2e-4   # f32 analysis, the tolerance of tests/test_pallas.py
T = 8


def _x(batch, M, Nh, seed, planar_in=False):
    x = np.random.default_rng(seed).normal(
        0, 0.5, batch + (Nh * M // 2, 2)).astype(np.float32)
    return np.ascontiguousarray(np.swapaxes(x, -1, -2)) if planar_in else x


@pytest.mark.parametrize("M", [8, 64])
def test_default_layout_is_hop_major(M):
    """analyze(x, spec, state) returns the JAX function's hop-major
    (N/P, M, 2) planes and state, streamed over two blocks."""
    jspec, tspec = jchz.ChannelizerSpec(M, T), tchz.ChannelizerSpec(M, T)
    jst = jchz.analyzer_init(jspec)
    tst = tchz.analyzer_init(tspec, device="cpu")
    for seed, Nh in ((1, 75), (2, 40)):
        x = _x((), M, Nh, seed)
        want, jst = jchz.analyze(jnp.asarray(x), jspec, jst)
        got, tst = tchz.analyze(torch.as_tensor(x), tspec, tst)
        want = np.asarray(want)
        assert got.shape == want.shape == (Nh, M, 2)
        assert np.abs(got.numpy() - want).max() < ATOL
        assert tst.hop_idx == jst.hop_idx
        assert np.array_equal(tst.history.numpy(), np.asarray(jst.history))


_LAYOUTS = [(False, False, False), (True, False, False), (True, True, False),
            (True, False, True), (True, True, True)]


@pytest.mark.parametrize("M", [8, 64])
@pytest.mark.parametrize("chmajor,planar,planar_in", _LAYOUTS)
def test_layouts_with_batch_dims(M, chmajor, planar, planar_in):
    """A (2, 3) batch of streams in each layout against the JAX function,
    and each row equal to the same call on that row alone."""
    Nh, batch = 41, (2, 3)
    jspec, tspec = jchz.ChannelizerSpec(M, T), tchz.ChannelizerSpec(M, T)
    x = _x(batch, M, Nh, M + 3 * planar + planar_in, planar_in)
    kw = dict(chmajor=chmajor, planar=planar, planar_in=planar_in)
    want, jst = jchz.analyze(jnp.asarray(x), jspec,
                             jchz.analyzer_init(jspec, batch, planar_in),
                             fold="bank", **kw)
    got, tst = tchz.analyze(torch.as_tensor(x), tspec,
                            tchz.analyzer_init(tspec, batch, planar_in,
                                               device="cpu"), **kw)
    want = np.asarray(want)
    assert got.shape == want.shape and got.shape[:2] == batch
    assert np.abs(got.numpy() - want).max() < ATOL
    assert np.array_equal(tst.history.numpy(), np.asarray(jst.history))
    row, _ = tchz.analyze(torch.as_tensor(x[1, 2]), tspec,
                          tchz.analyzer_init(tspec, (), planar_in,
                                             device="cpu"), **kw)
    assert torch.allclose(got[1, 2], row, atol=1e-6, rtol=0)


def test_planar_needs_chmajor():
    """Planar output or input without chmajor raises, as the JAX function
    asserts."""
    spec = tchz.ChannelizerSpec(8, T)
    x = torch.zeros(64, 2)
    with pytest.raises(ValueError, match="planar output requires chmajor"):
        tchz.analyze(x, spec, tchz.analyzer_init(spec, device="cpu"),
                     planar=True)
    with pytest.raises(ValueError, match="planar input requires chmajor"):
        tchz.analyze(x.t().contiguous(), spec,
                     tchz.analyzer_init(spec, planar_in=True, device="cpu"),
                     planar_in=True)


def test_bf16_and_split_change_nothing():
    """The port computes one f32 transform whatever bf16 and split say
    (a divergence by design: the JAX function rounds its transform to
    bf16 when asked)."""
    M = 64
    spec = tchz.ChannelizerSpec(M, T)
    x = torch.as_tensor(_x((), M, 30, 9))
    st = tchz.analyzer_init(spec, device="cpu")
    y, _ = tchz.analyze(x, spec, st)
    for kw in (dict(bf16=True), dict(split=8), dict(split=0, bf16=True)):
        assert torch.equal(tchz.analyze(x, spec, st, **kw)[0], y)
    Y = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (20, M, 2)).astype(np.float32))
    sst = tchz.synthesizer_init(spec, device="cpu")
    assert torch.equal(tchz.synthesize(Y, spec, sst, bf16=True)[0],
                       tchz.synthesize(Y, spec, sst)[0])


@pytest.mark.parametrize("M", [8, 64, 1024])
def test_spec_rates_and_channel_index(M):
    jspec, tspec = jchz.ChannelizerSpec(M, T), tchz.ChannelizerSpec(M, T)
    assert tspec.fs == jspec.fs == M * 30_000.0
    assert tspec.channel_rate == jspec.channel_rate == 60_000.0
    for off in (-3, -1, 0, 1, 3, M // 2):
        assert tchz.channel_index(off, M) == jchz.channel_index(off, M)
