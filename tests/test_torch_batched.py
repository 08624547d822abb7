"""The port's batched small-bank receive block against its single-band
block and the JAX package's batched block, on tests/test_rx.py's
scenario: M=16, G=3 independent bands, one origination a band (traffic
from the JAX ``synthesize_reverse_band``, as numpy).

Integers are exact on every slot against the port's own single-band
block (the same ops on a leading axis) and on valid slots against JAX
(a noise-only slot's capture is sliced against its own mean, which two
f32 orders resolve differently); quality to 1e-4, rssi and chan_power to
1e-4 relative."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.eval.traffic import MobileEvent, synthesize_reverse_band
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu.parallel.pipeline import rx_multichannel_block_batched as jrxb
from amps_tpu_torch.kernels import rx_phases as K3
from amps_tpu_torch.parallel.pipeline import MultichannelSpec as TSpec
from amps_tpu_torch.parallel.pipeline import (rx_multichannel_block,
                                              rx_multichannel_block_batched)

torch.set_num_threads(1)

M, G, TOTAL_HOPS = 16, 3, 16384
INT_KEYS = ("starts", "valid", "words", "word_ok", "dcc_bits", "bad_symbols")


@functools.cache
def _bands():
    spec = JSpec(num_channels=M, taps_per_phase=8)
    evs = [[MobileEvent("origination", 3, 700, "5551234567", "7025551000",
                        esn=g)] for g in range(G)]
    xs = np.stack([np.asarray(synthesize_reverse_band(
        e, spec, TOTAL_HOPS, noise_sigma=0.001, seed=g))
        for g, e in enumerate(evs)])
    return xs, evs


@pytest.mark.parametrize("bf16", [False, True])
def test_batched_equals_single_band(bf16):
    xs, evs = _bands()
    spec = TSpec(num_channels=M, taps_per_phase=8, io_bf16=bf16,
                 corr_bf16=bf16)
    out = rx_multichannel_block_batched(torch.as_tensor(xs), spec,
                                        max_bursts=1)
    for g in range(G):
        ref = rx_multichannel_block(torch.as_tensor(xs[g]), spec,
                                    max_bursts=1)
        assert set(out) == set(ref)
        for k in ref:
            assert out[k].shape == (G,) + ref[k].shape
            if k in INT_KEYS:
                assert torch.equal(out[k][g], ref[k]), (g, k)
            else:
                torch.testing.assert_close(out[k][g].float(), ref[k].float(),
                                           rtol=1e-5, atol=1e-6)
        want = np.stack(evs[g][0].words())
        assert bool(out["valid"][g, 3, 0])
        assert np.array_equal(out["words"][g, 3, 0, : len(want)].numpy(),
                              want)


@pytest.mark.parametrize("policy", ["first_ok", "majority"])
def test_batched_matches_jax(policy):
    xs, evs = _bands()
    kw = dict(num_channels=M, taps_per_phase=8)
    want = jax.device_get(jrxb(jnp.asarray(xs), JSpec(**kw), max_bursts=1,
                               threshold=0.55, policy=policy))
    got = {k: v.numpy() for k, v in rx_multichannel_block_batched(
        torch.as_tensor(xs), TSpec(**kw), max_bursts=1,
        policy=policy).items()}
    assert set(got) == set(want)
    valid = np.asarray(want["valid"])
    assert valid.sum() == G and valid[:, 3, 0].all()
    assert np.array_equal(got["valid"], valid)
    for k in INT_KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        assert np.array_equal(got[k][valid], w[valid]), k
    np.testing.assert_allclose(got["quality"][valid],
                               np.asarray(want["quality"])[valid], atol=1e-4)
    np.testing.assert_allclose(got["rssi"][valid],
                               np.asarray(want["rssi"])[valid], rtol=1e-4)
    np.testing.assert_allclose(got["chan_power"],
                               np.asarray(want["chan_power"]), rtol=1e-4)


def test_front_end_plain_version_takes_a_band_axis():
    """The plain version of the rx_phases kernel on (G, n, 2) equals G
    calls on (n, 2), riq and planar."""
    xs, _ = _bands()
    x = torch.as_tensor(xs[:, : 2000 * (M // 2)])
    hist = torch.zeros((G, M * 8 - M // 2, 2))
    x_ext = torch.cat([hist, x], dim=1)
    for xe in (x_ext, x_ext.transpose(1, 2).contiguous()):
        ph, cp, pw = K3.analyze_phases(xe, M, 8, 3, 0, torch.bfloat16)
        assert ph.shape[:2] == (G, M) and ph.dtype == torch.bfloat16
        for g in range(G):
            one = K3.analyze_phases_reference(xe[g], M, 8, 3, 0,
                                              torch.bfloat16)
            for a, b in zip((ph[g], cp[g], pw[g]), one):
                assert torch.equal(a, b)


def test_batched_rejects_other_shapes():
    spec = TSpec(num_channels=M)
    with pytest.raises(ValueError, match=r"\(G, N, 2\)"):
        rx_multichannel_block_batched(torch.zeros((M * 100, 2)), spec)
    with pytest.raises(TypeError):
        rx_multichannel_block_batched(np.zeros((2, M * 100, 2)), spec)
