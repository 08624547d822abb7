"""The port's link-quality harness (``amps_tpu_torch.eval.ber``) on the
CPU.  Its noise comes from a torch Generator, so its rates cannot be
compared draw for draw with the JAX curves (``jax.random``); the shared
receive tail ``_rx_trials`` is held against the JAX one on the same
numpy-noise IQ instead, and the curves against the JAX tests' bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amps_tpu.eval import ber as jber
from amps_tpu.eval import channel as jchannel
from amps_tpu_torch.eval import ber
from amps_tpu_torch.eval import channel

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,sigma", [((5000, 2), 0.1), ((3, 700, 2), 1.5),
                                         ((64, 2), 0.0)])
def test_awgn_matches_jax(shape, sigma):
    """The same ``np.random.Generator`` state gives the same noisy array,
    bit for bit, and leaves both generators in the same state."""
    iq = np.random.default_rng(1).normal(0, 1, shape).astype(np.float32)
    rng, jrng = np.random.default_rng(553), np.random.default_rng(553)
    got = channel.awgn(iq, sigma, rng)
    want = jchannel.awgn(iq, sigma, jrng)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert rng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("snr", [20.0, 6.0])
@pytest.mark.parametrize("policy", ["first_ok", "majority"])
def test_rx_trials_match_jax(snr, policy):
    """Same impaired IQ, both receive tails: identical detection and word
    flags."""
    sps, trials = 3, 8
    iq, words = ber._test_burst_iq(sps, "cpu")
    jiq, jwords = jber._test_burst_iq(sps)
    assert np.abs(iq.numpy() - np.asarray(jiq)).max() < 1e-5
    assert np.array_equal(words, np.asarray(jwords))
    sigma = np.sqrt(10.0 ** (-snr / 10.0) / 2.0)
    rng = np.random.default_rng(int(snr))
    noisy = (iq.numpy()[None] + sigma * rng.standard_normal(
        (trials,) + tuple(iq.shape))).astype(np.float32)
    det, good, used = ber._rx_trials(torch.as_tensor(noisy), words, sps,
                                     policy, ber.PRODUCTION_REPEAT_GATE)
    jdet, jgood, jused = jber._rx_trials(
        jnp.asarray(noisy), jnp.asarray(words), sps, policy,
        jber.PRODUCTION_REPEAT_GATE)
    assert np.array_equal(det.numpy(), np.asarray(jdet))
    assert np.array_equal(good.numpy(), np.asarray(jgood))
    assert np.array_equal(used.numpy(), np.asarray(jused))
    assert det.all()


def test_link_curve_monotone_and_sane():
    curve = ber.recc_link_curve([20.0, 6.0, -14.0], trials=16, device="cpu")
    hi, mid, lo = curve[20.0], curve[6.0], curve[-14.0]
    assert hi["detect_rate"] == 1.0
    assert hi["word_success_rate"] == 1.0
    assert mid["detect_rate"] >= 0.9
    assert mid["word_success_rate"] >= 0.9
    assert lo["word_success_rate"] <= 0.25
    assert (hi["word_success_rate"] >= mid["word_success_rate"]
            >= lo["word_success_rate"])


def test_crossover_region_pinned():
    """The JAX tests' crossover bounds (tests/test_ber.py): detection
    crosses over within [0, +3] dB without a cliff, and majority
    combining's gain peaks mid-crossover, at 128 trials."""
    snrs = [3.0, 1.5, 0.0]
    first = ber.recc_link_curve(snrs, trials=128, seed=1, device="cpu")
    maj = ber.recc_link_curve(snrs, trials=128, seed=1, policy="majority",
                              device="cpu")
    assert first[3.0]["detect_rate"] >= 0.85, first[3.0]
    assert 0.45 <= first[1.5]["detect_rate"] <= 0.85, first[1.5]
    assert first[0.0]["detect_rate"] <= 0.30, first[0.0]
    d = [first[s]["detect_rate"] for s in snrs]
    assert all(d[i] - d[i + 1] < 0.65 for i in range(2)), d
    assert d[0] > d[1] > d[2], d
    gain_mid = (maj[1.5]["word_success_rate"]
                - first[1.5]["word_success_rate"])
    gain_floor = (maj[0.0]["word_success_rate"]
                  - first[0.0]["word_success_rate"])
    assert gain_mid >= 0.05, (maj[1.5], first[1.5])
    assert gain_floor <= gain_mid, (gain_floor, gain_mid)
    assert maj[1.5].get("majority_vote_fraction", 0.0) >= 0.5


def test_fading_majority_beats_first_ok():
    maj = ber.recc_fading_curve([10.0], doppler_hz=77.0, trials=48,
                                policy="majority", seed=1,
                                device="cpu")[10.0]
    first = ber.recc_fading_curve([10.0], doppler_hz=77.0, trials=48,
                                  policy="first_ok", seed=1,
                                  device="cpu")[10.0]
    assert maj["detect_rate"] == first["detect_rate"]  # same detections
    assert maj["detect_rate"] > 0.7
    assert maj["word_success_rate"] >= first["word_success_rate"]
    assert maj["word_success_rate"] >= 0.9 * maj["detect_rate"]


def test_curve_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ber.recc_link_curve([20.0], trials=2)
