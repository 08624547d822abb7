"""The slice end to end: the port's rx_multichannel_block (CPU tensors,
so stages 1-3 take the kernel's plain version) against the JAX
package's on planted-burst traffic.

starts, valid, word_ok and dcc_bits are held exactly equal on every
slot.  A noise-only slot's capture is noise sliced against its own mean,
which two correct f32 summation orders resolve differently at the
threshold, so words and bad_symbols are held exactly equal on the valid
(burst) slots."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.eval.traffic import MobileEvent, synthesize_reverse_band
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu.parallel.pipeline import rx_multichannel_block as jrx
from amps_tpu_torch.eval import traffic as ttraffic
from amps_tpu_torch.parallel.pipeline import MultichannelSpec as TSpec
from amps_tpu_torch.parallel.pipeline import rx_multichannel_block as trx

torch.set_num_threads(1)

TOTAL_HOPS = 12500
EXACT_KEYS = ("starts", "valid", "word_ok", "dcc_bits")
VALID_SLOT_KEYS = ("words", "bad_symbols")


def _events(M):
    return [MobileEvent("origination", 0, 300, "5551234567", "7025551000",
                        esn=99),
            MobileEvent("page_response", M - 1, 900, "4155559876"),
            MobileEvent("registration", M // 2 + 1, 1500, "2125550000",
                        esn=7)]


@functools.cache
def _traffic(M):
    spec = JSpec(num_channels=M, taps_per_phase=8, fold="bank")
    events = _events(M)
    x = synthesize_reverse_band(events, spec, TOTAL_HOPS, noise_sigma=0.001)
    return np.asarray(x), events


def _specs(M, bf16):
    kw = dict(num_channels=M, taps_per_phase=8, fold="bank",
              io_bf16=bf16, corr_bf16=bf16)
    return JSpec(**kw), TSpec(**kw)


@pytest.mark.parametrize("M", [32, 64])
def test_traffic_matches_jax(M):
    x, events = _traffic(M)
    tev = [ttraffic.BurstEvent(e.channel, e.start_hop, np.stack(e.words()))
           for e in events]
    got = ttraffic.synthesize_reverse_band(tev, TSpec(num_channels=M),
                                           TOTAL_HOPS, noise_sigma=0.001,
                                           device="cpu")
    assert got.shape == x.shape
    assert np.abs(got.numpy() - x).max() < 1e-5


@pytest.mark.parametrize("M", [32, 64])
def test_rx_block_f32_matches_jax(M):
    x, events = _traffic(M)
    jspec, tspec = _specs(M, False)
    want = jax.device_get(jrx(jnp.asarray(x), jspec, max_bursts=2,
                              threshold=0.55))
    got = {k: v.numpy() for k, v in
           trx(torch.as_tensor(x), tspec, max_bursts=2).items()}
    assert set(got) == set(want)
    valid = np.asarray(want["valid"])
    assert np.array_equal(got["valid"], valid)
    planted = np.zeros_like(valid)
    for ev in events:
        planted[ev.channel, 0] = True
    assert np.array_equal(valid, planted)
    for k in EXACT_KEYS + VALID_SLOT_KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if k in EXACT_KEYS:
            assert np.array_equal(got[k], w), k
        else:
            assert np.array_equal(got[k][valid], w[valid]), k
    np.testing.assert_allclose(got["quality"][valid],
                               np.asarray(want["quality"])[valid], atol=1e-4)
    np.testing.assert_allclose(got["rssi"][valid],
                               np.asarray(want["rssi"])[valid], rtol=1e-4)
    np.testing.assert_allclose(got["chan_power"],
                               np.asarray(want["chan_power"]), rtol=1e-4)
    for ev in events:
        w = np.stack(ev.words())
        assert np.array_equal(got["words"][ev.channel, 0, :len(w)], w)


@pytest.mark.parametrize("M", [32, 64])
def test_rx_block_bf16_decodes_same_words(M):
    """io_bf16 + corr_bf16: bf16 rounds at other places in the two
    packages (the kernel path rounds only the phase streams), so argmax
    ties may move starts; the decoded words of valid bursts agree and
    are the planted ones."""
    x, events = _traffic(M)
    jspec, tspec = _specs(M, True)
    want = jax.device_get(jrx(jnp.asarray(x), jspec, max_bursts=2,
                              threshold=0.55))
    got = trx(torch.as_tensor(x), tspec, max_bursts=2)
    valid = got["valid"].numpy()
    assert np.array_equal(valid, np.asarray(want["valid"]))
    words = got["words"].numpy()
    assert np.array_equal(words[valid], np.asarray(want["words"])[valid])
    for ev in events:
        w = np.stack(ev.words())
        assert valid[ev.channel, 0]
        assert got["word_ok"].numpy()[ev.channel, 0, :len(w)].all()
        assert np.array_equal(words[ev.channel, 0, :len(w)], w)


def test_rx_block_search_argument():
    """The block's search argument is its trigger search, called once
    with the block's K and threshold; the plain search gives the
    default block's planes."""
    from amps_tpu_torch.kernels.rx_phases import analyze_phases
    from amps_tpu_torch.parallel.pipeline import _rx_block
    from amps_tpu_torch.rx.correlator import find_bursts_phases_reference
    x, _ = _traffic(32)
    _, tspec = _specs(32, True)
    calls = []

    def search(phases, sps, max_bursts, threshold, **kw):
        calls.append((max_bursts, threshold))
        return find_bursts_phases_reference(phases, sps, max_bursts,
                                            threshold, **kw)

    xt = torch.as_tensor(x)
    got = _rx_block(xt, tspec, 3, 0.5, "first_ok", analyze_phases, search)
    assert calls == [(3, 0.5)]
    want = trx(xt, tspec, max_bursts=3, threshold=0.5)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_rx_block_planar_input_is_identical():
    x, _ = _traffic(32)
    _, tspec = _specs(32, False)
    a = trx(torch.as_tensor(x), tspec)
    b = trx(torch.as_tensor(np.ascontiguousarray(x.T)), tspec)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_rx_block_rejects_other_folds():
    """Every fold name of the JAX package is taken (below); any other
    name raises."""
    with pytest.raises(ValueError, match="unknown fold"):
        trx(torch.zeros((32 * 16, 2)), TSpec(num_channels=32, fold="fft"))


@pytest.mark.parametrize("fold", [None, "conv", "shift", "bank", "bank2",
                                  "bankp"])
def test_rx_block_every_fold_matches_jax(fold):
    """The default spec (fold None here: the dataclass default, "conv")
    and every fold name, against the JAX block run with that same fold,
    at the tolerances the bank fold meets above: the folds differ only
    in f32 summation order, and the port computes the bank fold for
    all."""
    M = 32
    x, events = _traffic(M)
    kw = dict(num_channels=M, taps_per_phase=8)
    if fold is not None:
        kw["fold"] = fold
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    assert tspec.fold == jspec.fold == (fold or "conv")
    want = jax.device_get(jrx(jnp.asarray(x), jspec, max_bursts=2,
                              threshold=0.55))
    got = {k: v.numpy() for k, v in
           trx(torch.as_tensor(x), tspec, max_bursts=2).items()}
    valid = np.asarray(want["valid"])
    assert valid.sum() == len(events)
    for k in EXACT_KEYS:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    for k in VALID_SLOT_KEYS:
        assert np.array_equal(got[k][valid], np.asarray(want[k])[valid]), k
    np.testing.assert_allclose(got["quality"][valid],
                               np.asarray(want["quality"])[valid], atol=1e-4)
    np.testing.assert_allclose(got["rssi"][valid],
                               np.asarray(want["rssi"])[valid], rtol=1e-4)
    np.testing.assert_allclose(got["chan_power"],
                               np.asarray(want["chan_power"]), rtol=1e-4)
