"""The port's FIR building blocks (``dsp.fir``) against the JAX
package's on seeded inputs, streaming state included, and the checks of
tests/test_dsp.py on the port.  Filters are float32 sums of up to ~270
products in library-chosen orders: 2e-5 absolute on unit-scale data."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import fir as jfir
from amps_tpu_torch.dsp import fir as tfir
from amps_tpu_torch.dsp.windows import firdes_low_pass
from amps_tpu_torch.rx.frontend import rx_lpf_taps

torch.set_num_threads(1)

ATOL = 2e-5
TAPS = firdes_low_pass(1.0, 400e3, 10e3, 5e3)       # 291 taps


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= atol


@pytest.mark.parametrize("decim", [1, 2, 5])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_fir_filter_matches_jax_and_streams(decim, batch):
    rng = np.random.default_rng(decim)
    x = rng.normal(0, 1, batch + (2000,)).astype(np.float32)
    want, wh = jfir.fir_filter(jnp.asarray(x), TAPS, decim)
    got, gh = tfir.fir_filter(torch.as_tensor(x), TAPS, decim)
    _close(got, want)
    _close(gh, wh, 0)
    # two chained blocks equal one (tests/test_dsp.py's streaming check)
    a, h = tfir.fir_filter(x[..., :1000], TAPS, decim)
    b, h2 = tfir.fir_filter(x[..., 1000:], TAPS, decim, h)
    assert torch.equal(h2, gh)
    assert (torch.cat([a, b], -1) - got).abs().max() <= 1e-6
    # and continue from the JAX package's history
    _, jh = jfir.fir_filter(jnp.asarray(x[..., :1000]), TAPS, decim)
    b2, _ = tfir.fir_filter(x[..., 1000:], TAPS, decim, np.asarray(jh))
    assert torch.equal(b2, b)


def test_fir_filter_iq_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 1500, 2)).astype(np.float32)
    h0 = rng.normal(0, 1, (2, len(TAPS) - 1, 2)).astype(np.float32)
    want, wh = jfir.fir_filter_iq(jnp.asarray(x), TAPS, 2, jnp.asarray(h0))
    got, gh = tfir.fir_filter_iq(torch.as_tensor(x), TAPS, 2, h0)
    _close(got, want)
    _close(gh, wh, 0)


@pytest.mark.parametrize("phase_idx0", [0, 12345])
def test_freq_xlating_fir_matches_jax(phase_idx0):
    rng = np.random.default_rng(phase_idx0 + 1)
    x = rng.normal(0, 1, (3000, 2)).astype(np.float32)
    taps = rx_lpf_taps()
    want, wh, wn = jfir.freq_xlating_fir(jnp.asarray(x), taps, -160e3, 400e3,
                                         2, phase_idx0=phase_idx0)
    got, gh, gn = tfir.freq_xlating_fir(torch.as_tensor(x), taps, -160e3,
                                        400e3, 2, phase_idx0=phase_idx0)
    assert gn == wn == phase_idx0 + 3000
    # gain-3 taps, and the mixer's f32 phase (up to ~4e4 rad) goes
    # through two cos/sin implementations
    _close(got, want, 1e-4)
    _close(gh, wh, 1e-4)


def test_freq_xlating_recovers_offset_signal():
    """tests/test_dsp.py: a tone 3 kHz off a -160 kHz carrier comes out
    at 3 kHz after translation and decimation."""
    fs, n = 400e3, 8000
    t = np.arange(n) / fs
    ph = 2 * np.pi * (-160e3 + 3e3) * t
    x = np.stack([np.cos(ph), np.sin(ph)], -1).astype(np.float32)
    y, _, _ = tfir.freq_xlating_fir(x, rx_lpf_taps(), -160e3, fs, 2)
    z = (y[500:, 0] + 1j * y[500:, 1]).numpy()
    f = np.angle(np.sum(z[1:] * np.conj(z[:-1]))) * (fs / 2) / (2 * np.pi)
    assert abs(f - 3e3) < 5.0
    assert abs(np.abs(z).mean() - 3.0) < 0.05       # the taps' gain


def test_streaming_freq_xlating_phase_continuity():
    """tests/test_dsp.py: two chained calls, with the carried history
    and phase index, equal one call."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4000, 2)).astype(np.float32)
    taps = rx_lpf_taps()
    y, _, _ = tfir.freq_xlating_fir(x, taps, -160e3, 400e3, 2)
    a, h, nxt = tfir.freq_xlating_fir(x[:1600], taps, -160e3, 400e3, 2)
    b, _, end = tfir.freq_xlating_fir(x[1600:], taps, -160e3, 400e3, 2, h,
                                      nxt)
    assert (nxt, end) == (1600, 4000)
    assert (torch.cat([a, b]) - y).abs().max() <= 1e-5


@pytest.mark.parametrize("interp", [4, 15])
def test_polyphase_interpolate_iq_matches_jax(interp):
    rng = np.random.default_rng(interp)
    x = rng.normal(0, 1, (2, 700, 2)).astype(np.float32)
    want, wh = jfir.polyphase_interpolate_iq(jnp.asarray(x), TAPS, interp)
    got, gh = tfir.polyphase_interpolate_iq(torch.as_tensor(x), TAPS, interp)
    _close(got, want)
    _close(gh, wh, 0)
    a, h = tfir.polyphase_interpolate_iq(x[:, :300], TAPS, interp)
    b, _ = tfir.polyphase_interpolate_iq(x[:, 300:], TAPS, interp, h)
    assert (torch.cat([a, b], 1) - got).abs().max() <= 1e-6
    want_b, _ = jfir.polyphase_interpolate_iq(jnp.asarray(x[:, 300:]), TAPS,
                                              interp, jnp.asarray(h.numpy()))
    _close(b, want_b)
