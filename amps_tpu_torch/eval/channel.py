"""Channel impairment models for link evaluation (host-side, NumPy), a
copy of ``amps_tpu.eval.channel``.

The reference has no channel model at all -- its only integration test
replays one hardware capture (SURVEY.md §4).  These models let the
loopback harness measure the receiver under the impairments an AMPS
deployment actually sees: AWGN (eval/ber.py) and Rayleigh flat fading
with Doppler (here).

AMPS channels are 30 kHz wide -- far narrower than the coherence
bandwidth of outdoor macro cells (hundreds of kHz), so flat (single-tap)
fading is the physically right model; frequency selectivity across the
band is captured by fading each 30 kHz channel independently.
"""

from __future__ import annotations

import numpy as np


def rayleigh_gain(n: int, fs: float, doppler_hz: float,
                  rng: np.random.Generator, n_paths: int = 64) -> np.ndarray:
    """Clarke/Jakes sum-of-sinusoids Rayleigh fading gain, riq (n, 2).

    Unit mean power.  doppler_hz = v/c * f_carrier (e.g. 835 MHz:
    ~2 Hz walking, ~77 Hz at 100 km/h).
    """
    t = np.arange(n, dtype=np.float64) / fs
    alpha = rng.uniform(0, 2 * np.pi, n_paths)
    phi = rng.uniform(0, 2 * np.pi, n_paths)
    w = 2 * np.pi * doppler_hz * np.cos(alpha)
    ph = np.outer(t, w) + phi                      # (n, n_paths)
    g_i = np.cos(ph).sum(axis=1)
    g_q = np.sin(ph).sum(axis=1)
    g = np.stack([g_i, g_q], axis=-1) / np.sqrt(n_paths)
    return g.astype(np.float32)


def apply_gain(iq: np.ndarray, gain: np.ndarray) -> np.ndarray:
    """Complex multiply riq (n, 2) by riq gain (n, 2)."""
    out = np.empty_like(iq)
    out[:, 0] = iq[:, 0] * gain[:, 0] - iq[:, 1] * gain[:, 1]
    out[:, 1] = iq[:, 0] * gain[:, 1] + iq[:, 1] * gain[:, 0]
    return out


def awgn(iq: np.ndarray, sigma: float, rng: np.random.Generator) -> np.ndarray:
    return iq + rng.normal(0, sigma, iq.shape).astype(np.float32)
