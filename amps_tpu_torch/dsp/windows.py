"""Window functions and GNU Radio ``firdes`` filter design (low-pass,
root raised cosine), the port of ``amps_tpu.dsp.windows`` (numpy,
bit-equal)."""

from __future__ import annotations

import numpy as np

_WINDOW_ATT_DB = {
    "hamming": 53.0,     # GR WIN_HAMMING (firdes default)
    "hann": 44.0,
    "blackman": 74.0,    # GR WIN_BLACKMAN
    "blackman_harris": 92.0,
    "rectangular": 21.0,
}


def _window(kind: str, n: int) -> np.ndarray:
    m = n - 1
    x = np.arange(n)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * x / m)
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * x / m)
    if kind == "blackman":
        return (0.42 - 0.5 * np.cos(2 * np.pi * x / m)
                + 0.08 * np.cos(4 * np.pi * x / m))
    if kind == "blackman_harris":
        return (0.35875 - 0.48829 * np.cos(2 * np.pi * x / m)
                + 0.14128 * np.cos(4 * np.pi * x / m)
                - 0.01168 * np.cos(6 * np.pi * x / m))
    if kind == "rectangular":
        return np.ones(n)
    raise ValueError(f"unknown window {kind}")


def compute_ntaps(fs: float, transition: float, window: str) -> int:
    """GR's tap count: the window's attenuation over 22 * transition/fs,
    forced odd."""
    ntaps = int(_WINDOW_ATT_DB[window] / (22.0 * (transition / fs)))
    if (ntaps & 1) == 0:
        ntaps += 1
    return ntaps


def firdes_low_pass(gain: float, fs: float, cutoff: float, transition: float,
                    window: str = "hamming",
                    ntaps: int | None = None) -> np.ndarray:
    """GR firdes.low_pass: windowed sinc at ``cutoff`` Hz, normalized so the
    DC gain equals ``gain``.  Returns float32 taps (odd length)."""
    if ntaps is None:
        ntaps = compute_ntaps(fs, transition, window)
    w = _window(window, ntaps)
    m = (ntaps - 1) // 2
    fwT0 = 2 * np.pi * cutoff / fs
    n = np.arange(ntaps) - m
    safe_n = np.where(n == 0, 1, n)
    taps = np.where(n == 0, fwT0 / np.pi,
                    np.sin(safe_n * fwT0) / (safe_n * np.pi)) * w
    taps = taps * (gain / taps.sum())
    return taps.astype(np.float32)


def firdes_root_raised_cosine(gain, fs, symbol_rate, alpha, ntaps):
    """Root-raised-cosine taps (odd length), designed in float64 and
    normalized to DC gain ``gain``; returns float32."""
    ntaps |= 1
    spb = fs / symbol_rate
    t = (np.arange(ntaps) - ntaps // 2) / spb
    num = (np.sin(np.pi * t * (1 - alpha))
           + 4 * alpha * t * np.cos(np.pi * t * (1 + alpha)))
    den = np.pi * t * (1 - (4 * alpha * t) ** 2)
    h = np.empty(ntaps)
    eps = 1e-9
    ordinary = np.abs(den) > eps
    h[ordinary] = num[ordinary] / den[ordinary]
    h[~ordinary] = 0
    # the limits at t = 0 and |4 alpha t| = 1
    h[np.abs(t) < eps] = 1 - alpha + 4 * alpha / np.pi
    sing = np.abs(np.abs(4 * alpha * t) - 1) < eps
    h[sing] = (alpha / np.sqrt(2)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
    h = h * gain / h.sum()
    return h.astype(np.float32)
