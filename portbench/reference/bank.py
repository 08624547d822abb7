"""The reference's ratio-2 oversampled polyphase bank, in float64.

M channels on a grid of fs/M, hops of P = M/2 samples, a prototype
lowpass of L = M·T taps: a windowed sinc of cutoff 1/(2M), under a
4-term Blackman-Harris window, scaled to unity gain at DC.

Channel k at stream hop j is referred to absolute stream time: with
x[a] the wideband stream (zero before a = 0),

    y_k[j] = sum_{i<L} h[L-1-i] x[a0+i] e^{-j2πk(a0+i)/M},  a0 = (j+1-2T)·P,

so hop j's window ends at sample (j+1)P - 1.  Since a0 ≡ P (mod M) the
sum is a fold of the window into M points and one M-point FFT, times
(-1)^{k(j+1)}.  A constant phase of a channel is a convention; the
discriminator and the power below do not see it.

The discriminator: z[j] = y[j]·conj(y[j-1]), d[j] = arg z[j], pw[j] =
|z[j]|².  The configurations state the discriminator's arg as the
system computes it: the octant-reduced ratio through the first four odd
terms of Abramowitz & Stegun 4.4.49 (``ATAN_POLY``).  Without the
fifth term (0.0208351 x⁹) it departs from the exact arctangent by up to
0.0208 rad at 45°, where its two branches meet 0.0417 rad apart; the
reference computes the stated function, in float64, and says which
samples lie so near a branch's edge that rounding decides their branch.
"""

from __future__ import annotations

import numpy as np
import torch


def prototype(M: int, T: int) -> np.ndarray:
    """(M·T,) float64 prototype taps: windowed sinc, cutoff 1/(2M),
    symmetric Blackman-Harris window, unit sum."""
    n = M * T
    t = np.arange(n) - (n - 1) / 2
    sinc = np.sinc(t / M)                       # sin(π t/M) / (π t/M)
    u = 2 * np.pi * np.arange(n) / (n - 1)
    w = (0.35875 - 0.48829 * np.cos(u) + 0.14128 * np.cos(2 * u)
         - 0.01168 * np.cos(3 * u))
    h = sinc * w
    return h / h.sum()


def _bf16(z: torch.Tensor) -> torch.Tensor:
    """A complex tensor with each component rounded to bfloat16."""
    return torch.complex(z.real.to(torch.bfloat16).to(z.real.dtype),
                         z.imag.to(torch.bfloat16).to(z.imag.dtype))


def analyze(blocks, M: int, T: int, j0: int, j1: int, rows=None,
            device=None, precision: str = "f64", chunk: int = 0):
    """Channel outputs y (len(rows) or M, j1 - j0) complex128 of stream
    hops j0 .. j1-1.  ``blocks(b0, b1)`` returns the stream's P-sample
    blocks b0 .. b1-1 as a (b1 - b0, P) complex128 tensor on ``device``
    (zeros before the stream starts).  ``rows``: the channels to keep
    (all when None).  ``precision="bf16"`` rounds the input, the taps,
    the folded windows and the transform's output to bfloat16: the
    lower-precision control of a float32 front end."""
    P = M // 2
    h = torch.as_tensor(prototype(M, T)[::-1].copy(), device=device)
    low = precision == "bf16"
    if low:
        h = h.to(torch.bfloat16).to(torch.float64)
    hr = h.reshape(2 * T, P)          # hr[2t+e, q] = h[L-1-(tM+eP+q)]
    if rows is not None:
        rows = torch.as_tensor(rows, dtype=torch.int64, device=device)
    step = chunk or max(1, (1 << 24) // M)
    out = []
    for a in range(j0, j1, step):
        b = min(j1, a + step)
        nh = b - a
        blk = blocks(a + 1 - 2 * T, b)          # (nh + 2T - 1, P)
        if low:
            blk = _bf16(blk)
        f = torch.zeros((nh, M), dtype=torch.complex128, device=device)
        for t in range(T):
            for e in range(2):
                f[:, e * P:(e + 1) * P] += hr[2 * t + e] * \
                    blk[2 * t + e: 2 * t + e + nh]
        if low:
            f = _bf16(f)
        y = torch.fft.fft(f, dim=-1)
        del f
        k_odd = torch.arange(M, device=device) % 2
        j_odd = (torch.arange(a, b, device=device) + 1) % 2
        y = y * (1 - 2 * (j_odd[:, None] * k_odd[None, :])).to(y.real.dtype)
        if low:
            y = _bf16(y)
        y = y.t()
        out.append(y[rows] if rows is not None else y)
    return torch.cat(out, dim=-1)


# arctan(u) on [0, 1] as the configurations state it: A&S 4.4.49's
# first four odd coefficients
ATAN_POLY = (0.999866, -0.3302995, 0.180141, -0.085133)


def poly_arg(im: torch.Tensor, re: torch.Tensor) -> torch.Tensor:
    """arg(re + j·im) with ``ATAN_POLY`` on the octant-reduced ratio;
    arg(0) = 0."""
    ax, ay = re.abs(), im.abs()
    u = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay),
                                            min=1e-300)
    u2 = u * u
    a, b, c, d = ATAN_POLY
    base = u * (a + u2 * (b + u2 * (c + u2 * d)))
    base = torch.where(ay > ax, np.pi / 2 - base, base)
    base = torch.where(re < 0, np.pi - base, base)
    return torch.where(im < 0, -base, base)


# ``poly_arg``'s two branches meet at |re| = |im| 0.0417 rad apart (the
# missing fifth term twice): a product this close to the diagonal, in
# parts of its size, takes either branch by rounding alone
BRANCH_MARGIN = 1e-4


def discriminate(y: torch.Tensor, y_prev: torch.Tensor,
                 settled: bool = False):
    """(demod, power) float64 of channel outputs y (..., n) with the
    sample before them ``y_prev`` (...,): d = arg(y[j] conj(y[j-1]))
    by ``poly_arg``, pw = |y[j] conj(y[j-1])|²; with ``settled`` also
    the mask of the samples whose arg no rounding moves to the other
    branch (``BRANCH_MARGIN``)."""
    prev = torch.cat([y_prev[..., None], y[..., :-1]], dim=-1)
    z = y * prev.conj()
    d, pw = poly_arg(z.imag, z.real), z.real ** 2 + z.imag ** 2
    if not settled:
        return d, pw
    a, b = z.real.abs(), z.imag.abs()
    return d, pw, (a - b).abs() > BRANCH_MARGIN * (a + b)


def synthesize(Y: torch.Tensor, M: int, T: int, parity: int = 0,
               precision: str = "f64") -> torch.Tensor:
    """The bank's synthesis of hop-major channel basebands Y (n + 2T - 1,
    M) complex (the first 2T - 1 hops the history): (n·P,) complex
    wideband samples x[bP + q] = sum_t g[tP + q] U[b - t, q + P(b mod 2)]
    for the n hops after the history, with U[n] = sum_k Y_k[n]
    e^{+j2πkm/M} and g the prototype: channel k modulated to absolute
    time, so that ``analyze`` reads Y_k back in channel k, delayed and
    scaled by 1/P.  ``parity``: that of the first output hop's index.
    ``precision="bf16"`` rounds the basebands, the taps, the transform
    and the output to bfloat16 (the control of a float32 synthesis)."""
    P = M // 2
    n = Y.shape[0] - (2 * T - 1)
    rdt = Y.real.dtype
    low = precision == "bf16"
    g = torch.as_tensor(prototype(M, T), dtype=rdt,
                        device=Y.device).reshape(2 * T, P)
    if low:
        Y, g = _bf16(Y), g.to(torch.bfloat16).to(rdt)
    U = torch.fft.ifft(Y, dim=-1, norm="forward").reshape(Y.shape[0], 2, P)
    if low:
        U = _bf16(U)
    x = torch.zeros((n, P), dtype=Y.dtype, device=Y.device)
    par = (torch.arange(n, device=Y.device) + parity) % 2
    for t in range(2 * T):
        rows = torch.arange(n, device=Y.device) + (2 * T - 1) - t
        x += g[t] * U[rows, par]
    return (_bf16(x) if low else x).reshape(-1)
