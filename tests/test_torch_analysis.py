"""K1, the analysis channelizer: the port's plain version against the
JAX package's Pallas kernel (interpret mode) and against its analysis
(``fold="bank"``), ``dsp.channelizer.analyze`` over streamed blocks, and
torch models of what the CUDA kernels' FFT tile (``csrc/analysis_fft.cuh``)
computes, on the tables the wrappers hand it: K1's analysis and K4's
synthesis (``csrc/synth.cu``).

Tolerance: atol 2e-4 on inputs of unit variance per component, the
tolerance of ``tests/test_pallas.py`` (f32 transforms that sum in other
orders); the synthesis 1e-4 of its output RMS, the card's tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu.pallas.channelizer_kernel import analyze_chmajor_pallas
from amps_tpu_torch import convert
from amps_tpu_torch.dsp import channelizer as tchz
from amps_tpu_torch.eval.traffic import unit_channel_band
from amps_tpu_torch.kernels import analysis as KA
from amps_tpu_torch.kernels import synth as K4

torch.set_num_threads(1)

ATOL = 2e-4


def _x(n, seed, planar_in=False):
    x = np.random.default_rng(seed).normal(0, 1, (n, 2)).astype(np.float32)
    return np.ascontiguousarray(x.T) if planar_in else x


@pytest.mark.parametrize("M,T", [(8, 4), (8, 8), (128, 4), (128, 8)])
def test_plain_version_matches_pallas_k1(M, T):
    """The plain K1 against the TPU kernel in interpret mode (even parity,
    Nh a multiple of its tile: the TPU kernel's own limits)."""
    P, Nh = M // 2, 128
    x = _x((Nh + 2 * T - 1) * P, seed=M + T)
    want = np.asarray(analyze_chmajor_pallas(x, M, T, 0, tile_h=64,
                                             interpret=True))
    got = KA.analyze_block(torch.as_tensor(x), M, T, 0)
    assert got.shape == want.shape == (M, Nh, 2)
    assert np.abs(got.numpy() - want).max() < ATOL


def test_plain_version_matches_pallas_k1_on_unit_channels():
    """The unit-amplitude band the kernel is checked on at full width
    (zero history, every channel a unit-modulus baseband): the plain K1
    and the TPU kernel in interpret mode agree on it within ATOL, and
    the band is the same for the same seed."""
    M, T, Nh = 128, 8, 128
    x = unit_channel_band(M, T, Nh, 5, device="cpu")
    assert x.shape == ((Nh + 2 * T - 1) * M // 2, 2)
    assert not x[: M * T - M // 2].any()
    assert torch.equal(x, unit_channel_band(M, T, Nh, 5, device="cpu"))
    want = np.asarray(analyze_chmajor_pallas(x.numpy(), M, T, 0, tile_h=64,
                                             interpret=True))
    got = KA.analyze_reference(x, M, T, 0)
    assert np.abs(got.numpy() - want).max() < ATOL


def _jax_state(spec, planar_in, hop_idx, seed):
    L, P = spec.ntaps, spec.hop
    hist = _x(L - P, seed, planar_in)
    return jchz.AnalyzerState(jnp.asarray(hist), hop_idx)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("planar_in,planar", [(False, False), (True, True),
                                              (False, True), (True, False)])
def test_analyze_matches_jax(parity, planar_in, planar):
    """analyze from a carried (random) history at either hop parity, riq
    or planar in and out."""
    M, T, Nh = 16, 8, 301
    jspec, tspec = jchz.ChannelizerSpec(M, T), tchz.ChannelizerSpec(M, T)
    jst = _jax_state(jspec, planar_in, 7 + parity, seed=parity)
    x = _x(Nh * M // 2, seed=11, planar_in=planar_in)
    want, jst2 = jchz.analyze(jnp.asarray(x), jspec, jst, chmajor=True,
                              fold="bank", split=0, planar=planar,
                              planar_in=planar_in)
    tst = convert.analyzer_state_from_numpy(np.asarray(jst.history),
                                            jst.hop_idx, device="cpu")
    got, tst2 = tchz.analyze(torch.as_tensor(x), tspec, tst, planar=planar,
                             planar_in=planar_in, chmajor=True)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < ATOL
    assert tst2.hop_idx == jst2.hop_idx
    assert np.array_equal(tst2.history.numpy(), np.asarray(jst2.history))


def test_two_chained_calls_equal_one():
    """An odd-hop first block flips the parity of the second; together
    they give the one-call planes (the same f32 sums per hop: equal to
    the last bit up to the CPU matmul's blocking, held to 1e-6) and the
    one-call state."""
    M, T = 16, 8
    spec = tchz.ChannelizerSpec(M, T)
    x = torch.as_tensor(_x(700 * M // 2, seed=3))
    n1 = 301 * M // 2
    y, st = tchz.analyze(x, spec, tchz.analyzer_init(spec, device="cpu"),
                         chmajor=True)
    ya, sa = tchz.analyze(x[:n1], spec, tchz.analyzer_init(spec,
                                                           device="cpu"),
                         chmajor=True)
    yb, sb = tchz.analyze(x[n1:], spec, sa, chmajor=True)
    assert sa.hop_idx % 2 == 1
    assert (torch.cat([ya, yb], 1) - y).abs().max().item() < 1e-6
    assert sb.hop_idx == st.hop_idx and torch.equal(sb.history, st.history)


def test_analyze_on_cpu_launches_no_kernel():
    """On a CPU state ``analyze`` runs the plain version (the ``block``
    argument's default and ``analyze_reference`` agree) and launches
    nothing."""
    M, T = 64, 8
    spec = tchz.ChannelizerSpec(M, T)
    x = torch.as_tensor(_x(40 * M // 2, seed=4))
    before = KA.LAUNCHES
    y, _ = tchz.analyze(x, spec, tchz.analyzer_init(spec, device="cpu"),
                        chmajor=True)
    yr, _ = tchz.analyze(x, spec, tchz.analyzer_init(spec, device="cpu"),
                         block=KA.analyze_reference, chmajor=True)
    assert y.shape == (M, 40, 2) and KA.LAUNCHES == before
    assert torch.equal(y, yr)
    assert torch.equal(y, KA.analyze_reference(
        torch.cat([torch.zeros((M * T - M // 2, 2)), x]), M, T))


def test_analyzer_init_defaults_to_the_card(monkeypatch):
    """The entry points' states live on the current CUDA device unless the
    CPU is named; without CUDA the default raises."""
    spec = tchz.ChannelizerSpec(16, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tchz.analyzer_init(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tchz.synthesizer_init(spec)
    assert tchz.analyzer_init(spec, device="cpu").history.device.type == "cpu"


def _w16_powers(c):
    """W_16^e, e < 16, from the table's head c = (W_16^1, W_16^2, W_16^3):
    the quarter turns are exact (-i, -1, i)."""
    base = torch.cat([torch.ones(1, dtype=c.dtype), c])        # e = 0 .. 3
    quarter = torch.tensor([1, -1j, -1, 1j], dtype=c.dtype)
    return (quarter[:, None] * base[None, :]).reshape(16)


# where the odd butterflies' constants W_R^1 .. W_R^{(R-1)/2} sit in the
# table's head (csrc fft_head_offset)
_HEAD_OFFSET = {3: 3, 5: 4, 7: 6}


def _dft_matrix(w, R):
    """The R-point DFT matrix W_R^{rk} a register butterfly computes, from
    the table's head: radices 2-16 from W_16's powers, 3, 5 and 7 from
    their W_R^1 .. W_R^{(R-1)/2} and the conjugates past R/2."""
    r = torch.arange(R)
    if R % 2 == 0:
        return _w16_powers(w[:3])[(r[:, None] * r) % R * (16 // R)]
    h = (R - 1) // 2
    c = w[_HEAD_OFFSET[R]: _HEAD_OFFSET[R] + h]
    powers = torch.cat([torch.ones(1, dtype=w.dtype), c, c.flip(0).conj()])
    return powers[(r[:, None] * r) % R]


def _fft_passes(z, M):
    """The tile's Stockham passes on rows z (n, M) complex: the radices of
    ``KA.fft_radices(M)`` on the twiddle table of ``KA._tables``.  A
    register pass's butterfly j reads R values at stride M/R, multiplies
    value r by the table's block entry (r-1)·Ns + j mod Ns, runs its
    R-point DFT and writes at (j/Ns)·Ns·R + j mod Ns + r·Ns; a generic
    pass (a prime >= 11) writes output t = g·N + o, N = Ns·R, as
    sum_r x[g·Ns + o mod Ns + r·M/R] W_M^{(r·o·M/N) mod M}, from the
    table's whole W_M at its end.  Natural order out: the forward DFT of
    each row."""
    tw = KA._tables(M, 1, torch.device("cpu"))[1]
    w = torch.complex(tw[:, 0], tw[:, 1])
    radices = KA.fft_radices(M)
    generic = any(KA.fft_generic(R) for R in radices)
    wm = w[-M:] if generic else None
    ns, off = 1, 3 if M in KA.LIBRARY_WIDTHS else 9
    for p, R in enumerate(radices):
        IH, N = M // R, ns * R
        out = torch.empty_like(z)
        if KA.fft_generic(R):
            t = torch.arange(M)
            o = t % N
            j = (t // N) * ns + o % ns
            r = torch.arange(R)
            e = (r[None, :] * o[:, None] * (M // N)) % M        # (M, R)
            for a in range(0, z.shape[0], 4):                   # rows by 4
                v = z[a: a + 4][:, j[:, None] + r[None, :] * IH]
                out[a: a + 4] = (v * wm[e]).sum(-1)
        else:
            j = torch.arange(IH)[:, None]
            r = torch.arange(R)[None, :]
            v = z[:, j + r * IH]                                # (n, M/R, R)
            if p:
                v[..., 1:] = v[..., 1:] * w[off + (r[:, 1:] - 1) * ns
                                            + j % ns]
                off += (R - 1) * ns
            out[:, (j // ns) * N + j % ns + r * ns] = v @ _dft_matrix(w, R)
        z, ns = out, N
    assert off + (M if generic else 0) == tw.shape[0]
    return z


def _fft_tile_model(x_ext, M, T, parity):
    """The FFT tile's decomposition in torch: the fold of every hop, the
    passes of ``_fft_passes``, natural-order output, then the hop sign.
    Returns (M, Nh, 2)."""
    P = M // 2
    Nh = x_ext.shape[0] // P - (2 * T - 1)
    coef = KA._tables(M, T, torch.device("cpu"))[0]
    idx = (torch.arange(Nh)[:, None, None] * P
           + torch.arange(T)[None, :, None] * M
           + torch.arange(M)[None, None, :])
    f = (coef[None, :, :, None] * x_ext[idx]).sum(1)            # (Nh, M, 2)
    z = _fft_passes(torch.complex(f[..., 0], f[..., 1]), M)
    odd = ((torch.arange(M)[:, None] % 2)
           * ((torch.arange(Nh)[None, :] + parity) % 2)).bool()
    y = torch.where(odd, -z.T, z.T)
    return torch.stack([y.real, y.imag], dim=-1)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("M", [64, 256, 1024])
def test_fft_tile_model_matches_plain_version_and_jax(M, parity):
    """The decomposition the CUDA kernels are handed (fold, the FFT on
    the wrapper's twiddle table and radices, natural order, hop sign)
    against the plain K1 and the JAX bank analysis, on unit-amplitude
    channels: a table, index or sign fault shows up here, before the
    card.  atol 2e-4 (f32 transforms that sum in other orders)."""
    T, Nh = 8, 300
    x = unit_channel_band(M, T, Nh, M + parity, device="cpu")
    got = _fft_tile_model(x, M, T, parity)
    want = KA.analyze_reference(x, M, T, parity)
    assert got.shape == want.shape == (M, Nh, 2)
    assert (got - want).abs().max().item() < ATOL
    jax_y = np.asarray(jchz._analyze_block_chmajor(
        jnp.asarray(x.numpy()), jnp.asarray(jchz.prototype_taps(M, T)), M, T,
        jnp.int32(parity), fold="bank"))
    assert np.abs(got.numpy() - jax_y).max() < ATOL


MIXED_WIDTHS = [24, 96, 160, 210, 448, 682, 768, 1000, 1458, 1536, 2038]


@pytest.mark.parametrize("M", MIXED_WIDTHS)
def test_mixed_radix_model_matches_numpy_and_jax(M):
    """The tile's passes at widths that are not powers of two -- radices
    3, 5 and 7 in registers (24 = 8·3, 160 = 32·5, 448 = 64·7, 210 =
    2·3·5·7), long plans (1000 = 8·5³, 1458 = 2·3⁶), the generic prime
    pass (682 = 2·11·31, 2038 = 2·1019) and the station's widths (96,
    768, 1536) -- on the wrapper's radices and twiddle table: random
    rows against numpy.fft, and the whole tile model (fold, passes, hop
    sign) against the JAX bank analysis on unit-amplitude channels, each
    within 1e-5 of the largest output."""
    rng = np.random.default_rng(M)
    z = rng.normal(0, 1, (6, M)) + 1j * rng.normal(0, 1, (6, M))
    got = _fft_passes(torch.as_tensor(z.astype(np.complex64)), M).numpy()
    want = np.fft.fft(z, axis=-1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    T, Nh = 8, 12
    x = unit_channel_band(M, T, Nh, M, device="cpu")
    y = _fft_tile_model(x, M, T, 1).numpy()
    jax_y = np.asarray(jchz._analyze_block_chmajor(
        jnp.asarray(x.numpy()), jnp.asarray(jchz.prototype_taps(M, T)), M, T,
        jnp.int32(1), fold="bank"))
    assert np.abs(y - jax_y).max() <= 1e-5 * np.abs(jax_y).max()


def _synth_model(Y, M, T, parity, carry, blocks):
    """K4's decomposition in torch (csrc/synth.cu): the tile's forward FFT
    of each raw hop row F_h, read as u_h[m] = F_h[(-m - P·odd_h) mod M];
    the output hops [0, Nh + 2T - 1) split into ranges of R (for a grid
    of ``blocks``, at least a pass of FFT_WIDE_HOPS[M]), each walked from
    2T-1 hops before it (the halo, zero rows outside [0, Nh)) with a ring
    of 2·MT running sums per column: hop h adds gP[jP + p]·u_h[(j&1)P + p]
    into the sum of hop h + j, then hop h leaves (+ the carry-in below
    2T-1) and the ring shifts.  Returns (x (Nh·P, 2), carry)."""
    P, Nh, keep = M // 2, Y.shape[0], 2 * T - 1
    ring = 16 if T <= 8 else 32
    F = _fft_passes(torch.complex(Y[..., 0], Y[..., 1]), M)
    m = torch.arange(M)
    g = torch.zeros((ring, P))
    g[:2 * T] = K4._gain_taps(M, T, torch.device("cpu")).reshape(2 * T, P)
    cin = torch.complex(carry[:, 0], carry[:, 1]).reshape(keep, P)
    NO = Nh + keep
    R = max(-(-NO // blocks), KA.FFT_WIDE_HOPS[M])
    out = torch.full((NO, P), complex("nan"), dtype=torch.complex64)
    for o0 in range(0, NO, R):
        o1 = min(o0 + R, NO)
        acc = torch.zeros((ring, P), dtype=torch.complex64)
        for h in range(o0 - keep, o1):
            if 0 <= h < Nh:
                odd = (h + parity) % 2
                u = F[h][(-m - P * odd) % M]
                acc = acc + g * torch.where(
                    (torch.arange(ring) % 2 == 1)[:, None], u[P:], u[:P])
            if h >= o0:
                out[h] = acc[0] + (cin[h] if h < keep else 0)
            acc = torch.cat([acc[1:], torch.zeros((1, P), dtype=acc.dtype)])
    x = torch.stack([out.real, out.imag], dim=-1).reshape(NO * P, 2)
    return x[: Nh * P], x[Nh * P:]


@pytest.mark.parametrize("M,parity,Nh,blocks", [
    (64, 0, 300, 7), (64, 1, 3, 132), (256, 1, 161, 4), (256, 0, 3, 1),
    (1024, 0, 97, 3), (1024, 1, 50, 132)])
def test_synth_model_matches_plain_version_and_jax(M, parity, Nh, blocks):
    """The decomposition K4 is handed (the forward FFT read by index, the
    register-ring overlap-add in the kernel's order, block ranges with
    their halo, carry in and out) against the plain K4 and JAX's
    ``_synthesize_block``, at 1e-4 of the output RMS.  Nh = 3 is fewer
    hops than the carry holds; the ranges are ragged."""
    T = 8
    rng = np.random.default_rng(M + Nh)
    Y = rng.normal(0, 1, (Nh, M, 2)).astype(np.float32)
    carry = rng.normal(0, 1, (M * T - M // 2, 2)).astype(np.float32)
    x, c = _synth_model(torch.as_tensor(Y), M, T, parity,
                        torch.as_tensor(carry), blocks)
    rx, rc = K4.synthesize_block_reference(torch.as_tensor(Y), M, T, parity,
                                           torch.as_tensor(carry))
    jx, jc = jchz._synthesize_block(
        jnp.asarray(Y), jnp.asarray(jchz.prototype_taps(M, T)), M, T,
        jnp.int32(parity), jnp.asarray(carry), False, 0)
    rms = rx.pow(2).mean().sqrt().item()
    assert x.shape == rx.shape and c.shape == rc.shape
    for got in (x, c):
        assert torch.isfinite(got).all()
    assert (x - rx).abs().max().item() <= 1e-4 * rms
    assert (c - rc).abs().max().item() <= 1e-4 * rms
    assert np.abs(x.numpy() - np.asarray(jx)).max() <= 1e-4 * rms
    assert np.abs(c.numpy() - np.asarray(jc)).max() <= 1e-4 * rms
