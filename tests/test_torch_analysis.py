"""K1, the analysis channelizer: the port's plain version against the
JAX package's Pallas kernel (interpret mode) and against its analysis
(``fold="bank"``), ``dsp.channelizer.analyze`` over streamed blocks, and
a torch model of what the CUDA kernels' FFT tile (``csrc/analysis_fft.cuh``)
computes, on the tables the wrapper hands it.

Tolerance: atol 2e-4 on inputs of unit variance per component, the
tolerance of ``tests/test_pallas.py`` (f32 transforms that sum in other
orders)."""

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
                             planar_in=planar_in)
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
    y, st = tchz.analyze(x, spec, tchz.analyzer_init(spec, device="cpu"))
    ya, sa = tchz.analyze(x[:n1], spec, tchz.analyzer_init(spec,
                                                           device="cpu"))
    yb, sb = tchz.analyze(x[n1:], spec, sa)
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
    y, _ = tchz.analyze(x, spec, tchz.analyzer_init(spec, device="cpu"))
    yr, _ = tchz.analyze(x, spec, tchz.analyzer_init(spec, device="cpu"),
                         block=KA.analyze_reference)
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


def _fft_tile_model(x_ext, M, T, parity):
    """The FFT tile's decomposition in torch: the fold of every hop, the
    Stockham passes of ``KA.fft_radices(M)`` on the twiddle table of
    ``KA._tables`` (butterfly j of a pass reads R values at stride M/R,
    multiplies value r by the table's block entry (r-1)·Ns + j mod Ns,
    runs its R-point DFT and writes at (j/Ns)·Ns·R + j mod Ns + r·Ns),
    natural-order output, then the hop sign.  Returns (M, Nh, 2)."""
    P = M // 2
    Nh = x_ext.shape[0] // P - (2 * T - 1)
    coef, tw = KA._tables(M, T, torch.device("cpu"))
    idx = (torch.arange(Nh)[:, None, None] * P
           + torch.arange(T)[None, :, None] * M
           + torch.arange(M)[None, None, :])
    f = (coef[None, :, :, None] * x_ext[idx]).sum(1)            # (Nh, M, 2)
    z = torch.complex(f[..., 0], f[..., 1])
    w = torch.complex(tw[:, 0], tw[:, 1])
    w16 = _w16_powers(w[:3])
    ns, off = 1, 3
    for p, R in enumerate(KA.fft_radices(M)):
        j = torch.arange(M // R)[:, None]
        r = torch.arange(R)[None, :]
        v = z[:, j + r * (M // R)]                              # (Nh, M/R, R)
        if p:
            v[..., 1:] = v[..., 1:] * w[off + (r[:, 1:] - 1) * ns + j % ns]
            off += (R - 1) * ns
        dft = w16[(r.T * r) % R * (16 // R)]                    # W_R^{rk}
        out = torch.empty_like(z)
        out[:, (j // ns) * ns * R + j % ns + r * ns] = v @ dft
        z, ns = out, ns * R
    assert off == tw.shape[0]
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
