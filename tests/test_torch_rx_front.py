"""The streaming front end's plain version (the path a CPU tensor takes)
against the JAX Pallas kernel K2 in interpret mode and against the JAX
XLA chain of the streaming receiver (analysis -> quadrature_demod_planar
with the carried previous sample); chaining; the wrapper's device
rules.  The CUDA kernel is held to its plain version on the card in
test_torch_cuda.py.

Branch-cut rule: two correct f32 computations that sum in different
orders can put a noise sample on opposite sides of ±π; on random-noise
input at most 1e-5 of the demod samples may fall outside the
tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp.fm import quadrature_demod_planar as jdemod
from amps_tpu_torch.kernels import rx_front as K

torch.set_num_threads(1)

BRANCH_CUT_FRACTION = 1e-5


def _x_ext(M, T, Nh, seed, sigma=0.5):
    P = M // 2
    rng = np.random.default_rng(seed)
    x = rng.normal(0, sigma, (Nh * P, 2)).astype(np.float32)
    return np.concatenate([np.zeros((M * T - P, 2), np.float32), x])


def _prev(M, seed):
    return np.random.default_rng(seed).normal(0, 0.5, (M, 2)).astype(
        np.float32)


def test_plain_version_matches_pallas_k2_interpret():
    """K2 at its test geometry (tests/test_pallas.py): bf16 demod,
    block-mean power, hop -1 = 0."""
    from amps_tpu.pallas.rx_front_kernel import analyze_demod_pallas
    M, T, Nh = 256, 4, 256
    x = _x_ext(M, T, Nh, 2, sigma=1.0)
    want_d, want_p = analyze_demod_pallas(jnp.asarray(x), M, T, tile_h=128,
                                          interpret=True)
    d, _, pw = K.analyze_demod_reference(torch.as_tensor(x), M, T, 0,
                                         torch.zeros((M, 2)))
    assert d.shape == (M, Nh) and pw.shape == (M, Nh)
    err = np.abs(d.numpy() - np.asarray(want_d, np.float32))
    assert err.max() < 0.03           # bf16 quantization of ±π
    power = torch.sqrt(pw.mean(dim=-1)).numpy()
    np.testing.assert_allclose(power, np.asarray(want_p), rtol=1e-3)


@pytest.mark.parametrize("M,T,Nh,parity,planar", [
    (64, 8, 700, 0, False),
    (32, 4, 333, 1, False),
    (64, 8, 700, 1, True),
])
def test_plain_version_matches_jax_xla_chain(M, T, Nh, parity, planar):
    x = _x_ext(M, T, Nh, M + Nh)
    prev = _prev(M, Nh)
    ypl = jchz._analyze_block_chmajor(
        jnp.asarray(x), jnp.asarray(jchz.prototype_taps(M, T)), M, T,
        jnp.int32(parity), fold="bank", planar=True)
    wd, (wr, wi), wp = jdemod(ypl[0], ypl[1], 1.0,
                              (jnp.asarray(prev[:, 0]),
                               jnp.asarray(prev[:, 1])),
                              return_power="series")
    xt = torch.as_tensor(np.ascontiguousarray(x.T) if planar else x)
    d, last, pw = K.analyze_demod_reference(xt, M, T, parity,
                                            torch.as_tensor(prev))
    assert d.dtype == torch.float32 and d.shape == (M, Nh)
    err = np.abs(d.numpy() - np.asarray(wd))
    assert (err > 1e-4).sum() <= int(BRANCH_CUT_FRACTION * err.size) + 1
    np.testing.assert_allclose(pw.numpy(), np.asarray(wp), rtol=1e-3,
                               atol=1e-6)
    want_last = np.stack([np.asarray(wr), np.asarray(wi)], -1)
    np.testing.assert_allclose(last.numpy(), want_last, atol=1e-5)


def test_two_chained_calls_equal_one():
    """The second block's hop -1 is the first block's `last`: chaining
    reproduces one call on the joined input."""
    M, T = 64, 8
    P = M // 2
    N1, N2 = 401, 300
    x = torch.as_tensor(_x_ext(M, T, N1 + N2, 5))
    zero = torch.zeros((M, 2))
    d, last, pw = K.analyze_demod_reference(x, M, T, 0, zero)
    da, la, pa = K.analyze_demod_reference(x[: (N1 + 2 * T - 1) * P], M, T,
                                           0, zero)
    db, lb, pb = K.analyze_demod_reference(x[N1 * P:], M, T, N1 % 2, la)
    assert torch.equal(torch.cat([da, db], dim=1), d)
    assert torch.equal(torch.cat([pa, pb], dim=1), pw)
    assert torch.equal(lb, last)


def test_wrapper_cpu_tensor_takes_plain_version():
    M, T, Nh = 64, 4, 300
    x = torch.as_tensor(_x_ext(M, T, Nh, 9))
    prev = torch.as_tensor(_prev(M, 1))
    before = K.LAUNCHES
    got = K.analyze_demod(x, M, T, 1, prev)
    want = K.analyze_demod_reference(x, M, T, 1, prev)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert K.LAUNCHES == before


def test_wrapper_rejects_what_it_cannot_run():
    M, T = 64, 8
    x = torch.zeros(((100 + 2 * T - 1) * M // 2, 2))
    prev = torch.zeros((M, 2))
    with pytest.raises(ValueError):
        K.analyze_demod(x.to("meta"), M, T, 0, prev.to("meta"))
    with pytest.raises(TypeError):
        K.analyze_demod(x.numpy(), M, T, 0, prev)
    with pytest.raises(ValueError):
        K.analyze_demod_reference(x, M, T, 0, torch.zeros((M, 3)))
    with pytest.raises(ValueError):
        K.analyze_demod_reference(x[:-1], M, T, 0, prev)
