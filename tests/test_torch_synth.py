"""The synthesis kernel's plain version (the path a CPU tensor takes)
against the JAX Pallas kernel K4 in interpret mode and against the JAX
XLA ``_synthesize_block``; the wrapper's device rules.  The CUDA kernel
is held to its plain version on the card in test_torch_cuda.py.
Tolerances: atol 2e-4 against K4 (its test's own, bf16-free f32 MXU
dots in interpret mode); 1e-5 of the output RMS against the XLA chain
(f32 summation order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu_torch.kernels import synth as K

torch.set_num_threads(1)


def _inputs(M, T, Nh, seed):
    rng = np.random.default_rng(seed)
    Y = rng.normal(0, 1, (Nh, M, 2)).astype(np.float32)
    carry = rng.normal(0, 1, (M * T - M // 2, 2)).astype(np.float32)
    return Y, carry


def test_plain_version_matches_pallas_k4_interpret():
    """K4 at its test geometry (tests/test_pallas_synth.py): zero carry,
    even parity, tile 64."""
    from amps_tpu.pallas.synthesizer_kernel import synthesize_pallas
    M, T, Nh = 8, 4, 256
    Y, _ = _inputs(M, T, Nh, 0)
    want, want_carry = synthesize_pallas(jnp.asarray(Y), M, T, 0, 64,
                                         interpret=True)
    zero = torch.zeros((M * T - M // 2, 2))
    got, got_carry = K.synthesize_block_reference(torch.as_tensor(Y), M, T, 0,
                                                  zero)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(got_carry.numpy(), np.asarray(want_carry),
                               atol=2e-4)


@pytest.mark.parametrize("M,T,Nh,parity,split", [
    (16, 8, 300, 1, 0),
    (16, 8, 301, 0, -1),
    (64, 4, 129, 1, 0),
    (64, 4, 129, 1, 8),        # two-stage split
    (8, 8, 3, 1, 0),           # fewer hops than the carry holds blocks
])
def test_plain_version_matches_jax_xla(M, T, Nh, parity, split):
    Y, carry = _inputs(M, T, Nh, M + Nh)
    jsplit = jchz.default_split(M) if split < 0 else split
    want, want_carry = jchz._synthesize_block(
        jnp.asarray(Y), jnp.asarray(jchz.prototype_taps(M, T)), M, T,
        jnp.int32(parity), jnp.asarray(carry), False, jsplit)
    got, got_carry = K.synthesize_block_reference(
        torch.as_tensor(Y), M, T, parity, torch.as_tensor(carry), split)
    rms = float(np.sqrt(np.mean(np.asarray(want) ** 2)))
    assert got.shape == want.shape and got_carry.shape == want_carry.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * rms
    assert np.abs(got_carry.numpy() - np.asarray(want_carry)).max() \
        <= 1e-5 * rms


def test_two_blocks_with_carry_equal_one():
    M, T = 16, 8
    Y, _ = _inputs(M, T, 400, 4)
    zero = torch.zeros((M * T - M // 2, 2))
    x, c = K.synthesize_block_reference(torch.as_tensor(Y), M, T, 0, zero)
    xa, ca = K.synthesize_block_reference(torch.as_tensor(Y[:151]), M, T, 0,
                                          zero)
    xb, cb = K.synthesize_block_reference(torch.as_tensor(Y[151:]), M, T, 1,
                                          ca)
    rms = float(x.pow(2).mean().sqrt())
    assert (torch.cat([xa, xb]) - x).abs().max() <= 1e-6 * rms
    assert (cb - c).abs().max() <= 1e-6 * rms


def test_wrapper_cpu_tensor_takes_plain_version():
    M, T = 64, 8
    Y, carry = _inputs(M, T, 70, 9)
    before = K.LAUNCHES
    got = K.synthesize_block(torch.as_tensor(Y), M, T, 1,
                             torch.as_tensor(carry))
    want = K.synthesize_block_reference(torch.as_tensor(Y), M, T, 1,
                                        torch.as_tensor(carry))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert K.LAUNCHES == before


def test_wrapper_rejects_what_it_cannot_run():
    M, T = 64, 8
    Y = torch.zeros((10, M, 2))
    carry = torch.zeros((M * T - M // 2, 2))
    with pytest.raises(TypeError):
        K.synthesize_block(Y.numpy(), M, T, 0, carry)
    with pytest.raises(ValueError):
        K.synthesize_block(Y.to("meta"), M, T, 0, carry.to("meta"))
    with pytest.raises(ValueError):
        K.synthesize_block_reference(Y, 32, T, 0, carry)      # wrong M
    with pytest.raises(ValueError):
        K.synthesize_block_reference(Y, M, T, 0, carry[1:])   # wrong carry
