"""The fused front end's plain version (the path a CPU tensor takes)
against the JAX XLA chain and against the JAX Pallas kernel K3 in
interpret mode; a torch model of the CUDA kernel's runs (csrc/rx_phases.cu)
against both; the wrapper's device rules.  The CUDA kernel is held to
its plain version on the card in test_torch_cuda.py.

Branch-cut rule: two correct f32 computations that sum in different
orders can put a noise-only sample on opposite sides of ±π, which moves
one phase symbol by ~2π/3.  On random-noise input at most 1e-5 of the
phase elements may fall outside the tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp.fm import quadrature_demod_planar as jdemod
from amps_tpu.rx import correlator as jcor
from amps_tpu_torch.dsp.fm import fast_atan2
from amps_tpu_torch.kernels import analysis as KA
from amps_tpu_torch.kernels import build
from amps_tpu_torch.kernels import rx_phases as K
from amps_tpu_torch.rx.correlator import RSSI_BLOCK

torch.set_num_threads(1)

BRANCH_CUT_FRACTION = 1e-5


def _x_ext(M, T, Nh, seed, sigma=0.5):
    P = M // 2
    rng = np.random.default_rng(seed)
    x = rng.normal(0, sigma, (Nh * P, 2)).astype(np.float32)
    return np.concatenate([np.zeros((M * T - P, 2), np.float32), x])


def _jax_chain(x_ext, M, T, sps, parity):
    ypl = jchz._analyze_block_chmajor(
        jnp.asarray(x_ext), jnp.asarray(jchz.prototype_taps(M, T)), M, T,
        jnp.int32(parity), fold="bank", planar=True)
    demod, _, pw = jdemod(ypl[0], ypl[1], return_power="series")
    blk = jcor.window_power_blocks([pw])
    return (np.asarray(jcor.symbol_phase_streams(demod, sps)),
            np.asarray(jcor.power_from_blocks(blk, pw.shape[-1])),
            np.asarray(blk))


def _beyond(a, b, atol):
    return int((np.abs(a - b) > atol).sum())


@pytest.mark.parametrize("M,Nh,parity,planar", [
    (64, 1800, 0, False),
    (32, 3301, 1, False),      # ragged: Nh % 384 != 0 and Nh odd
    (64, 1800, 1, True),
])
def test_plain_version_matches_jax_xla_chain(M, Nh, parity, planar):
    T, sps = 8, 3
    x_ext = _x_ext(M, T, Nh, seed=M + Nh)
    ph_w, cp_w, pw_w = _jax_chain(x_ext, M, T, sps, parity)
    xt = torch.as_tensor(np.ascontiguousarray(x_ext.T) if planar else x_ext)
    ph, cp, pw = K.analyze_phases_reference(xt, M, T, sps, parity)
    assert ph.shape == ph_w.shape == (M, sps, (Nh - sps + 1) // sps)
    assert pw.shape == pw_w.shape == (M, -(-Nh // 384))
    assert ph.dtype == torch.float32
    allowed = int(BRANCH_CUT_FRACTION * ph_w.size)
    assert _beyond(ph.numpy(), ph_w, 1e-4) <= allowed
    np.testing.assert_allclose(pw.numpy(), pw_w, rtol=1e-4)
    np.testing.assert_allclose(cp.numpy(), cp_w, rtol=1e-4)


def _runs_model(x_ext, M, T, sps, parity, planar):
    """K3's decomposition: runs of R = run_hops(M, sps) demod hops, each
    from its own analysis hops h0-1 .. h0+R+sps-2 (hop -1 zero; hops past
    Nh NaN, so a use of one shows), the discriminator products, the
    dump of the run's whole symbols j < nsym in hop order, and the power
    of its owned hops < Nh split at the 384-hop boundary it crosses; a
    second pass adds each rssi block's partials in run order / 384."""
    y = KA.analyze_reference(x_ext, M, T, parity, planar=True,
                             planar_in=planar)
    Nh = y.shape[-1]
    R = K.run_hops(M, sps)
    nrun, nsym, nblk = -(-Nh // R), (Nh - sps + 1) // sps, -(-Nh // 384)
    yp = torch.cat([torch.zeros((2, M, 1)), y,
                    torch.full((2, M, R + sps), float("nan"))], dim=-1)
    ph = torch.full((M, sps, nsym), float("nan"))
    part = torch.zeros((M, nrun, 2))
    w = np.float32(1.0 / sps)
    for run in range(nrun):
        h0 = run * R
        c = yp[:, :, h0 + 1: h0 + R + sps]           # hops h0 .. h0+R+sps-2
        b = yp[:, :, h0: h0 + R + sps - 1]           # one hop behind
        re = c[0] * b[0] + c[1] * b[1]
        im = c[1] * b[0] - c[0] * b[1]
        d = fast_atan2(im, re)
        pw = (re * re + im * im)[:, :R]
        n = h0 + torch.arange(R)
        first = (n // RSSI_BLOCK == h0 // RSSI_BLOCK) & (n < Nh)
        part[:, run, 0] = torch.where(first, pw, 0).sum(-1)
        part[:, run, 1] = torch.where(~first & (n < Nh), pw, 0).sum(-1)
        for jl in range(R // sps):
            j = h0 // sps + jl
            if j < nsym:
                acc = torch.zeros((M, sps))
                for v in range(sps):
                    acc = acc + d[:, sps * jl + v: sps * jl + v + sps] * w
                ph[:, :, j] = acc
    pw_blk = torch.zeros((M, nblk))
    for b in range(nblk):
        for run in range(b * 384 // R, min((b * 384 + 383) // R, nrun - 1)
                         + 1):
            pw_blk[:, b] += part[:, run, 0 if run * R // 384 == b else 1]
    return ph, pw_blk / 384


@pytest.mark.parametrize("M,sps,Nh,parity,planar", [
    (64, 3, 27 * 14 + 1, 1, False),   # one hop past 14 whole runs of 27
    (64, 1, 1000, 0, True),
    (256, 3, 800, 0, False),
    (1024, 3, 300, 1, False),
])
def test_runs_model_matches_plain_version_and_jax(M, sps, Nh, parity,
                                                  planar):
    """The decomposition the CUDA kernel runs (symbol ownership by run,
    the look-ahead of sps-1 hops, the power partials split at 384 and
    summed in a second pass) against the plain version and the JAX XLA
    chain, at the tolerances of test_plain_version_matches_jax_xla_chain."""
    T = 8
    x_ext = _x_ext(M, T, Nh, seed=M + Nh)
    xt = torch.as_tensor(np.ascontiguousarray(x_ext.T) if planar else x_ext)
    ph, pw = _runs_model(xt, M, T, sps, parity, planar)
    rph, _, rpw = K.analyze_phases_reference(xt, M, T, sps, parity)
    ph_w, _, pw_w = _jax_chain(x_ext, M, T, sps, parity)
    assert ph.shape == rph.shape and pw.shape == rpw.shape
    assert torch.isfinite(ph).all() and torch.isfinite(pw).all()
    allowed = int(BRANCH_CUT_FRACTION * ph.numel())
    assert _beyond(ph.numpy(), rph.numpy(), 1e-4) <= allowed
    assert _beyond(ph.numpy(), ph_w, 1e-4) <= allowed
    np.testing.assert_allclose(pw.numpy(), rpw.numpy(), rtol=1e-4)
    np.testing.assert_allclose(pw.numpy(), pw_w, rtol=1e-4)


def test_plain_version_bf16_output():
    M, T, sps, Nh = 32, 8, 3, 800
    x = torch.as_tensor(_x_ext(M, T, Nh, seed=3))
    ph32, cp32, pw32 = K.analyze_phases_reference(x, M, T, sps)
    ph16, cp16, pw16 = K.analyze_phases_reference(x, M, T, sps,
                                                  out_dtype=torch.bfloat16)
    assert ph16.dtype == torch.bfloat16
    assert torch.equal(ph16, ph32.to(torch.bfloat16))
    assert torch.equal(cp16, cp32) and torch.equal(pw16, pw32)


def test_plain_version_matches_pallas_k3_interpret():
    """K3 in interpret mode at its aligned test geometry
    (tests/test_pallas.py): bf16 phases, block-mean power."""
    from amps_tpu.pallas.rx_phases_kernel import analyze_phases_pallas
    M, T, sps, Nh = 256, 8, 3, 768
    x_ext = _x_ext(M, T, Nh, seed=768)
    ph_k3, cp_k3 = analyze_phases_pallas(jnp.asarray(x_ext), M, T, sps,
                                         tile_h=384, interpret=True)
    ph, cp, _ = K.analyze_phases_reference(torch.as_tensor(x_ext), M, T, sps)
    ph_k3 = np.asarray(ph_k3, np.float32)
    assert ph.shape == ph_k3.shape
    allowed = int(BRANCH_CUT_FRACTION * ph_k3.size)
    assert _beyond(ph.numpy(), ph_k3, 0.02) <= allowed
    np.testing.assert_allclose(cp.numpy(), np.asarray(cp_k3), rtol=1e-3)


def test_wrapper_cpu_tensor_takes_plain_version():
    M, T, sps, Nh = 64, 4, 3, 400
    x = torch.as_tensor(_x_ext(M, T, Nh, seed=9))
    before = K.LAUNCHES
    got = K.analyze_phases(x, M, T, sps, hop0_parity=1)
    want = K.analyze_phases_reference(x, M, T, sps, 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert K.LAUNCHES == before


def test_wrapper_rejects_what_it_cannot_run():
    x = torch.zeros((100 * 32 + 15 * 32, 2))
    with pytest.raises(ValueError):
        K.analyze_phases(x.to("meta"), 64, 8)
    with pytest.raises(TypeError):
        K.analyze_phases(x.numpy(), 64, 8)
    with pytest.raises(ValueError):
        K.analyze_phases_reference(torch.zeros((3, 3)), 64, 8)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


def test_library_path_follows_sources():
    p = build.library_path()
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert p == build.library_path()
