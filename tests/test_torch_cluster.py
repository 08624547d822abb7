"""Banks past 4096 channels (up to M = 8192, 245.76 Msps): the FFT tile
split across a cluster of two thread blocks.

On the CPU the kernels' arithmetic is held through what the CUDA sources
are handed and through a model of what they compute: the geometry every
library is held to (``kernels.analysis.bind``) at every even M in (4096,
8192], the twiddle table with the combine's W_M^k block, a numpy mirror
of the split transform (the kernel's decimation, two M/2-point
transforms, the radix-2 pass across the pair on the table's twiddles,
each rank's contiguous half of the channels, the hop sign) against
numpy.fft, and the port's plain K1-K4 at M = 8192 and 4098 (= 2·2049, an
odd half width) against the JAX package's XLA functions (its bank
analysis with the two-stage transform at 8192, the dense one at 4098;
the FM discriminator, the phase streams and power blocks; the
synthesis).  The TPU kernels in interpret mode build dense M x M DFT
matrices, so they are not run at these widths.  The CUDA kernels at
these widths are held to their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 31).

Tolerances: tests/test_pallas.py's atol 2e-4 for the f32 analysis and
synthesis and 5% for the power; the discriminator within 1e-4 of the
JAX f32 chain; bf16 phases within 0.02 (the bf16 output's step) of the
JAX f32 chain's phases, as tests/test_torch_widths.py holds them at
4096; the mirror within 1e-5 of the output's RMS (f32 transforms)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp.fm import quadrature_demod_planar as jdemod
from amps_tpu.rx import correlator as jcor
from amps_tpu_torch.eval.traffic import unit_channel_band
from amps_tpu_torch.kernels import analysis as KA
from amps_tpu_torch.kernels import rx_front as K2
from amps_tpu_torch.kernels import rx_phases as K3
from amps_tpu_torch.kernels import synth as K4

torch.set_num_threads(1)

SMEM_BYTES = 232448       # shared memory a Hopper block may opt in to
CLUSTER_WIDTHS = tuple(range(4098, 8193, 2))
# the widths the card tests and chip_smoke hold each kernel at: an odd
# half width with the generic pass (4098 = 2·3·683), 4100 = 4·5²·41,
# 6144 = 2·3072 (radix 3), 8190 = 2·3²·5·7·13, the power of two 8192
MIRROR_WIDTHS = (4098, 6144, 8190, 8192)


def test_cluster_size_and_half_width_plan_every_width_past_4096():
    """Every even M in (4096, 8192] runs on a cluster of 2 blocks, each
    transforming M/2 with a plan whose radices multiply to M/2; every M
    up to 4096 runs on one block at its own width."""
    for M in CLUSTER_WIDTHS:
        N = KA.fft_plan_width(M)
        assert KA.fft_cluster_size(M) == 2 and 2 * N == M, M
        assert int(np.prod(KA.fft_radices(N))) == N, M
        assert N <= KA.BLOCK_WIDTH
    for M in (8, 768, 2048, 4094, 4096):
        assert KA.fft_cluster_size(M) == 1 and KA.fft_plan_width(M) == M
    # past 8192 clusters of up to CLUSTER_SIZE = 8 (test_torch_cluster_wide)
    assert KA.MAX_FFT_WIDTH == 32768 == KA.CLUSTER_SIZE * KA.BLOCK_WIDTH
    # past it every even width runs through device memory (the route,
    # tests/test_torch_route.py), none on a cluster
    assert KA.route_length(KA.MAX_FFT_WIDTH + 2) == 131072
    assert KA.fft_cluster_size(KA.MAX_FFT_WIDTH + 2) == 0


def test_cluster_block_shared_memory_every_width_past_4096():
    """K1 (FFT_TILE_HOPS) and K2-K4 (FFT_WIDE_HOPS) past 4096: a block's
    shared memory is its half-width plane counted afresh (H hops of M/2
    values, one value of padding every 32, plus one; the twiddle table in
    device memory), fits the 232,448 bytes a Hopper block may opt in to,
    and two more hops would not; M = 8192 holds six hops (202,800 bytes,
    as M = 4096 does)."""
    for M in CLUSTER_WIDTHS:
        N = M // 2
        H = KA.FFT_WIDE_HOPS[M]
        assert H == KA.FFT_TILE_HOPS[M] and H % 2 == 0, M
        assert KA.fft_smem_bytes(M, H) == 8 * H * (N + N // 32 + 1) \
            <= SMEM_BYTES, M
        assert 8 * (H + 2) * (N + N // 32 + 1) > SMEM_BYTES, M
    assert KA.FFT_WIDE_HOPS[8192] == KA.FFT_WIDE_HOPS[4096] == 6
    assert KA.fft_smem_bytes(8192, 6) == KA.fft_smem_bytes(4096, 6) == 202800


def test_k3_run_past_4096():
    """K3 at sps = 3 owns at least one whole symbol a block at every M in
    (4096, 8192] (one hop behind, two ahead), exactly one at 8192."""
    for M in CLUSTER_WIDTHS:
        R = K3.run_hops(M, 3)
        assert R >= 3 and R % 3 == 0 and R + 3 <= KA.FFT_WIDE_HOPS[M], M
    assert K3.run_hops(8192, 3) == 3
    assert K3.run_hops(4098, 3) == 9


@pytest.mark.parametrize("T", [8, 16])
def test_k4_groups_cover_each_rank_past_4096(T):
    """K4 past 4096: a thread holds at most 2 columns (1 at T = 16), a
    group's two ranks split its columns, so the groups cover P = M/2 with
    2 · 256 · thread_columns columns each, and there are as many groups
    at 8192 as at 4096."""
    for M in CLUSTER_WIDTHS:
        P = M // 2
        cols, G = K4.thread_columns(M, T), K4.column_groups(M, T)
        assert cols == (2 if T == 8 else 1), M
        per_block = -(-P // (2 * G))
        assert per_block <= 256 * cols, M
        assert G * 2 * 256 * cols >= P > (G - 1) * 2 * 256 * cols, M
    assert K4.column_groups(8192, T) == K4.column_groups(4096, T)


def test_k4_parked_ring_fits_every_width_past_4096():
    """K4 past 4096 parks each thread's 32 running sums in shared memory
    while the tile transforms a pass: its hops are the most even hops
    whose half-width plane fits beside 64 KB of parked ring (4 at 8192,
    at least 4 everywhere), and up to 4096 it keeps the other kernels'
    FFT_WIDE_HOPS and shared memory."""
    for M in CLUSTER_WIDTHS:
        N, H = M // 2, K4.SYNTH_HOPS[M]
        plane = 8 * H * (N + N // 32 + 1)
        assert H % 2 == 0 and 4 <= H <= KA.FFT_WIDE_HOPS[M], M
        assert K4.smem_bytes(M) == plane + 65536 <= SMEM_BYTES, M
        assert plane + 8 * 2 * (N + N // 32 + 1) + 65536 > SMEM_BYTES, M
    assert K4.SYNTH_HOPS[8192] == 4
    for M in (8, 768, 2048, 4094, 4096):
        assert K4.SYNTH_HOPS[M] == KA.FFT_WIDE_HOPS[M]
        assert K4.smem_bytes(M) == KA.fft_smem_bytes(M, KA.FFT_WIDE_HOPS[M])


def test_cluster_twiddle_table():
    """Past 4096 the table is the half width's table -- its W_{M/2}^e the
    same f32 numbers as W_M^{2e} -- then the combine's W_M^k, k < M/2."""
    for M in MIRROR_WIDTHS + (4100,):
        N = M // 2
        e = KA.fft_twiddle_exponents(M)
        head = KA.fft_twiddle_exponents(N)
        assert np.array_equal(e, np.concatenate([2 * head, np.arange(N)]))
        tw = KA._fft_twiddles(M)
        assert np.array_equal(tw[: len(head)], KA._fft_twiddles(N)), M
        k = np.arange(N)
        want = np.exp(-2j * np.pi * k / M)
        assert np.abs(tw[len(head):, 0] - want.real).max() < 1e-7, M
        assert np.abs(tw[len(head):, 1] - want.imag).max() < 1e-7, M


def _folded_windows(x_ext, M, T, Nh):
    """f_n[m] = sum_t coef[t, m] x[nP + tM + m], (Nh, M) complex128."""
    P = M // 2
    coef = KA._tables(M, T, torch.device("cpu"))[0].numpy().astype(np.float64)
    z = x_ext[:, 0].astype(np.float64) + 1j * x_ext[:, 1]
    f = np.zeros((Nh, M), np.complex128)
    for t in range(T):
        idx = np.arange(Nh)[:, None] * P + t * M + np.arange(M)[None, :]
        f += coef[t][None, :] * z[idx]
    return f


def _split_mirror(f, M, parity):
    """The cluster's transform of folded windows f (Nh, M), in f32: rank r
    folds f[2m + r] and transforms it (N = M/2 points), then each rank
    reads both planes and keeps y[rN + c] = E[c] ± W_M^c O[c] (the
    table's block after the half plan's), then the hop sign
    (-1)^{k(n+parity)}.  Returns (M, Nh) complex64, channel-major."""
    N = M // 2
    tw = KA._fft_twiddles(M)[-N:]
    w = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    E, O = (np.fft.fft(f[:, r::2].astype(np.complex64), axis=-1)
            .astype(np.complex64) for r in (0, 1))
    t = (O * w).astype(np.complex64)
    planes = (E + t, E - t)           # rank 0: k = c, rank 1: k = N + c
    y = np.concatenate(planes, axis=-1).T
    k, n = np.arange(M)[:, None], np.arange(f.shape[0])[None, :]
    return np.where((k % 2 == 1) & ((n + parity) % 2 == 1), -y, y)


@pytest.mark.parametrize("M", MIRROR_WIDTHS)
def test_split_transform_mirror_matches_numpy_fft(M):
    """The numpy mirror of the cluster's split transform equals numpy.fft
    of the folded window, with the hop sign, within 1e-5 of the output's
    RMS at both hop parities, and the port's plain K1 within atol 2e-4."""
    T, Nh = 8, 6
    x = unit_channel_band(M, T, Nh, M, device="cpu")
    f = _folded_windows(x.numpy(), M, T, Nh)
    for parity in (0, 1):
        got = _split_mirror(f, M, parity)
        k, n = np.arange(M)[:, None], np.arange(Nh)[None, :]
        want = np.fft.fft(f, axis=-1).T
        want = np.where((k % 2 == 1) & ((n + parity) % 2 == 1), -want, want)
        rms = np.sqrt((np.abs(want) ** 2).mean())
        assert np.abs(got - want).max() <= 1e-5 * rms, (M, parity)
        plain = KA.analyze_block(x, M, T, parity).numpy()
        assert np.abs(plain[..., 0] + 1j * plain[..., 1] - got).max() < 2e-4


# ---- the port's plain K1-K4 against the JAX package at 8192 and 4098 ----

def _x_ext(M, T, Nh, seed, sigma=0.5):
    P = M // 2
    rng = np.random.default_rng(seed)
    x = rng.normal(0, sigma, (Nh * P, 2)).astype(np.float32)
    return np.concatenate([np.zeros((M * T - P, 2), np.float32), x])


def _fsk_band(M, T, Nh, seed):
    """History-prepended wideband whose M channels all carry random-data
    FSK at 3 hops a symbol, through the port's plain synthesis."""
    from amps_tpu_torch.dsp.channelizer import _synthesize_block
    from amps_tpu_torch.dsp.fm import fm_modulate_symbols
    rng = np.random.default_rng(seed)
    syms = np.repeat(rng.choice(np.array([-1, 1], np.int8), (M, -(-Nh // 3))),
                     3, axis=1)[:, :Nh]
    bb, _ = fm_modulate_symbols(torch.as_tensor(syms), 2 * np.pi * 8000 / 60000)
    carry = torch.zeros((M * T - M // 2, 2))
    x, _ = _synthesize_block(bb.transpose(0, 1).contiguous(), M, T, 0, carry)
    return torch.cat([carry, x]).contiguous()


def _jax_planes(x_ext, M, T, parity):
    """The JAX package's bank analysis of a history-prepended block, its
    default transform (two-stage at 8192, dense at 4098): (2, M, Nh)."""
    spec = jchz.ChannelizerSpec(M, T)
    L, P = M * T, M // 2
    state = jchz.AnalyzerState(jnp.asarray(x_ext[: L - P]), parity)
    y, _ = jchz.analyze(jnp.asarray(x_ext[L - P:]), spec, state, chmajor=True,
                        fold="bank", planar=True)
    return y


# hops of the bank's ramp-up from the zero history, left out of the
# phase comparisons
RAMP = 2 * 8 + 2
# fast_atan2 steps by 0.0417 at its octant seam (|im| = |re|), where two
# f32 summation orders may land on either side: a demod sample there is
# held to the step, and such samples to 1e-5 of the plane (as
# tests/test_torch_cuda.py and chip_smoke.py hold the kernels)
ATAN_SEAM = 0.0417
SEAM_FRACTION = 1e-5


def _held_to_demod_atol(err, ref, atol):
    a = np.abs(ref)
    seam = (np.abs(a - np.pi / 4) < 0.025) | (np.abs(a - 3 * np.pi / 4) < 0.025)
    on_seam = (err > atol) & seam
    assert np.where(on_seam, 0.0, err).max() <= atol
    assert on_seam.sum() <= SEAM_FRACTION * err.size + 1
    assert err.max() <= ATAN_SEAM + atol


@pytest.mark.parametrize("M", [8192, 4098])
def test_plain_k1_matches_jax_at_cluster_width(M):
    """K1's plain version (the wrapper on a CPU tensor) against the JAX
    bank analysis, 40 hops of random IQ, both parities: atol 2e-4."""
    T, Nh = 8, 40
    x = _x_ext(M, T, Nh, M)
    for parity in (0, 1):
        want = np.asarray(_jax_planes(x, M, T, parity))
        got = KA.analyze_block(torch.as_tensor(x), M, T, parity,
                               planar=True).numpy()
        assert got.shape == want.shape == (2, M, Nh)
        assert np.abs(got - want).max() < 2e-4, (M, parity)


@pytest.mark.parametrize("M", [8192, 4098])
def test_plain_k2_matches_jax_at_cluster_width(M):
    """K2's plain version on FSK in every channel, odd parity, a random
    previous sample, against the JAX analysis and discriminator: demod
    within 1e-4 past the ramp-up (a sample on fast_atan2's seam within
    its step), the last sample within 2e-4, the power series' 384-hop
    block means within 5%."""
    T, Nh, parity = 8, 48, 1
    x = _fsk_band(M, T, Nh, M + 1)
    prev = np.random.default_rng(M).normal(0, 1, (M, 2)).astype(np.float32)
    ypl = _jax_planes(x.numpy(), M, T, parity)
    want_d, (lr, li), want_p = jdemod(
        ypl[0], ypl[1], prev=(jnp.asarray(prev[:, 0]), jnp.asarray(prev[:, 1])),
        return_power="series")
    d, last, pw = K2.analyze_demod(x, M, T, parity, torch.as_tensor(prev))
    assert d.shape == pw.shape == (M, Nh)
    want_d = np.asarray(want_d)[:, RAMP:]
    _held_to_demod_atol(np.abs(d.numpy()[:, RAMP:] - want_d), want_d, 1e-4)
    assert np.abs(last.numpy() - np.stack([lr, li], -1)).max() < 2e-4
    blk = np.asarray(jcor.window_power_blocks([jnp.asarray(pw.numpy())]))
    want_blk = np.asarray(jcor.window_power_blocks([want_p]))
    assert (np.abs(blk - want_blk) / want_blk).max() < 0.05


@pytest.mark.parametrize("M", [8192, 4098])
def test_plain_k3_matches_jax_at_cluster_width(M):
    """K3's plain version on FSK in every channel, Nh = 3·20 + 1 (a
    ragged symbol), bf16 phases: within 0.02 of the JAX f32 chain's phase
    streams past the ramp-up; the channel power within 5% of the JAX
    chain's 384-hop power blocks."""
    T, Nh, sps = 8, 61, 3
    x = _fsk_band(M, T, Nh, M + 2)
    ph, cp, pw_blk = K3.analyze_phases(x, M, T, sps, 0, torch.bfloat16)
    ypl = _jax_planes(x.numpy(), M, T, 0)
    demod, _, pw = jdemod(ypl[0], ypl[1], return_power="series")
    want_ph = np.asarray(jcor.symbol_phase_streams(demod, sps))
    assert ph.shape == want_ph.shape == (M, sps, (Nh - sps + 1) // sps)
    js = -(-RAMP // sps)
    assert np.abs(ph.float().numpy() - want_ph)[..., js:].max() < 0.02
    want_blk = np.asarray(jcor.window_power_blocks([pw]))
    want_cp = np.asarray(jcor.power_from_blocks(jnp.asarray(want_blk), Nh))
    assert (np.abs(pw_blk.numpy() - want_blk) / want_blk).max() < 0.05
    assert (np.abs(cp.numpy() - want_cp) / want_cp).max() < 0.05


@pytest.mark.parametrize("M", [8192, 4098])
def test_plain_k4_matches_jax_at_cluster_width(M):
    """K4's plain version (the wrapper on CPU tensors) against the JAX
    synthesis, 40 hops of random channel basebands with a random carry
    in, odd parity: output and new carry within atol 2e-4."""
    T, Nh, parity = 8, 40, 1
    rng = np.random.default_rng(M)
    Y = rng.normal(0, 1, (Nh, M, 2)).astype(np.float32)
    carry = rng.normal(0, 0.1, (M * T - M // 2, 2)).astype(np.float32)
    want, state = jchz.synthesize(
        jnp.asarray(Y), jchz.ChannelizerSpec(M, T),
        jchz.SynthesizerState(jnp.asarray(carry), parity))
    got, got_carry = K4.synthesize_block(torch.as_tensor(Y), M, T, parity,
                                         torch.as_tensor(carry))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(got_carry.numpy(), np.asarray(state.carry),
                               atol=2e-4)
