"""Banks past 8192 channels (up to M = 32768): the FFT tile split across
a cluster of C = 3 .. 8 thread blocks with a radix-C pass across them.

The rule: M up to 4096 runs on one block; past it C is the smallest
divisor of M from 2 to 8 with N = M/C <= 4096 (2 for every even M up to
8192), and a width with no such C, or past 32768, is refused.  On the
CPU the kernels' arithmetic is held through what the CUDA sources are
handed and through models of what they compute: the geometry every
library is held to (``kernels.analysis.bind``) at every even M up to
32768, the twiddle table's blocks of the pass across the cluster, a
numpy mirror of the split transform in f32 (rank r's f[C·m + r] through
an N-point FFT, its twiddles W_M^{r·c}, the radix-C sum in the kernel's
order, each rank's contiguous range of channels, the hop sign) against
numpy.fft, a numpy mirror of K4's reads of the forward FFT (each read's
rank and position, each column read once), the kernel path's tables
against the plain version's, and the port's plain K1 and K4 at M =
16384 against the JAX package's XLA functions.  The CUDA kernels at
these widths are held to their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 33).

Tolerances: the mirror within 1e-5 of the output's RMS (f32 transforms,
as tests/test_torch_cluster.py holds the pair); the plain K1 and K4
within atol 2e-4 of the JAX package (tests/test_pallas.py's); twiddles
within 1e-7 of float64 (one f32 rounding)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu_torch.dsp import polyphase as pp
from amps_tpu_torch.kernels import analysis as KA
from amps_tpu_torch.kernels import rx_phases as K3
from amps_tpu_torch.kernels import synth as K4

torch.set_num_threads(1)

SMEM_BYTES = 232448       # shared memory a Hopper block may opt in to
PARK_BYTES = 65536        # K4's parked ring: 32 sums x 256 threads x 8 B
# one width per cluster size and parity of the block width: 8196 =
# 3·2732 (the generic pass at N = 2732 = 4·683), 12288 = 3·4096, 16384 =
# 4·4096, 20480 = 5·4096, 12294 = 6·2049 (an odd N), 28672 = 7·4096,
# 32768 = 8·4096, 16424 = 8·2053 (N prime)
MIRROR_WIDTHS = (8196, 12288, 16384, 20480, 12294, 28672, 32768, 16424)


def _free_dense_tables():
    pp._analysis_consts.cache_clear()


def _rule(M):
    """The cluster size the rule gives, counted afresh: 1 up to 4096,
    the smallest divisor C of M from 2 to 8 with M/C <= 4096 past it, 0
    where there is none."""
    if M <= 4096:
        return 1
    return min((C for C in range(2, 9) if M % C == 0 and M // C <= 4096),
               default=0)


def test_cluster_size_is_the_rule_at_every_even_width():
    """Every even M up to 32768: fft_cluster_size is the rule's smallest
    C and fft_plan_width is M/C, whose plan's radices multiply to it; the
    counts the rule takes past 8192 (3159 of the 4096 even widths in
    (8192, 16384], 3760 of the 8192 in (16384, 32768]); every multiple of
    8 is taken, and the radio widths get the cluster they name."""
    for M in range(2, 32769, 2):
        C = _rule(M)
        assert KA.fft_cluster_size(M) == C, M
        if C:
            N = KA.fft_plan_width(M)
            assert N * C == M and N <= KA.BLOCK_WIDTH, M
    taken = [M for M in range(8194, 32769, 2) if _rule(M)]
    assert sum(M <= 16384 for M in taken) == 3159
    assert sum(M > 16384 for M in taken) == 3760
    assert all(_rule(M) for M in range(8, 32769, 8))
    for M, C in ((8192, 2), (12288, 3), (16384, 4), (20480, 5),
                 (24576, 6), (28672, 7), (32768, 8), (12294, 6),
                 (16424, 8), (8196, 3)):
        assert KA.fft_cluster_size(M) == C, M
    for M in (8196, 12288, 16384, 12294, 16424, 32768):
        N = KA.fft_plan_width(M)
        assert int(np.prod(KA.fft_radices(N))) == N, M
    assert KA.CLUSTER_SIZE * KA.BLOCK_WIDTH == KA.MAX_FFT_WIDTH == 32768
    # the route's limit: every even width the clusters do not split, past
    # 16384 and past 32768, through device memory (tests/test_torch_route.py)
    assert KA.route_length(16388) == KA.route_length(32766) == 65536
    assert KA.route_length(32768) == 0


def test_check_fft_width_takes_exactly_the_rule():
    """The shared-memory modes take every even M from 2 to 8192 and,
    past it, exactly the M = C·N the rule splits, up to 32768, and the
    even widths up to 16384 it does not split (Bluestein's,
    tests/test_torch_bluestein.py): FFT_WIDTHS lists them.
    check_fft_width takes every even M >= 2 (the others through device
    memory, tests/test_torch_route.py); odd M and M < 2 raise, naming the
    rule."""
    shared = []
    for M in range(-2, 32800):
        if M > 0 and M % 2 == 0:
            KA.check_fft_width(M)
            if M <= 32768 and (_rule(M) > 0 or M <= 16384):
                shared.append(M)
        else:
            with pytest.raises(ValueError, match="or M = C·N with C <= 8"):
                KA.check_fft_width(M)
    assert KA.FFT_WIDTHS == tuple(shared)
    assert shared[:4] == [2, 4, 6, 8] and shared[-1] == 32768
    # past 32768 every even width goes through device memory
    assert KA.route_length(32770) == 131072


def test_block_shared_memory_and_hops_past_8192():
    """K1 (FFT_TILE_HOPS) and K2-K4 (FFT_WIDE_HOPS) at every taken M past
    4096: a block's shared memory is its plane of M/C channels counted
    afresh (H hops, one value of padding every 32, plus one; the twiddle
    table in device memory), fits the 232,448 bytes a Hopper block may
    opt in to, and two more hops would not (or H is the cap of 16);
    every N = 4096 (16384, 32768, ...) holds six hops, as M = 4096 does,
    and so does the 4096-point block of an unsplit width (Bluestein's
    32768 points on 8 blocks)."""
    for M in KA.FFT_WIDTHS:
        if M <= 4096:
            continue
        N = M // _rule(M) if _rule(M) else 4096
        H = KA.FFT_WIDE_HOPS[M]
        row = 8 * (N + N // 32 + 1)
        assert H == KA.FFT_TILE_HOPS[M] and H % 2 == 0, M
        assert KA.fft_smem_bytes(M, H) == H * row <= SMEM_BYTES, M
        assert H == 16 or (H + 2) * row > SMEM_BYTES, M
    for M in (8192, 12288, 16384, 20480, 24576, 28672, 32768):
        assert KA.FFT_WIDE_HOPS[M] == 6
        assert KA.fft_smem_bytes(M, 6) == 202800


def test_k3_run_and_k4_geometry_past_8192():
    """K3 at sps = 3 owns at least one whole symbol a block (3 hops at N
    = 4096); K4 holds at most 2 columns a thread (1 with the ring of 16),
    its groups of C blocks cover the P = M/2 columns, its ring of 32 sums
    parks beside the most even hops of plane that fit (4 at N = 4096),
    and each block's columns are thread_columns x 256 or fewer -- as
    csrc synth_thread_columns, synth_groups and synth_hops count them."""
    for M in KA.FFT_WIDTHS:
        C = _rule(M)
        if C < 2:
            continue
        N, P = M // C, M // 2
        R = K3.run_hops(M, 3)
        assert R >= 3 and R % 3 == 0 and R + 3 <= KA.FFT_WIDE_HOPS[M], M
        row = 8 * (N + N // 32 + 1)
        H = K4.SYNTH_HOPS[M]
        assert K4.park_bytes(M) == PARK_BYTES
        assert H == (SMEM_BYTES - PARK_BYTES) // row & ~1 and H >= 4, M
        assert K4.smem_bytes(M) == H * row + PARK_BYTES <= SMEM_BYTES, M
        for T, ring in ((8, 16), (16, 32)):
            cols = min(-(-(P // C) // 256), 2 if T == 8 else 1)
            G = -(-P // (C * 256 * cols))
            assert K4.thread_columns(M, T) == cols, (M, T)
            assert K4.column_groups(M, T) == G, (M, T)
            per_block = -(-P // (G * C))
            # the parked ring: every block's thread holds 32 sums
            assert -(-per_block // 256) * ring == 32, (M, T)
    assert K3.run_hops(16384, 3) == K3.run_hops(32768, 3) == 3
    assert K4.SYNTH_HOPS[16384] == K4.SYNTH_HOPS[32768] == 4


@pytest.mark.parametrize("M", MIRROR_WIDTHS)
def test_cross_twiddle_table(M):
    """Past C = 2 the table is the N-point plan's (its W_N^e as
    W_M^{Ce}), then W_M^{s·c} for 1 <= s < C, c < N, s-major, then the
    C constants W_C^e: each entry within 1e-7 of float64 W_M^e."""
    C = _rule(M)
    N = M // C
    e = KA.fft_twiddle_exponents(M)
    plan = KA.fft_twiddle_exponents(N)
    assert len(e) == len(plan) + (C - 1) * N + C
    assert np.array_equal(e[: len(plan)], C * plan)
    s, c = np.meshgrid(np.arange(1, C), np.arange(N), indexing="ij")
    assert np.array_equal(e[len(plan): len(plan) + (C - 1) * N],
                          (s * c).ravel())
    assert np.array_equal(e[-C:], np.arange(C) * N)
    tw = KA._fft_twiddles(M).astype(np.float64)
    want = np.exp(-2j * np.pi * (e % M) / M)
    assert np.abs(tw[:, 0] - want.real).max() < 1e-7
    assert np.abs(tw[:, 1] - want.imag).max() < 1e-7


def _folded_windows(x, M, T, Nh):
    """f_n[m] = sum_t coef[t, m] x[nP + tM + m] of a random history-
    prepended input x ((Nh + 2T - 1)·P, 2), (Nh, M) complex128."""
    P = M // 2
    coef = KA._tables(M, T, torch.device("cpu"))[0].numpy().astype(np.float64)
    z = x[:, 0].astype(np.float64) + 1j * x[:, 1]
    f = np.zeros((Nh, M), np.complex128)
    for t in range(T):
        idx = np.arange(Nh)[:, None] * P + t * M + np.arange(M)[None, :]
        f += coef[t][None, :] * z[idx]
    return f


def _cross_mirror(f, M, parity):
    """The cluster's transform of folded windows f (Nh, M) in f32, as
    csrc FftTile::cross computes it: rank s transforms f[C·m + s] (N
    points), multiplies by the table's W_M^{s·c}, and rank r sums
    y[rN + c] = G_0[c] + sum_s W_C^{s·r} G_s[c], s ascending, each term
    two fmaf a part (here in f32 products and sums); then the hop sign
    (-1)^{k(n+parity)}.  Returns (M, Nh) complex64, channel-major."""
    C = _rule(M)
    N = M // C
    tw = KA._fft_twiddles(M)
    off = len(KA.fft_twiddle_exponents(N))
    wt = (tw[off: off + (C - 1) * N, 0]
          + 1j * tw[off: off + (C - 1) * N, 1]).astype(np.complex64)
    wc = (tw[-C:, 0] + 1j * tw[-C:, 1]).astype(np.complex64)
    G = []
    for s in range(C):
        F = np.fft.fft(f[:, s::C].astype(np.complex64), axis=-1).astype(
            np.complex64)
        G.append(F if s == 0 else (F * wt[(s - 1) * N: s * N]).astype(
            np.complex64))
    planes = []
    for r in range(C):
        acc = G[0].copy()
        for s in range(1, C):
            acc = (acc + (G[s] * wc[s * r % C]).astype(np.complex64)).astype(
                np.complex64)
        planes.append(acc)
    y = np.concatenate(planes, axis=-1).T
    k, n = np.arange(M)[:, None], np.arange(f.shape[0])[None, :]
    return np.where((k % 2 == 1) & ((n + parity) % 2 == 1), -y, y)


@pytest.mark.parametrize("M", (8196, 16384, 20480, 12294, 28672, 32768))
def test_cross_transform_mirror_matches_numpy_fft(M):
    """The numpy mirror of the cluster's radix-C split (C = 3 .. 8, odd
    and even block widths) equals numpy.fft of the folded window, with
    the hop sign, within 1e-5 of the output's RMS at both hop parities."""
    T, Nh = 8, 4
    P = M // 2
    x = np.random.default_rng(M).normal(
        0, 0.5, ((Nh + 2 * T - 1) * P, 2)).astype(np.float32)
    f = _folded_windows(x, M, T, Nh)
    want = np.fft.fft(f, axis=-1).T
    k, n = np.arange(M)[:, None], np.arange(Nh)[None, :]
    rms = np.sqrt((np.abs(want) ** 2).mean())
    for parity in (0, 1):
        got = _cross_mirror(f, M, parity)
        sign = np.where((k % 2 == 1) & ((n + parity) % 2 == 1), -1, 1)
        assert np.abs(got - sign * want).max() <= 1e-5 * rms, (M, parity)


@pytest.mark.parametrize("M", (4098, 6144, 8190, 8192) + MIRROR_WIDTHS)
@pytest.mark.parametrize("T", [8, 16])
def test_k4_reads_each_column_once_from_the_right_rank(M, T):
    """K4 in a cluster of C = 2 .. 8: the G·C blocks of a run split the
    P = M/2 columns into contiguous ranges of ceil(P / (G·C)) that cover
    each column exactly once (also where C does not divide P); column p
    reads
    F[(M - p) mod M] and F[P - p] from rank k // N at position k mod N
    (csrc synth_kernel's Fa, Fb), which is F's value there -- at odd C
    the two reads sit at positions N/2 apart, at even C at one."""
    C = _rule(M)
    N, P = M // C, M // 2
    G = K4.column_groups(M, T)
    B = G * C
    PC = -(-P // B)
    seen = np.zeros(P, np.int64)
    for blk in range(B):
        pg = blk * PC
        seen[pg: min(pg + PC, P)] += 1
    assert (seen == 1).all(), M
    F = np.random.default_rng(M).normal(size=M) + 0j
    planes = F.reshape(C, N)              # rank r holds F[rN .. rN+N-1]
    p = np.arange(P)
    ka = np.where((p > 0) & (p < P), M - p, 0)
    kb = P - p
    assert np.array_equal(planes[ka // N, ka % N], F[(M - p) % M])
    assert np.array_equal(planes[kb // N, kb % N], F[P - p])
    same = (ka % N == kb % N)[1:]
    assert same.all() if C % 2 == 0 else not same.any()


@pytest.mark.parametrize("M,T", [(8, 4), (768, 8), (2038, 17), (8192, 8),
                                 (16384, 8)])
def test_kernel_tables_fold_coefficients_equal_the_plain_versions(M, T):
    """The kernel path's fold coefficients (``_tables``, from the
    prototype alone) are the plain version's (``_analysis_consts``), bit
    for bit, without its dense transform matrices."""
    cpu = torch.device("cpu")
    coef, tw = KA._tables(M, T, cpu)
    assert coef.shape == (T, M) and coef.dtype == torch.float32
    assert torch.equal(coef, pp._analysis_consts(M, T, cpu)[0])
    assert torch.equal(tw, torch.as_tensor(KA._fft_twiddles(M)))
    if M >= 8192:                # free the dense matrices again
        _free_dense_tables()


@pytest.mark.parametrize("M", [2, 6, 8, 10, 768, 1458, 2038])
def test_dense_matrices_equal_their_entry_by_entry_formula(M):
    """The plain versions' dense DFT matrices, gathered from the unit
    circle's table in numpy and on the tensor's device (``_dft_mats_on``,
    ``_analysis_consts``), equal the entries computed one by one in
    float64 (amps_tpu.dsp.channelizer's formula), bit for bit."""
    k = np.arange(M)
    ang = 2.0 * np.pi * (np.outer(k, k) % M) / M
    cpu = torch.device("cpu")
    for C, S in (pp._dft_mats(M), pp._dft_mats_on(M, cpu)):
        assert np.array_equal(np.asarray(C), np.cos(ang).astype(np.float32))
        assert np.array_equal(np.asarray(S), np.sin(ang).astype(np.float32))
    P = M // 2
    kk, q = k[:, None], np.arange(P)[None, :]
    want = []
    for j in (P - 1 - q, M - 1 - q):
        a = 2.0 * np.pi * ((kk * j) % M) / M
        want += [np.cos(a).astype(np.float32), np.sin(a).astype(np.float32)]
    for got, on, w in zip(pp._dft_mats_folded_on(M, cpu),
                          pp._analysis_consts(M, 4, cpu)[1:5], want):
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), w)
        assert on.dtype == torch.float32 and np.array_equal(on.numpy(), w)


# ---- the port's plain K1 and K4 against the JAX package at 16384 ------

def _x_ext(M, T, Nh, seed, sigma=0.5):
    P = M // 2
    rng = np.random.default_rng(seed)
    x = rng.normal(0, sigma, (Nh * P, 2)).astype(np.float32)
    return np.concatenate([np.zeros((M * T - P, 2), np.float32), x])


def test_plain_k1_matches_jax_at_16384():
    """K1's plain version (the wrapper on a CPU tensor) against the JAX
    analysis, 6 hops of random IQ, both parities: atol 2e-4.  The JAX
    side folds by T shifted multiply-adds (``fold="shift"``), the same
    fold as its bank path, whose grouped convolution takes about a
    minute to compile at this width on one core."""
    M, T, Nh = 16384, 8, 6
    x = _x_ext(M, T, Nh, M)
    L, P = M * T, M // 2
    try:
        for parity in (0, 1):
            state = jchz.AnalyzerState(jnp.asarray(x[: L - P]), parity)
            want, _ = jchz.analyze(jnp.asarray(x[L - P:]),
                                   jchz.ChannelizerSpec(M, T), state,
                                   chmajor=True, fold="shift",
                                   planar=True)
            got = KA.analyze_block(torch.as_tensor(x), M, T, parity,
                                   planar=True).numpy()
            assert got.shape == want.shape == (2, M, Nh)
            assert np.abs(got - np.asarray(want)).max() < 2e-4, parity
    finally:                     # free the dense matrices again
        _free_dense_tables()


def test_plain_k4_matches_jax_at_16384():
    """K4's plain version (the wrapper on CPU tensors) against the JAX
    synthesis, 6 hops of random channel basebands with a random carry
    in, odd parity: output and new carry within atol 2e-4."""
    M, T, Nh, parity = 16384, 8, 6, 1
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
