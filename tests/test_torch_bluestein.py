"""Every even bank width up to 16384: the widths past 8192 that no
cluster of at most 8 blocks of at most 4096 channels splits (937 of the
4096 even widths in (8192, 16384]) computed as Bluestein's chirp
transform -- a circular convolution of length L = 32768 >= 2M - 1 on a
cluster of 8 blocks of 4096 points.

For a hop's M values x[n] and the chirp w[n] = e^{-jπn²/M},
  X[k] = w[k] sum_n (x[n] w[n]) conj(w[k - n]),
rank r of the cluster holds a[8m + r] = x[8m + r] w[8m + r] (zero past
M), the split transform of length L (an N = 4096-point plan on each
rank, then the radix-8 pass across the cluster) leaves A[rN + c] in rank
r, the spectral product Z = conj(A B) with the table's B = FFT_L(b) / L,
and the inverse pass, decimated in frequency, gives rank s
  V_s[c] = W_L^{s·c} sum_r W_8^{r·s} Z_r[c],
whose N-point transform is conj(z[8m + s]); channel k = 8m + s < M is
w[k] z[k].  On the CPU this holds: the width rule at every even M up to
32768, a numpy mirror of the mode in f32 generic in (M, C, N) against
numpy.fft, a mirror of K4's reads of the transform, the tables against
exact integers and float64, the geometry every library is held to, and
the port's plain K1 and K4 at 8194 against the JAX package's XLA
functions, with the JAX state carried across by ``convert``.  The CUDA
kernels are held to their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 34).

Tolerances: the mirror within 1e-5 of the output's RMS (f32 transforms,
as tests/test_torch_cluster_wide.py holds its mirror); tables within
1e-7 of float64 (one f32 rounding); the plain K1 and K4 within atol 2e-4
of the JAX package (tests/test_pallas.py's)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu_torch import convert
from amps_tpu_torch.dsp import channelizer as tchz
from amps_tpu_torch.dsp import polyphase as pp
from amps_tpu_torch.kernels import analysis as KA
from amps_tpu_torch.kernels import rx_phases as K3
from amps_tpu_torch.kernels import synth as K4

torch.set_num_threads(1)

L = 32768                 # the chirp transform's length past 8192
SMEM_BYTES = 232448       # shared memory a Hopper block may opt in to
PARK_BYTES = 65536        # K4's parked ring: 32 sums x 256 threads x 8 B
REFUSED = "Bluestein's chirp transform of length 32768"


def _split(M):
    """The cluster the split rule gives, counted afresh: 1 up to 4096,
    the smallest divisor C of M from 2 to 8 with M/C <= 4096 past it, 0
    where there is none."""
    if M <= 4096:
        return 1
    return min((C for C in range(2, 9) if M % C == 0 and M // C <= 4096),
               default=0)


def _unsplit(M):
    """An even M up to 16384 that no cluster splits: Bluestein's."""
    return M % 2 == 0 and 2 <= M <= 16384 and _split(M) == 0


# ---- (a) the width rule at every even M up to 32768 ---------------------

def test_bluestein_length_is_32768_exactly_at_the_unsplit_widths():
    """bluestein_length is L = 32768 at exactly the 937 even widths in
    (8192, 16384] no cluster splits (8194 the first, 16382 the last), 0
    at every other M; there the cluster is 8 blocks of 4096 points and a
    block holds ceil(M/8) channels; the split rule is unchanged (3159
    split widths in (8192, 16384], 3760 in (16384, 32768])."""
    unsplit = [M for M in range(-2, 32800) if _unsplit(M)]
    assert len(unsplit) == 937 and unsplit[0] == 8194 \
        and unsplit[-1] == 16382
    for M in range(-2, 32800):
        assert KA.bluestein_length(M) == (L if _unsplit(M) else 0), M
        if M > 0 and M % 2 == 0 and M <= 32768 and _split(M):
            assert KA.fft_cluster_size(M) == _split(M), M
            assert KA.cluster_blocks(M) == _split(M), M
    for M in unsplit:
        assert KA.fft_cluster_size(M) == 0
        assert KA.cluster_blocks(M) == 8 and KA.fft_plan_width(M) == 4096
        assert KA.fft_block_channels(M) == -(-M // 8)
        assert 2 * M - 1 <= L < 4 * M
        # no factor 2..7 of M/2 leaves a block width of 4096 or less
        assert M % 4 and all((M // 2) % q for q in (3, 5, 7)), M
    split = [M for M in range(8194, 32769, 2) if _split(M)]
    assert sum(M <= 16384 for M in split) == 3159
    assert sum(M > 16384 for M in split) == 3760


def test_check_fft_width_takes_every_even_width_to_16384():
    """check_fft_width takes all 8192 even widths from 2 to 16384 and,
    past it, every even width: in shared memory exactly the 3760 split
    widths in (16384, 32768], the others (unsplit, past 32768) through
    device memory; odd widths and M < 2 raise, naming every rule;
    FFT_WIDTHS lists the shared-memory widths."""
    shared = []
    for M in range(-3, 32800):
        if M > 0 and M % 2 == 0:
            KA.check_fft_width(M)
            if M <= 16384 or (M <= 32768 and _split(M) > 0):
                shared.append(M)
            else:
                assert KA.route_length(M), M
        else:
            with pytest.raises(ValueError, match=REFUSED) as e:
                KA.check_fft_width(M)
            assert "or M = C·N with C <= 8 and N <= 4096" in str(e.value)
    assert sum(M <= 16384 for M in shared) == 8192
    assert sum(M > 16384 for M in shared) == 3760
    assert KA.FFT_WIDTHS == tuple(shared)


@pytest.mark.parametrize("M", [16388, 16396, 16402, 32770, 8193, 16383])
def test_widths_past_both_rules_are_refused(M):
    """Odd widths and M < 2 raise; 16388 = 4·17·241 (the first unsplit
    width past 16384), 16396 = 4·4099, 16402 = 2·59·139 and 32770 (past
    32768), past both shared-memory rules, are taken through device
    memory (L = 65536, and 131072 at 32770)."""
    if M % 2:
        with pytest.raises(ValueError, match=REFUSED):
            KA.check_fft_width(M)
    else:
        KA.check_fft_width(M)
        assert KA.route_length(M) == (65536 if M < 32768 else 131072)
    for refused in (0, 1 - M):
        with pytest.raises(ValueError, match=REFUSED):
            KA.check_fft_width(refused)


def test_bluestein_geometry_every_width():
    """At every unsplit width: K1-K3 hold six hops of a 4096-point plane
    (202,800 bytes, as at M = 4096), K3 owns 3 at sps = 3, K4 parks its
    ring of 32 sums beside 4 hops of plane and its groups of 8 blocks
    cover the P = M/2 columns, at most 2 columns a thread (1 with the
    ring of 16) -- counted afresh, as csrc fft_fit_hops, run_hops,
    synth_hops, synth_thread_columns and synth_groups count them."""
    row = 8 * (4096 + 4096 // 32 + 1)
    for M in KA.FFT_WIDTHS:
        if not _unsplit(M):
            continue
        P = M // 2
        assert KA.FFT_TILE_HOPS[M] == KA.FFT_WIDE_HOPS[M] == 6, M
        assert KA.fft_smem_bytes(M, 6) == 6 * row == 202800, M
        assert K3.run_hops(M, 3) == 3, M
        assert K4.park_bytes(M) == PARK_BYTES and K4.SYNTH_HOPS[M] == 4, M
        assert K4.smem_bytes(M) == 4 * row + PARK_BYTES <= SMEM_BYTES, M
        for T, ring in ((8, 16), (16, 32)):
            cols = min(-(-(P // 8) // 256), 2 if T == 8 else 1)
            G = -(-P // (8 * 256 * cols))
            assert K4.thread_columns(M, T) == cols, (M, T)
            assert K4.column_groups(M, T) == G, (M, T)
            assert -(-(-(-P // (G * 8))) // 256) * ring == 32, (M, T)
    assert K4.column_groups(8194, 8) == K4.column_groups(16382, 8) == 2


# ---- (b) a numpy mirror of the mode in f32 ------------------------------

def _tables(M, C, N):
    """The mode's tables for a cluster of C blocks of N points (L = C·N),
    as ``kernels.analysis`` lays them out at 32768, in float64: W_L^{s·c}
    (s = 1 .. C-1, c < N), W_C^e, the chirp's C rows of ceil(M/C) (row
    r: w[C·c + r], zero past M) and B = FFT_L(b) / L."""
    Lc = C * N
    NC = -(-M // C)
    s, c = np.meshgrid(np.arange(1, C), np.arange(N), indexing="ij")
    wt = np.exp(-2j * np.pi * (s * c) / Lc)
    wc = np.exp(-2j * np.pi * np.arange(C) / C)
    n = np.arange(M, dtype=np.int64)
    w = np.exp(-1j * np.pi * (n * n % (2 * M)) / M)
    rows = np.zeros((C, NC), np.complex128)
    rows[n % C, n // C] = w
    b = np.zeros(Lc, np.complex128)
    b[:M] = np.conj(w)
    b[Lc - n[1:]] = np.conj(w[1:])
    return wt, wc, rows, np.fft.fft(b) / Lc


def _c64(a):
    return np.asarray(a).astype(np.complex64)


def _bluestein_mirror(f, M, C, N, parity, tables=None):
    """The tile's Bluestein mode on hop rows f (Nh, M) in f32, as csrc
    FftTile computes it: chirp_in (rank r's a[C·m + r], zero past M),
    each rank's N-point transform, cross (W_L^{r·c} in place, then the
    radix-C sum, s ascending), icross (conj(A·B) in place, the radix-C
    sum with W_C^{r·s}, r ascending, then W_L^{s·c}), each rank's
    N-point transform, chirp_out (conj times the chirp) on its decimated
    channels C·m + s < M, the hop sign (-1)^{k(n+parity)}.  Returns (M,
    Nh) complex64, channel-major."""
    wt, wc, rows, bh = (_c64(t) for t in (tables or _tables(M, C, N)))
    NC = rows.shape[1]
    Nh = f.shape[0]
    planes = []
    for r in range(C):                                   # chirp_in
        a = np.zeros((Nh, N), np.complex64)
        k = C * np.arange(NC) + r
        live = k < M
        a[:, :NC][:, live] = _c64(f[:, k[live]]) * rows[r, live]
        planes.append(a)
    G = [_c64(np.fft.fft(p, axis=-1)) for p in planes]   # passes
    G = [g if s == 0 else _c64(g * wt[s - 1]) for s, g in enumerate(G)]
    A = []
    for r in range(C):                                   # cross
        acc = G[0].copy()
        for s in range(1, C):
            acc = _c64(acc + _c64(G[s] * wc[s * r % C]))
        A.append(acc)
    Z = [np.conj(_c64(A[r] * bh[r * N:(r + 1) * N])) for r in range(C)]
    out = np.zeros((M, Nh), np.complex64)
    for s in range(C):                                   # icross
        acc = Z[0].copy()
        for r in range(1, C):
            acc = _c64(acc + _c64(Z[r] * wc[r * s % C]))
        V = acc if s == 0 else _c64(acc * wt[s - 1])
        zc = _c64(np.fft.fft(V, axis=-1))                # passes
        k = C * np.arange(NC) + s
        live = k < M
        out[k[live]] = _c64(np.conj(zc[:, :NC][:, live]) * rows[s, live]).T
    k, n = np.arange(M)[:, None], np.arange(Nh)[None, :]
    return np.where((k % 2 == 1) & ((n + parity) % 2 == 1), -out, out)


@pytest.mark.parametrize("M,C,N", [(50, 8, 16), (190, 4, 128), (8194, 8, 4096),
                                   (16382, 8, 4096)])
def test_bluestein_mirror_matches_numpy_fft(M, C, N):
    """The f32 mirror of the mode equals numpy.fft (float64) of the hop
    rows, with the hop sign, within 1e-5 of the output's RMS at both hop
    parities: small clusters (L = 128 for M = 50, 512 for M = 190) and
    the card's (L = 32768) at the first and the last unsplit width."""
    Nh = 3
    rng = np.random.default_rng(M)
    f = rng.normal(0, 1, (Nh, M)) + 1j * rng.normal(0, 1, (Nh, M))
    want = np.fft.fft(f, axis=-1).T
    rms = np.sqrt((np.abs(want) ** 2).mean())
    k, n = np.arange(M)[:, None], np.arange(Nh)[None, :]
    for parity in (0, 1):
        got = _bluestein_mirror(f, M, C, N, parity)
        sign = np.where((k % 2 == 1) & ((n + parity) % 2 == 1), -1, 1)
        assert np.abs(got - sign * want).max() <= 1e-5 * rms, (M, parity)


@pytest.mark.parametrize("M", [8198, 13334])
def test_bluestein_mirror_on_the_kernel_tables(M):
    """The mirror run on the f32 table the wrapper hands the kernels
    (``_fft_twiddles``: L's table, then the chirp's rows, then B) equals
    numpy.fft of folded windows, with the hop sign, within 1e-5 of the
    output's RMS."""
    T, Nh = 8, 3
    P = M // 2
    tw = KA._fft_twiddles(M).astype(np.float64)
    tw = tw[:, 0] + 1j * tw[:, 1]
    NC = KA.fft_block_channels(M)
    head = len(KA.fft_twiddle_exponents(4096))
    tables = (tw[head: head + 7 * 4096].reshape(7, 4096),
              tw[head + 7 * 4096: head + 7 * 4096 + 8],
              tw[-L - 8 * NC: -L].reshape(8, NC), tw[-L:])
    x = np.random.default_rng(M).normal(
        0, 0.5, ((Nh + 2 * T - 1) * P, 2)).astype(np.float32)
    coef = KA._tables(M, T, torch.device("cpu"))[0].numpy().astype(np.float64)
    z = x[:, 0].astype(np.float64) + 1j * x[:, 1]
    f = np.zeros((Nh, M), np.complex128)
    for t in range(T):
        f += coef[t][None, :] * z[np.arange(Nh)[:, None] * P + t * M
                                  + np.arange(M)[None, :]]
    want = np.fft.fft(f, axis=-1).T
    k, n = np.arange(M)[:, None], np.arange(Nh)[None, :]
    sign = np.where((k % 2 == 1) & (n % 2 == 1), -1, 1)
    got = _bluestein_mirror(f, M, 8, 4096, 0, tables)
    rms = np.sqrt((np.abs(want) ** 2).mean())
    assert np.abs(got - sign * want).max() <= 1e-5 * rms


# ---- (c) K4's reads of the transform -------------------------------------

@pytest.mark.parametrize("M", [8194, 8198, 13334, 16378, 16382])
@pytest.mark.parametrize("T", [8, 16])
def test_k4_reads_each_column_once_from_rank_k_mod_8(M, T):
    """K4 at an unsplit width: the G·8 blocks of a run split the P = M/2
    columns into contiguous ranges that cover each column once; column p
    reads F[(M - p) mod M] and F[P - p] from rank k mod 8 at position k
    // 8 (csrc Tile::owner, Tile::slot), which is F's value there, and no
    read falls on a position that holds no channel (k >= M)."""
    C, P, NC = 8, M // 2, KA.fft_block_channels(M)
    G = K4.column_groups(M, T)
    PC = -(-P // (G * C))
    seen = np.zeros(P, np.int64)
    for blk in range(G * C):
        seen[blk * PC: min(blk * PC + PC, P)] += 1
    assert (seen == 1).all(), M
    F = np.random.default_rng(M).normal(size=M) + 0j
    planes = np.full((C, NC), np.nan + 0j)     # no channel: NaN
    k = np.arange(M)
    planes[k % C, k // C] = F
    p = np.arange(P)
    ka = np.where((p > 0) & (p < P), M - p, 0)
    kb = P - p
    assert ka.max() < M and kb.max() < M
    assert np.array_equal(planes[ka % C, ka // C], F[(M - p) % M])
    assert np.array_equal(planes[kb % C, kb // C], F[P - p])


# ---- (d) the tables ------------------------------------------------------

@pytest.mark.parametrize("M", [8194, 8198, 13334, 16378, 16382])
def test_bluestein_tables_against_exact_integers_and_float64(M):
    """n² mod 2M is Python's exact integer at every n < M; the f32
    chirp rows the kernels read are within 1e-7 of float64 e^{-jπn²/M}
    (rank r's row c: n = 8c + r, zero past M); B is within 1e-7 (of its
    largest value) of a float64 FFT of the conjugate chirp wrapped to
    length L; L's own table leads, as at the split width 32768."""
    n = np.arange(M)
    assert np.array_equal(KA.bluestein_exponents(M),
                          [i * i % (2 * M) for i in range(M)])
    tw = KA._fft_twiddles(M).astype(np.float64)
    tw = tw[:, 0] + 1j * tw[:, 1]
    lead = KA._fft_twiddles(L).astype(np.float64)
    assert np.array_equal(tw[: len(lead)], lead[:, 0] + 1j * lead[:, 1])
    NC = KA.fft_block_channels(M)
    assert len(tw) == len(lead) + 8 * NC + L
    exact = np.array([np.exp(-1j * np.pi * (i * i % (2 * M)) / M)
                      for i in range(M)])
    rows = tw[len(lead): len(lead) + 8 * NC].reshape(8, NC)
    want = np.zeros((8, NC), np.complex128)
    want[n % 8, n // 8] = exact
    assert np.abs(rows - want).max() < 1e-7
    b = np.zeros(L, np.complex128)
    b[:M] = np.conj(exact)
    b[L - n[1:]] = np.conj(exact[1:])
    bh = np.fft.fft(b) / L
    assert np.abs(tw[-L:] - bh).max() < 1e-7 * np.abs(bh).max()


def test_kernel_tables_fold_coefficients_at_8194():
    """The kernel path's fold coefficients at 8194 are the plain
    version's, bit for bit (without its dense matrices)."""
    cpu = torch.device("cpu")
    coef, tw = KA._tables(8194, 8, cpu)
    assert torch.equal(coef, pp._analysis_consts(8194, 8, cpu)[0])
    assert torch.equal(tw, torch.as_tensor(KA._fft_twiddles(8194)))
    pp._analysis_consts.cache_clear()


# ---- (e) the plain K1 and K4 at 8194 against the JAX package -------------

@pytest.fixture
def no_persistent_cache():
    """JAX's compilation cache off for the test: the dense executables at
    8194 hold their (M, M) tables as constants, whose serialization would
    double the test's memory and write them to the cache directory."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", was)


def test_plain_k1_k4_and_carried_state_match_jax_at_8194(no_persistent_cache):
    """At M = 8194 (JAX's dense (M, M) DFT pair, the port's dense plain
    versions), two streamed blocks of 3 hops (odd, so the second starts
    at odd parity): K1's plain version on the first block
    against the JAX analysis (``fold="shift"``), K4's with a random carry
    in against the JAX synthesis; then the JAX analyzer and synthesizer
    state carried across (``convert.analyzer_state_from_numpy``, and
    ``convert.closed_loop_state_from_numpy`` for the synthesis carry
    with the history) continues as the port's second block: all within
    atol 2e-4."""
    M, T = 8194, 8
    P = M // 2
    rng = np.random.default_rng(M)
    cpu = torch.device("cpu")
    # blocks of one shape, so that XLA compiles each function once
    x1, x2 = (rng.normal(0, 0.5, (3 * P, 2)).astype(np.float32)
              for _ in range(2))
    Y1, Y2 = (rng.normal(0, 1, (3, M, 2)).astype(np.float32)
              for _ in range(2))
    carry = rng.normal(0, 0.1, (M * T - P, 2)).astype(np.float32)
    spec, tspec = jchz.ChannelizerSpec(M, T), tchz.ChannelizerSpec(M, T)
    try:
        # the JAX side first, whose dense tables are then freed
        st0 = jchz.analyzer_init(spec)
        y1, st1 = jchz.analyze(jnp.asarray(x1), spec, st0, chmajor=True,
                               fold="shift", planar=True)
        y2, _ = jchz.analyze(jnp.asarray(x2), spec, st1, chmajor=True,
                             fold="shift", planar=True)
        s1, ss1 = jchz.synthesize(jnp.asarray(Y1), spec,
                                  jchz.SynthesizerState(jnp.asarray(carry), 0))
        s2, _ = jchz.synthesize(jnp.asarray(Y2), spec, ss1)
        y1, y2, s1, s2, hist1, carry1 = map(np.asarray, (
            y1, y2, s1, s2, st1.history, ss1.carry))
        jax.clear_caches()
        jchz._dft_mats.cache_clear()
        x_ext = np.concatenate([np.zeros((M * T - P, 2), np.float32), x1])
        got = KA.analyze_block(torch.as_tensor(x_ext), M, T, 0, planar=True)
        assert got.shape == (2, M, 3)
        assert np.abs(got.numpy() - y1).max() < 2e-4
        o1, c1 = K4.synthesize_block(torch.as_tensor(Y1), M, T, 0,
                                     torch.as_tensor(carry))
        np.testing.assert_allclose(o1.numpy(), s1, atol=2e-4)
        np.testing.assert_allclose(c1.numpy(), carry1, atol=2e-4)
        ast = convert.analyzer_state_from_numpy(hist1, st1.hop_idx,
                                                device=cpu)
        assert ast.hop_idx == 3
        g2, _ = tchz.analyze(torch.as_tensor(x2), tspec, ast, chmajor=True,
                             planar=True)
        assert np.abs(g2.numpy() - y2).max() < 2e-4
        st = convert.closed_loop_state_from_numpy(
            carry1, hist1, np.zeros((M, 1), np.float32),
            np.zeros((M, 2), np.float32), device=cpu)
        assert torch.equal(st["hist"], ast.history)
        o2, _ = tchz.synthesize(torch.as_tensor(Y2), tspec,
                                tchz.SynthesizerState(st["syn_carry"],
                                                      ss1.hop_idx))
        np.testing.assert_allclose(o2.numpy(), s2, atol=2e-4)
    finally:                     # free the dense matrices again
        pp._analysis_consts.cache_clear()
        jchz._dft_mats.cache_clear()
