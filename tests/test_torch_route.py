"""Every even bank width: the device-memory route of the four kernels
(``kernels.route``, csrc/route.cu) for the even widths no
in-shared-memory mode of the FFT tile takes -- the 4432 unsplit even
widths in (16384, 32768] and every M past 32768.

A chunk of hops is folded (K1-K3) or loaded (K4) into a plane of L values
a hop in device memory, L = ``route_length(M)``: M where M is a power of
two (direct), else the least power of two >= 2M - 1 (Bluestein: X[k] =
w[k] conj(FFT_L(conj(FFT_L(a) · B̂)))[k], a[n] = x[n] w[n], the chirp w[n]
= e^{-jπn²/M}, B̂ = FFT_L(b) / L of the conjugate chirp).  Each FFT_L is a
Stockham FFT of passes of radix ``route_radices(L)`` between two planes:
butterfly j reads R values at stride L/R, multiplies value r by W_L^{(j
mod Ns)·r·L/(Ns·R)}, runs the R-point DFT and writes value r at
(j/Ns)·Ns·R + j mod Ns + r·Ns.  Then each kernel's epilogue.

On the CPU this holds: the width rule at every even M to 65536 and
sampled to 2^24; an f32 numpy mirror of the transform generic in the
radices (two and three passes at small L, the card's plan at 16388 and
32770) against numpy.fft; mirrors of K2's, K3's and K4's chunked
epilogues against their plain versions; the tables against exact
integers and float64; the plain versions' float64 FFT form past 32768
against the JAX package, and the JAX state carried across by
``convert`` at 32896.  The CUDA kernels are held to their plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py phase 35).

Tolerances: the transform's mirror within 1e-5 of the output's RMS (f32
passes, as the cluster mirrors); the epilogue mirrors within 1e-5 of
RMS (K4) or 1e-6 rad and 1e-6 relative (K2, K3: the same values summed
in another f32 order); the tables within 1e-7 of float64; the plain
versions within atol 2e-4 of the JAX package (tests/test_pallas.py's)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu_torch import convert
from amps_tpu_torch.dsp import channelizer as tchz
from amps_tpu_torch.dsp.fm import fast_atan2
from amps_tpu_torch.dsp.polyphase import prototype_taps
from amps_tpu_torch.kernels import analysis as KA
from amps_tpu_torch.kernels import route
from amps_tpu_torch.kernels import rx_front as K2
from amps_tpu_torch.kernels import rx_phases as K3

torch.set_num_threads(1)


def _split(M):
    """The cluster the split rule gives, counted afresh (0: none)."""
    if M <= 4096:
        return 1
    return min((C for C in range(2, 9) if M % C == 0 and M // C <= 4096),
               default=0)


def _shared(M):
    """An even M the shared-memory modes take: up to 16384 (split or
    Bluestein), past it the split widths up to 32768."""
    return M % 2 == 0 and 2 <= M <= 32768 and (M <= 16384 or _split(M) > 0)


def _pow2_at_least(n):
    p = 1
    while p < n:
        p *= 2
    return p


# ---- (a) the width rule -------------------------------------------------

def test_route_length_at_every_even_width_to_65536():
    """route_length is 65536 at exactly the 4432 unsplit even widths in
    (16384, 32768] (16388 the first, 32766 the last), 0 on FFT_WIDTHS and
    at odd M and M < 2, 131072 from 32770 to 65534 and 65536 at 65536
    (a power of two: direct)."""
    unsplit = [M for M in range(16386, 32769, 2) if not _split(M)]
    assert len(unsplit) == 4432 and unsplit[0] == 16388 \
        and unsplit[-1] == 32766
    shared = set(KA.FFT_WIDTHS)
    for M in range(-3, 65537):
        L = KA.route_length(M)
        if M % 2 or M < 2 or _shared(M):
            assert L == 0, M
            assert (M in shared) == _shared(M), M
        elif M <= 32768:
            assert L == 65536, M
        else:
            assert L == (65536 if M == 65536 else 131072), M


def test_route_length_past_32768_sampled_to_2_24():
    """Past 32768: L = M at every power of two, else the least power of
    two >= 2M - 1, at 20000 even widths drawn up to 2^24 and at each
    side of every power of two from 2^16 to 2^24."""
    rng = np.random.default_rng(18)
    widths = set((2 * rng.integers(16385, 1 << 23, 20000)).tolist())
    for b in range(16, 25):
        widths |= {(1 << b) - 2, 1 << b, (1 << b) + 2}
    for M in sorted(widths):
        L = KA.route_length(M)
        if M & (M - 1) == 0:
            assert L == M, M
        else:
            assert L == _pow2_at_least(2 * M - 1) and L < 4 * M, M
            assert L >= 2 * M - 1
    assert KA.route_length(32770) == 131072
    assert KA.route_length(1048574) == 1 << 21
    assert KA.route_length(8388610) == 1 << 25


def test_check_fft_width_takes_every_even_width():
    """check_fft_width takes every even M from 2 to 65536 and sampled
    even widths to 2^24 (each on one of the rules), and refuses odd M
    and M < 2 naming every rule."""
    for M in list(range(2, 65537, 2)) + [1048574, 8388610, 1 << 24]:
        KA.check_fft_width(M)
        assert bool(KA.route_length(M)) != (M in KA.FFT_WIDTHS), M
    for M in (-4, -1, 0, 1, 7, 8193, 16383, 32769, 65537, 8388609):
        with pytest.raises(ValueError, match="any other even M >= 2 through "
                                             "device memory") as e:
            KA.check_fft_width(M)
        assert "or M = C·N with C <= 8 and N <= 4096" in str(e.value)
        assert "Bluestein's chirp transform of length 32768" in str(e.value)


def test_route_plan():
    """The radices: powers of two from 256 to 4096 whose product is L,
    ceil(k / 12) of them, as even as the bits go (two passes up to 2^24,
    three past it); with a small max_radix, the mirror's plans."""
    for k in range(16, 31):
        rad = KA.route_radices(1 << k)
        assert int(np.prod(rad)) == 1 << k and len(rad) == -(-k // 12)
        assert all(256 <= R <= 4096 for R in rad), (k, rad)
        assert max(rad) <= 2 * min(rad), (k, rad)
    assert KA.route_radices(65536) == (256, 256)
    assert KA.route_radices(1 << 21) == (2048, 1024)
    assert KA.route_radices(1 << 24) == (4096, 4096)
    assert KA.route_radices(1 << 25) == (512, 256, 256)
    assert KA.route_radices(128, 8) == (8, 4, 4)
    assert KA.route_radices(128, 16) == (16, 8)
    assert route.RADICES == (256, 512, 1024, 2048, 4096)
    assert [route.route_hops(R) for R in route.RADICES] == [16, 16, 16, 8, 4]


def test_route_geometry_and_launches():
    """The scratch: two planes of rows of L values within 1 GiB (1024
    rows at L = 65536, 2 at 2^25); a call's chunks and CUDA launches (a
    fold or load, the passes, twice in the Bluestein mode, an epilogue a
    chunk; K2 and K3 hold the hop behind each chunk)."""
    assert route.scratch_rows(65536) == 1024
    assert route.scratch_rows(1 << 25) == 2
    assert route.chunks(32766, 8192, 0) == 8
    assert route.chunks(32766, 8192, 1) == 9
    assert route.launches(32766, 8192, 0) == 8 * (2 + 4)
    assert route.launches(65536, 8192, 1) == 9 * (2 + 2)
    assert route.launches(8388610, 5, 1) == 5 * (2 + 6)
    for M in (16388, 32766, 32770, 65536, 1048574, 8388610):
        L = KA.route_length(M)
        assert 2 * route.scratch_rows(L) * L * 8 <= route.SCRATCH_BYTES


# ---- (b) an f32 numpy mirror of the transform ----------------------------

def _c64(a):
    return np.asarray(a).astype(np.complex64)


def _route_fft(a, L, radices, twl):
    """FFT_L of each row of a (rows, L) complex64 as the route's passes
    run it (csrc route_pass_kernel) in f32: butterfly j of pass p reads
    R values at stride L/R, multiplies value r by W_L^{(j mod Ns)·r·L/
    (Ns·R)} from the f32 table twl, runs the R-point DFT and writes value
    r at (j/Ns)·Ns·R + j mod Ns + r·Ns."""
    Ns = 1
    for R in radices:
        nb = L // R
        j = np.arange(nb)
        r = np.arange(R)
        v = a[:, j[:, None] + r[None, :] * nb]
        v = _c64(v * twl[(j % Ns)[:, None] * r[None, :] * (L // (Ns * R))])
        v = _c64(np.fft.fft(v, axis=-1))
        out = np.empty_like(a)
        out[:, (j // Ns * Ns * R + j % Ns)[:, None] + r[None, :] * Ns] = v
        a, Ns = out, Ns * R
    return a


def _route_length(M):
    """The route's L for any even M (the mirror runs it at small M too)."""
    return M if M & (M - 1) == 0 else _pow2_at_least(2 * M - 1)


def _route_dft(f, M, max_radix=4096):
    """The route's M-point DFT of each row of f (rows, M) in f32, on the
    wrapper's f32 tables: direct, or Bluestein's chirp_in, FFT_L, conj(A·
    B̂), FFT_L, chirp_out."""
    L = _route_length(M)
    radices = KA.route_radices(L, max_radix)
    tw = route.twiddles_l(L)
    twl = _c64(tw[:, 0] + 1j * tw[:, 1])
    if L == M:
        return _route_fft(_c64(f), L, radices, twl)
    w = _c64(route.chirp(M))
    bh = _c64(route.bhat(M, L))
    a = np.zeros((f.shape[0], L), np.complex64)
    a[:, :M] = _c64(_c64(f) * w)
    A = _route_fft(a, L, radices, twl)
    Z = _route_fft(np.conj(_c64(A * bh)), L, radices, twl)
    return _c64(np.conj(Z[:, :M]) * w)


@pytest.mark.parametrize("M,max_radix,passes", [
    (50, 8, 3), (50, 16, 2), (190, 8, 3), (512, 8, 3), (4096, 64, 2),
    (16388, 4096, 2), (32770, 4096, 2)])
def test_route_mirror_matches_numpy_fft(M, max_radix, passes):
    """The f32 mirror of the route equals numpy.fft (float64) within 1e-5
    of the output's RMS: Bluestein at M = 50 (L = 128) and 190 (L = 512)
    in three passes of radix <= 8 and two of radix <= 16, direct at 512
    (three passes) and 4096 (two), and the card's plans at 16388 (L =
    65536, 256 · 256) and 32770 (L = 131072, 512 · 256)."""
    L = _route_length(M)
    assert len(KA.route_radices(L, max_radix)) == passes
    rng = np.random.default_rng(M + max_radix)
    rows = 2 if M > 4096 else 3
    f = rng.normal(0, 1, (rows, M)) + 1j * rng.normal(0, 1, (rows, M))
    want = np.fft.fft(f, axis=-1)
    got = _route_dft(f, M, max_radix)
    rms = np.sqrt((np.abs(want) ** 2).mean())
    assert np.abs(got - want).max() <= 1e-5 * rms, M


# ---- (c) the chunked epilogues against the plain versions ----------------

def _hop_planes(x_ext, M, T, parity):
    """The plain analysis (M, Nh) complex64 (hop sign included): the
    values the epilogues read, here exact to f32."""
    y = KA.analyze_reference(torch.as_tensor(x_ext), M, T, parity,
                             planar=True).numpy()
    return _c64(y[0] + 1j * y[1])


def _product(c, q):
    """The discriminator's product (csrc route_product) in f32."""
    f = np.float32
    re = (c.real * q.real).astype(f) + (c.imag * q.imag).astype(f)
    im = (c.imag * q.real).astype(f) - (c.real * q.imag).astype(f)
    return re.astype(f), im.astype(f)


def _front_mirror(y, prev, rows):
    """K2's route epilogue in chunks of rows - 1 hops, each plane holding
    the hop behind it (recomputed) and the stream's hop -1 = prev."""
    M, Nh = y.shape
    demod = np.zeros((M, Nh), np.float32)
    pw = np.zeros((M, Nh), np.float32)
    for n0 in range(0, Nh, rows - 1):
        plane = np.stack([y[:, n] if n >= 0 else np.zeros(M, np.complex64)
                          for n in range(n0 - 1, min(n0 + rows - 1, Nh))], 1)
        for l in range(plane.shape[1] - 1):
            n = n0 + l
            q = plane[:, l] if n else prev
            re, im = _product(plane[:, l + 1], q)
            demod[:, n] = fast_atan2(torch.as_tensor(im),
                                     torch.as_tensor(re)).numpy()
            pw[:, n] = re * re + im * im
    return demod, y[:, -1], pw


def _phases_mirror(y, sps, rows):
    """K3's route epilogue in chunks of rows - 1 hops: each phase's
    symbol sum and the 384-hop power sum carried from chunk to chunk in
    hop order (csrc route_phases_out)."""
    M, Nh = y.shape
    nsym = (Nh - sps + 1) // sps
    ph = np.zeros((M, sps, nsym), np.float32)
    nblk = -(-Nh // 384)
    pw_blk = np.zeros((M, nblk), np.float32)
    acc = np.zeros((M, sps), np.float32)
    s = np.zeros(M, np.float32)
    w = np.float32(1.0 / sps)
    for n0 in range(0, Nh, rows - 1):
        for n in range(n0, min(n0 + rows - 1, Nh)):
            q = y[:, n - 1] if n else np.zeros(M, np.complex64)
            re, im = _product(y[:, n], q)
            d = fast_atan2(torch.as_tensor(im), torch.as_tensor(re)).numpy()
            for p in range(sps):
                if n >= p:
                    acc[:, p] = acc[:, p] + (d * w).astype(np.float32)
                    if (n - p) % sps == sps - 1:
                        if (n - p) // sps < nsym:
                            ph[:, p, (n - p) // sps] = acc[:, p]
                        acc[:, p] = 0
            if n % 384 == 0:
                s[:] = 0
            s = (s + (re * re + im * im).astype(np.float32)).astype(
                np.float32)
            if n % 384 == 383 or n == Nh - 1:
                pw_blk[:, n // 384] = s / np.float32(384)
    return ph, pw_blk


@pytest.mark.parametrize("rows", [2, 5, 1000])
def test_front_and_phases_epilogues_in_chunks(rows):
    """K2's and K3's route epilogues, chunked (a plane of 2 rows: one new
    hop a chunk; 5; the whole block), on the plain analysis's values
    equal the plain K2 and K3 (the same products, fast_atan2, the
    symbols' and the 384-hop blocks' sums in another f32 order) within
    1e-6 rad and 1e-6 relative; K2's hop -1 is prev, K3's zero."""
    M, T, Nh, sps = 16, 4, 801, 3
    rng = np.random.default_rng(rows)
    x = rng.normal(0, 0.5, ((Nh + 2 * T - 1) * M // 2, 2)).astype(np.float32)
    prev = rng.normal(0, 1, (M, 2)).astype(np.float32)
    for parity in (0, 1):
        y = _hop_planes(x, M, T, parity)
        d, last, pw = _front_mirror(y, _c64(prev[:, 0] + 1j * prev[:, 1]),
                                    rows)
        rd, rlast, rpw = K2.analyze_demod_reference(
            torch.as_tensor(x), M, T, parity, torch.as_tensor(prev))
        assert np.abs(d - rd.numpy()).max() <= 1e-6
        assert np.abs(pw - rpw.numpy()).max() <= 1e-6 * rpw.abs().max()
        assert np.array_equal(np.stack([last.real, last.imag], -1),
                              rlast.numpy())
        ph, pb = _phases_mirror(y, sps, rows)
        rph, _, rpb = K3.analyze_phases_reference(torch.as_tensor(x), M, T,
                                                  sps, parity)
        assert ph.shape == tuple(rph.shape) and pb.shape == tuple(rpb.shape)
        assert np.abs(ph - rph.numpy()).max() <= 1e-6
        assert (np.abs(pb - rpb.numpy()) / rpb.numpy()).max() <= 1e-6


def _synth_mirror(Y, M, T, parity, carry, rows):
    """K4 on the route in chunks of rows input hops (csrc
    route_synth_out): F_n = FFT_M(Y_n); output hop b sums gP[jP + p]
    u_{b-j}[(j&1)P + p] over the chunk's input hops n = b - j in order,
    from the unfinished sum an earlier chunk left in the output; a
    finished hop gets the carry-in (b < 2T - 1)."""
    P, Nh, keep = M // 2, Y.shape[0], 2 * T - 1
    gm = (prototype_taps(M, T) * np.float32(P)).astype(np.float32)
    F = _c64(np.fft.fft(Y[..., 0] + 1j * Y[..., 1], axis=-1))
    cin = _c64(carry[:, 0] + 1j * carry[:, 1]).reshape(keep, P)
    out = np.zeros((Nh + keep, P), np.complex64)
    p = np.arange(P)
    ka, kb = np.where(p > 0, M - p, 0), P - p
    for c0 in range(0, Nh, rows):
        c1 = min(c0 + rows, Nh)
        for b in range(c0, min(c1 + keep, Nh + keep)):
            acc = out[b] if max(0, b - keep) < c0 else np.zeros(
                P, np.complex64)
            for n in range(max(c0, b - keep), min(c1 - 1, b) + 1):
                j, odd = b - n, (n + parity) & 1
                fa, fb = F[n, ka], F[n, kb]
                u = (fa if odd else fb) if j & 1 else (fb if odd else fa)
                acc = _c64(acc + gm[j * P: j * P + P] * u)
            if (b < c1 or c1 == Nh) and b < keep:
                acc = _c64(acc + cin[b])
            out[b] = acc
    flat = np.stack([out.real, out.imag], -1).reshape(-1, 2)
    return flat[: Nh * P], flat[Nh * P:]


@pytest.mark.parametrize("rows", [1, 3, 1000])
@pytest.mark.parametrize("T", [3, 4])
def test_synth_overlap_add_in_chunks(rows, T):
    """K4's route overlap-add in chunks (one hop, three, the whole
    block) with a carry-in equals the plain synthesis within 1e-5 of the
    output's RMS at both parities, and two chained calls (the first's
    carry in) equal one."""
    M, Nh = 16, 23
    rng = np.random.default_rng(rows * 10 + T)
    Y = rng.normal(0, 1, (Nh, M, 2)).astype(np.float32)
    carry = rng.normal(0, 1, (M * T - M // 2, 2)).astype(np.float32)
    for parity in (0, 1):
        o, c = _synth_mirror(Y, M, T, parity, carry, rows)
        ro, rc = tchz._synthesize_block(torch.as_tensor(Y), M, T, parity,
                                        torch.as_tensor(carry))
        rms = ro.pow(2).mean().sqrt().item()
        assert np.abs(o - ro.numpy()).max() <= 1e-5 * rms
        assert np.abs(c - rc.numpy()).max() <= 1e-5 * rms
    h = 10
    oa, ca = _synth_mirror(Y[:h], M, T, 0, carry, rows)
    ob, cb = _synth_mirror(Y[h:], M, T, h % 2, ca, rows)
    o, c = _synth_mirror(Y, M, T, 0, carry, rows)
    rms = np.sqrt((o ** 2).mean())
    assert np.abs(np.concatenate([oa, ob]) - o).max() <= 1e-5 * rms
    assert np.abs(cb - c).max() <= 1e-5 * rms


# ---- (d) the tables ------------------------------------------------------

def test_chirp_exponents_exact_near_2_23():
    """n² mod 2M in exact 64-bit integers at M = 8388610 (n² passes 2^53
    near 9.5e7, 2^31 from 46341): Python's integers agree at n near
    2^23, at the top and at random n."""
    M = 8388610
    e = KA.bluestein_exponents(M)
    rng = np.random.default_rng(23)
    idx = list(range(46339, 46343)) + list(range((1 << 23) - 3,
                                                 (1 << 23) + 2)) + \
        list(range(M - 3, M)) + rng.integers(0, M, 200).tolist()
    for n in idx:
        assert int(e[n]) == n * n % (2 * M), n


@pytest.mark.parametrize("M", [16388, 32766, 32770])
def test_route_tables_against_float64(M):
    """The f32 tables the kernels read: the chirp within 1e-7 of float64
    e^{-jπn²/M} (n² mod 2M from Python's integers), B̂ within 1e-7 (of
    its largest value) of a float64 FFT of the conjugate chirp wrapped to
    L, W_L within 1e-7 of e^{-j2πe/L}, and the tile tables of the radices
    256 .. 4096 those of the FFT tile at each width."""
    L = KA.route_length(M)
    dev = torch.device("cpu")
    got_L, twl, tile, w, bh = route.tables(M, dev)
    assert got_L == L
    exact = np.array([np.exp(-1j * np.pi * (n * n % (2 * M)) / M)
                      for n in range(M)])
    w = w.numpy().astype(np.float64)
    assert np.abs(w[:, 0] + 1j * w[:, 1] - exact).max() < 1e-7
    b = np.zeros(L, np.complex128)
    b[:M] = np.conj(exact)
    b[L - np.arange(1, M)] = np.conj(exact[1:])
    want = np.fft.fft(b) / L
    bh = bh.numpy().astype(np.float64)
    assert np.abs(bh[:, 0] + 1j * bh[:, 1] - want).max() < \
        1e-7 * np.abs(want).max()
    twl = twl.numpy().astype(np.float64)
    e = np.arange(L)
    assert np.abs(twl[:, 0] + 1j * twl[:, 1]
                  - np.exp(-2j * np.pi * e / L)).max() < 1e-7
    assert np.array_equal(tile.numpy(), np.concatenate(
        [KA._fft_twiddles(R) for R in route.RADICES]))
    route.tables.cache_clear()


def test_direct_width_has_no_chirp():
    """At a power of two past 32768 the route is direct: no chirp, no B̂,
    L = M."""
    L, _, _, w, bh = route.tables(65536, torch.device("cpu"))
    assert L == 65536 and w is None and bh is None
    route.tables.cache_clear()


# ---- (e) the plain versions' FFT form against the JAX package ------------

@pytest.mark.parametrize("M", [16, 96, 1024])
def test_plain_fft_form_matches_jax(M, monkeypatch):
    """The plain versions' float64 FFT form (past DENSE_MAX_WIDTH; here
    forced at small widths) against the JAX analysis (fold="conv") and
    synthesis: K1's plain version at both parities, riq and planar (K2's
    and K3's run on it), and the plain synthesis with a carry-in, all
    within atol 2e-4."""
    monkeypatch.setattr(KA, "DENSE_MAX_WIDTH", 0)
    monkeypatch.setattr(tchz, "DENSE_MAX_WIDTH", 0)
    T, Nh = 4, 9
    P = M // 2
    rng = np.random.default_rng(M)
    x = rng.normal(0, 0.5, (Nh * P, 2)).astype(np.float32)
    Y = rng.normal(0, 1, (Nh, M, 2)).astype(np.float32)
    carry = rng.normal(0, 0.1, (M * T - P, 2)).astype(np.float32)
    spec, tspec = jchz.ChannelizerSpec(M, T), tchz.ChannelizerSpec(M, T)
    cpu = torch.device("cpu")
    for hop in (0, 1):
        jst = jchz.AnalyzerState(jnp.zeros((M * T - P, 2)), hop)
        jy, _ = jchz.analyze(jnp.asarray(x), spec, jst, chmajor=True,
                             fold="conv", planar=True)
        tst = tchz.AnalyzerState(torch.zeros((M * T - P, 2)), hop)
        ty, _ = tchz.analyze(torch.as_tensor(x), tspec, tst, chmajor=True,
                             planar=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-4)
        x_ext = torch.cat([torch.zeros((M * T - P, 2)), torch.as_tensor(x)])
        riq = KA.analyze_reference(x_ext, M, T, hop)
        np.testing.assert_allclose(riq.permute(2, 0, 1).numpy(),
                                   np.asarray(jy), atol=2e-4)
        # K2's and K3's plain versions run on this analysis
        _, last, _ = K2.analyze_demod_reference(x_ext, M, T, hop,
                                                torch.zeros((M, 2)))
        assert torch.equal(last, riq[:, -1])
        ph, _, _ = K3.analyze_phases_reference(x_ext, M, T, 3, hop)
        assert ph.shape == (M, 3, (Nh - 2) // 3) and torch.isfinite(ph).all()
        js, jss = jchz.synthesize(jnp.asarray(Y), spec,
                                  jchz.SynthesizerState(jnp.asarray(carry),
                                                        hop))
        ts, tss = tchz.synthesize(torch.as_tensor(Y), tspec,
                                  tchz.SynthesizerState(
                                      torch.as_tensor(carry), hop))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-4)
        np.testing.assert_allclose(tss.carry.numpy(), np.asarray(jss.carry),
                                   atol=2e-4)
    assert cpu.type == "cpu"


@pytest.fixture
def no_persistent_cache():
    """JAX's compilation cache off for the test (its executables at
    32896 hold their tables as constants)."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", was)


def test_plain_k1_k4_and_carried_state_match_jax_past_32768(
        no_persistent_cache):
    """At M = 32896 = 128·257 (past 32768: the port's plain versions are
    float64 FFTs; the JAX package's conv fold and synthesis use its
    two-stage split transform, whose tables stay small), two streamed
    blocks of 3 hops: K1's plain version against the JAX analysis
    (``fold="conv"``), K4's with a random carry in against the JAX
    synthesis; then the JAX analyzer and synthesizer state carried across
    (``convert``) continues as the port's second block; all within atol
    2e-4."""
    M, T = 32896, 8
    P = M // 2
    rng = np.random.default_rng(M)
    cpu = torch.device("cpu")
    x1, x2 = (rng.normal(0, 0.5, (3 * P, 2)).astype(np.float32)
              for _ in range(2))
    Y1, Y2 = (rng.normal(0, 1, (3, M, 2)).astype(np.float32)
              for _ in range(2))
    carry = rng.normal(0, 0.1, (M * T - P, 2)).astype(np.float32)
    spec, tspec = jchz.ChannelizerSpec(M, T), tchz.ChannelizerSpec(M, T)
    assert KA.route_length(M) == 131072 and jchz.default_split(M) == 128
    try:
        st0 = jchz.analyzer_init(spec)
        y1, st1 = jchz.analyze(jnp.asarray(x1), spec, st0, chmajor=True,
                               fold="conv", planar=True)
        y2, _ = jchz.analyze(jnp.asarray(x2), spec, st1, chmajor=True,
                             fold="conv", planar=True)
        s1, ss1 = jchz.synthesize(jnp.asarray(Y1), spec,
                                  jchz.SynthesizerState(jnp.asarray(carry), 0))
        s2, _ = jchz.synthesize(jnp.asarray(Y2), spec, ss1)
        y1, y2, s1, s2, hist1, carry1 = map(np.asarray, (
            y1, y2, s1, s2, st1.history, ss1.carry))
        jax.clear_caches()
        x_ext = np.concatenate([np.zeros((M * T - P, 2), np.float32), x1])
        got = KA.analyze_block(torch.as_tensor(x_ext), M, T, 0, planar=True)
        assert got.shape == (2, M, 3)
        assert np.abs(got.numpy() - y1).max() < 2e-4
        o1, c1 = tchz._synthesize_block(torch.as_tensor(Y1), M, T, 0,
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
    finally:
        jchz._dft_mats.cache_clear()
