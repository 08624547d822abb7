"""Every bank width the FFT tile takes (any even M from 2 to 8192, and
past it the cluster widths of test_torch_cluster_wide.py): its
plan and twiddle table at every M up to 4096 (one block a hop; the
cluster widths past it: test_torch_cluster.py), the kernels' geometry
(shared memory, K3's run, K4's column groups) that the CUDA libraries
are held to, the port's plain K1-K4 at M=768 (a 23.04 Msps station) and
4096 (122.88 Msps) against the TPU kernels in interpret mode, the
receive block at M=96, 768, 4096 and 8192 (245.76 Msps) and the
streaming receiver and the transmitter at M=96 against the JAX package.
The CUDA kernels at these widths are held to their plain versions on the
card (test_torch_cuda.py).

Tolerances are tests/test_pallas.py's: atol 2e-4 for the f32 analysis
and synthesis, 5% for the power.  K2 and K3 on the TPU take bf16 DFT
matrices at M >= 512, so at M=768 the port's plain phases are held as
close to them as the JAX package's own f32 chain is.  The receive block
holds valid and word_ok exactly on every slot, starts, dcc_bits, words
and bad_symbols on the valid slots: a noise-only slot's trigger search
slices noise against its own mean, so two correct f32 summation orders
may pick another first trigger there (it moved on one slot of 96 at
M=96); the streaming receiver's reports are held exactly."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp.fm import quadrature_demod_planar as jdemod
from amps_tpu.eval.traffic import MobileEvent, synthesize_reverse_band
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu.parallel.pipeline import rx_multichannel_block as jrx
from amps_tpu.runtime.streamer import MultichannelReceiver as JRx
from amps_tpu.runtime.streamer import MultichannelTransmitter as JTx
from amps_tpu.rx import correlator as jcor
from amps_tpu.tx import focc as jfocc
from amps_tpu_torch.eval.traffic import unit_channel_band
from amps_tpu_torch.kernels import analysis as KA
from amps_tpu_torch.kernels import rx_front as K2
from amps_tpu_torch.kernels import rx_phases as K3
from amps_tpu_torch.kernels import synth as K4
from amps_tpu_torch.parallel.pipeline import MultichannelSpec as TSpec
from amps_tpu_torch.parallel.pipeline import rx_multichannel_block as trx
from amps_tpu_torch.runtime.streamer import MultichannelReceiver as TRx
from amps_tpu_torch.runtime.streamer import MultichannelTransmitter as TTx

torch.set_num_threads(1)

EXACT_KEYS = ("starts", "valid", "word_ok", "dcc_bits")
VALID_SLOT_KEYS = ("words", "bad_symbols")
SMEM_BYTES = 232448       # shared memory a Hopper block may opt in to


def _legacy_plan(M):
    """The power-of-two plan the tile ran before mixed radix: 16 while
    four bits remain, then one pass of 2, 4 or 8."""
    b = M.bit_length() - 1
    return (16,) * (b // 4) + ((1 << b % 4,) if b % 4 else ())


def test_fft_plan_and_twiddles_every_width():
    """At every even M from 8 to 4096 (the widths one block transforms
    whole): the radices multiply to M, are 16, one of 2/4/8, then odd
    primes ascending; a power of two keeps its old plan; every twiddle
    the passes read is W_M^e from float64 to f32 rounding; the table's
    length is the head, the register passes' blocks and the generic
    pass's whole W_M; the front ends take twice the analysis kernel's
    hops up to 2048 and as many past it; and the widest block fits
    Hopper's shared memory, its table beside the plane up to 2048 and in
    device memory past it."""
    for M in KA.FFT_WIDTHS[: KA.FFT_WIDTHS.index(KA.BLOCK_WIDTH) + 1]:
        plan = KA.fft_radices(M)
        assert int(np.prod(plan)) == M, M
        twos = [R for R in plan if R % 2 == 0]
        odd = [R for R in plan if R % 2]
        assert plan == tuple(twos + odd) and odd == sorted(odd), M
        assert all(R in (2, 4, 8, 16) for R in twos), M
        assert twos[:-1] == [16] * (len(twos) - 1), M
        assert all(all(R % q for q in range(3, int(R ** 0.5) + 1, 2))
                   for R in odd), M
        if M in KA.LIBRARY_WIDTHS:
            assert plan == _legacy_plan(M), M
        e = KA.fft_twiddle_exponents(M)
        head = 3 if M in KA.LIBRARY_WIDTHS else 9
        ns, blocks = 1, 0
        for p, R in enumerate(plan):
            if p and not KA.fft_generic(R):
                blocks += (R - 1) * ns
            ns *= R
        generic = any(KA.fft_generic(R) for R in plan)
        assert len(e) == head + blocks + (M if generic else 0), M
        tw = KA._fft_twiddles(M)
        want = np.exp(-2j * np.pi * (e % M).astype(np.float64) / M)
        assert np.abs(tw[:, 0] - want.real).max() < 1e-7, M
        assert np.abs(tw[:, 1] - want.imag).max() < 1e-7, M
        for R, j in ((3, 1), (5, 1), (5, 2), (7, 1), (7, 2), (7, 3)):
            if R in plan:       # a head constant a butterfly reads is whole
                assert j * M % R == 0
        wide = KA.FFT_WIDE_HOPS[M]
        if M <= 2048:
            assert wide == 2 * KA.FFT_TILE_HOPS[M] and wide % 4 == 0, M
            assert 8 * (wide * KA.fft_hop_stride(M) + len(e)) <= SMEM_BYTES, M
        else:
            assert wide == KA.FFT_TILE_HOPS[M] and wide % 2 == 0, M
            assert 8 * wide * KA.fft_hop_stride(M) <= SMEM_BYTES, M
            assert 8 * (wide + 2) * KA.fft_hop_stride(M) > SMEM_BYTES, M


@pytest.mark.parametrize("M", [7, 16396, 32770, 4097, 16402, 16388, 1023])
def test_widths_the_tile_refuses(M):
    """Only odd M and M < 2 are refused, naming every rule; the widths
    past 16384 that no cluster of at most 8 blocks of at most 4096
    channels splits (16388 = 4·17·241, 16396 = 4·4099, 16402 =
    2·59·139) and M past 32768 (32770) are taken through device memory
    (``route_length``), the unsplit widths up to 16384 (8194 =
    2·17·241, 8198 = 2·4099) by Bluestein's chirp transform."""
    rule = ("even M from 2 to 16384 .past 8192 split, or Bluestein's chirp "
            "transform of length 32768., or M = C·N with C <= 8")
    if M % 2:
        with pytest.raises(ValueError, match=rule):
            KA.check_fft_width(M)
    else:
        KA.check_fft_width(M)
        assert KA.route_length(M) and M not in KA.FFT_WIDTHS
    for refused in (0, -M):
        with pytest.raises(ValueError, match=rule):
            KA.check_fft_width(refused)
    for taken in (8194, 8198):
        KA.check_fft_width(taken)


def test_every_even_width_is_taken():
    for M in (2, 4, 6, 8, 10, 12, 22, 96, 384, 768, 1458, 1536, 2038, 2046,
              2048, 2050, 2304, 3072, 4000, 4094, 4096, 4098, 4100, 6144,
              8190, 8192, 8194, 8196, 8198, 12288, 12294, 13334, 16382,
              16384, 16424, 20480, 28672, 32768):
        KA.check_fft_width(M)
    # every even M up to 16384 (past 8192 split or by Bluestein), then
    # the M = C·N (C <= 8, N <= 4096)
    assert KA.FFT_WIDTHS == tuple(
        M for M in range(2, 32769, 2)
        if M <= 16384 or any(M % C == 0 and M // C <= 4096
                             for C in range(2, 9)))
    assert 4096 in KA.LIBRARY_WIDTHS and 8192 not in KA.LIBRARY_WIDTHS


# ---- the kernels' geometry at every width (the mirror of the CUDA
# ---- constants that kernels.analysis.bind holds each library to) -------

def _smem(M, H):
    """A block's shared memory, counted afresh: H hops of the padded plane
    of its channels (M, or M/C past 4096, where a cluster of C blocks
    shares each hop, C the smallest divisor of M from 2 to 8 with M/C <=
    4096, or where there is none 32768/8 = 4096 points of Bluestein's
    transform; 8 bytes a value, one value of padding every 32, plus one),
    and the twiddle table beside it up to M = 2048."""
    table = len(KA.fft_twiddle_exponents(M)) if M <= 2048 else 0
    split = min((c for c in range(2, 9) if M % c == 0 and M // c <= 4096),
                default=0)
    C = M if M <= 4096 else M // split if split else 4096
    return 8 * (H * (C + C // 32 + 1) + table)


def test_kernel_shared_memory_fits_every_width():
    """K1 (FFT_TILE_HOPS) and K2-K4 (FFT_WIDE_HOPS) at every even M from
    8 to 8192: the wrapper's shared-memory bytes are the plane and table
    counted afresh, and fit the 232,448 bytes a Hopper block may opt in
    to; M = 4096 holds six hops (202,800 bytes), and so does each block
    of M = 8192's cluster."""
    for M in KA.FFT_WIDTHS:
        for H in (KA.FFT_TILE_HOPS[M], KA.FFT_WIDE_HOPS[M]):
            assert KA.fft_smem_bytes(M, H) == _smem(M, H) <= SMEM_BYTES, M
    assert KA.FFT_WIDE_HOPS[4096] == KA.FFT_WIDE_HOPS[8192] == 6
    assert KA.fft_smem_bytes(4096, 6) == KA.fft_smem_bytes(8192, 6) == 202800
    # the twiddle table beside six hops would not fit at 4096
    assert 202800 + 8 * len(KA.fft_twiddle_exponents(4096)) > SMEM_BYTES


def test_k3_owns_whole_symbols_at_sps3_every_width():
    """K3 at sps = 3 owns at least one whole symbol a block at every even
    M (one hop behind, two ahead within FFT_WIDE_HOPS), so its run is
    never empty: run_hops >= 3, a multiple of 3."""
    for M in KA.FFT_WIDTHS:
        R = K3.run_hops(M, 3)
        assert R >= 3 and R % 3 == 0 and R + 3 <= KA.FFT_WIDE_HOPS[M], M
    assert K3.run_hops(4096, 3) == K3.run_hops(8192, 3) == 3


def test_k4_thread_columns_at_most_two_every_width():
    """K4 at every even M and both rings (T <= 8: 2·8 sums, T <= 16: 2·16):
    a thread holds at most 2 columns and at most 3·2·8·2 = 96 registers of
    ring (sums and gains), the column groups -- each one block, or past
    4096 a cluster of blocks (8 where Bluestein's transform runs) that
    split its columns -- cover the P = M/2 columns, one group up to M =
    1024 at T = 8 (512 at T = 16)."""
    for M in KA.FFT_WIDTHS:
        P = M // 2
        ranks = KA.fft_cluster_size(M) or 8
        for T in (8, 16):
            cols, G = K4.thread_columns(M, T), K4.column_groups(M, T)
            assert 1 <= cols <= 2, (M, T)
            assert 3 * 2 * T * cols <= 96, (M, T)
            assert G * ranks * 256 * cols >= P \
                > (G - 1) * ranks * 256 * cols, (M, T)
            assert (G == 1) == (M <= (1024 if T == 8 else 512)), (M, T)
    assert K4.column_groups(4096, 8) == K4.column_groups(8192, 8) == 4
    assert K4.column_groups(1536, 8) == K4.column_groups(2048, 8) == 2


def _x_ext(M, T, Nh, seed, sigma=0.5):
    P = M // 2
    rng = np.random.default_rng(seed)
    x = rng.normal(0, sigma, (Nh * P, 2)).astype(np.float32)
    return np.concatenate([np.zeros((M * T - P, 2), np.float32), x])


def _plain_k1_vs_pallas(M, T=8, Nh=256):
    from amps_tpu.pallas.channelizer_kernel import analyze_chmajor_pallas
    x = unit_channel_band(M, T, Nh, M, device="cpu")
    want = np.asarray(analyze_chmajor_pallas(x.numpy(), M, T, 0, tile_h=128,
                                             interpret=True))
    got = KA.analyze_block(x, M, T, 0)
    assert got.shape == want.shape == (M, Nh, 2)
    assert np.abs(got.numpy() - want).max() < 2e-4


def test_plain_k1_matches_pallas_at_768():
    """K1 at M=768 (3·256: compiled on the TPU for M % 128 == 0), Nh=256,
    against the TPU kernel in interpret mode, atol 2e-4."""
    _plain_k1_vs_pallas(768)


def test_plain_k1_matches_pallas_at_4096():
    """K1 at M=4096 (the 122.88 Msps bank), Nh=256, against the TPU
    kernel in interpret mode, atol 2e-4."""
    _plain_k1_vs_pallas(4096)


def _fsk_band(M, T, Nh, seed):
    """History-prepended wideband whose M channels all carry random-data
    FSK at 3 hops a symbol (every channel's phase well conditioned; the
    discriminator stays within ±0.84 rad), through the port's plain
    synthesis."""
    from amps_tpu_torch.dsp.channelizer import _synthesize_block
    from amps_tpu_torch.dsp.fm import fm_modulate_symbols
    rng = np.random.default_rng(seed)
    syms = np.repeat(rng.choice(np.array([-1, 1], np.int8), (M, -(-Nh // 3))),
                     3, axis=1)[:, :Nh]
    bb, _ = fm_modulate_symbols(torch.as_tensor(syms), 2 * np.pi * 8000 / 60000)
    carry = torch.zeros((M * T - M // 2, 2))
    x, _ = _synthesize_block(bb.transpose(0, 1).contiguous(), M, T, 0, carry)
    return torch.cat([carry, x]).contiguous()


def _jax_demod(x, M, T):
    ypl = jchz._analyze_block_chmajor(
        jnp.asarray(x), jnp.asarray(jchz.prototype_taps(M, T)), M, T,
        jnp.int32(0), fold="bank", planar=True)
    demod, _, _ = jdemod(ypl[0], ypl[1], return_power="series")
    return demod


# hops of the bank's ramp-up from the zero history, left out of the
# phase comparisons
RAMP = 2 * 8 + 2


def _plain_k2_vs_pallas(M, T=8, Nh=256):
    from amps_tpu.pallas.rx_front_kernel import analyze_demod_pallas
    x = _fsk_band(M, T, Nh, 2)
    want_d, want_p = analyze_demod_pallas(jnp.asarray(x.numpy()), M, T,
                                          tile_h=128, interpret=True)
    d, _, pw = K2.analyze_demod_reference(x, M, T, 0, torch.zeros((M, 2)))
    assert d.shape == (M, Nh)
    tpu = np.asarray(want_d, np.float32)[:, RAMP:]
    xla = np.asarray(_jax_demod(x.numpy(), M, T))[:, RAMP:]
    port = d.numpy()[:, RAMP:]
    assert np.abs(port - xla).max() < 1e-4
    assert np.abs(port - tpu).max() <= np.abs(xla - tpu).max() + 1e-3
    power = torch.sqrt(pw.mean(dim=-1)).numpy()
    rel = np.abs(power - np.asarray(want_p)) / np.asarray(want_p)
    assert rel.max() < 0.05


def test_plain_k2_matches_pallas_at_768():
    """K2 at M=768 (M % 256 == 0: compiled on the TPU), Nh=256, on FSK in
    every channel.  The TPU kernel takes bf16 DFT matrices at M >= 512
    (rx_front_kernel.py:173) and writes bf16 demod, so the port's f32
    plain version is held as close to it as the JAX package's own f32
    chain is (+1e-3), and to that chain within 1e-4; the band power
    within 5%."""
    _plain_k2_vs_pallas(768)


def test_plain_k2_matches_pallas_at_4096():
    """K2 at M=4096, Nh=256, on FSK in every channel, as at 768: within
    1e-4 of the JAX f32 chain, as close to the TPU kernel's bf16 matrices
    as that chain is (+1e-3), the band power within 5%."""
    _plain_k2_vs_pallas(4096)


def _plain_k3_vs_pallas(M, T=8, sps=3, Nh=768):
    from amps_tpu.pallas.rx_phases_kernel import analyze_phases_pallas
    x = _fsk_band(M, T, Nh, 7)
    ph_k3, cp_k3 = analyze_phases_pallas(jnp.asarray(x.numpy()), M, T, sps,
                                         tile_h=384, interpret=True)
    ph, cp, _ = K3.analyze_phases_reference(x, M, T, sps,
                                            out_dtype=torch.bfloat16)
    assert ph.shape == ph_k3.shape == (M, sps, (Nh - sps + 1) // sps)
    js = -(-RAMP // sps)
    tpu = np.asarray(ph_k3, np.float32)[..., js:]
    xla = np.asarray(jcor.symbol_phase_streams(
        _jax_demod(x.numpy(), M, T), sps))[..., js:]
    port = ph.float().numpy()[..., js:]
    assert np.abs(port - xla).max() < 0.02
    assert np.abs(port - tpu).max() <= np.abs(xla - tpu).max() + 1e-3
    rel = np.abs(cp.numpy() - np.asarray(cp_k3)) / np.asarray(cp_k3)
    assert rel.max() < 0.05


def test_plain_k3_matches_pallas_at_768():
    """K3 at M=768, Nh = 384·2, on FSK in every channel: bf16 phases held
    as close to the TPU kernel (bf16 DFT matrices at M >= 512,
    rx_phases_kernel.py:202) as the JAX f32 chain's phases are (+1e-3,
    and within 0.02 of them, the bf16 output's own tolerance), the
    channel power within 5%."""
    _plain_k3_vs_pallas(768)


def test_plain_k3_matches_pallas_at_4096():
    """K3 at M=4096, Nh = 384·2 (two of the TPU kernel's tiles), on FSK
    in every channel, as at 768: bf16 phases within 0.02 of the JAX f32
    chain and as close to the TPU kernel as that chain is (+1e-3), the
    channel power within 5%."""
    _plain_k3_vs_pallas(4096)


def _plain_k4_vs_pallas(M, T=8, Nh=256):
    from amps_tpu.pallas.synthesizer_kernel import synthesize_pallas
    Y = np.random.default_rng(M).normal(0, 1, (Nh, M, 2)).astype(
        np.float32)
    want, want_carry = synthesize_pallas(jnp.asarray(Y), M, T, 0, 128,
                                         interpret=True)
    got, got_carry = K4.synthesize_block_reference(
        torch.as_tensor(Y), M, T, 0, torch.zeros((M * T - M // 2, 2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(got_carry.numpy(), np.asarray(want_carry),
                               atol=2e-4)


def test_plain_k4_matches_pallas_at_768():
    """K4 at M=768, Nh=256, zero carry, even parity: atol 2e-4."""
    _plain_k4_vs_pallas(768)


def test_plain_k4_matches_pallas_at_4096():
    """K4 at M=4096, Nh=256, zero carry, even parity: atol 2e-4."""
    _plain_k4_vs_pallas(4096)


BLOCK_HOPS = 3600          # a 2-word burst is (48 + 2·240)·2·3 = 3168 hops
# at M=8192 the plain path's dense transform costs twice 4096's a hop, so
# the block is two one-word bursts in 1792 hops (a one-word burst is
# (48 + 240)·2·3 = 1728 hops): 7.3 M samples
WIDEST_BLOCK_HOPS = 1792


class _OneWordBurst(MobileEvent):
    """A page response's first word alone: the shortest burst."""

    def words(self):
        return super().words()[:1]


def _events(M):
    if M == 8192:
        return [_OneWordBurst("page_response", 1, 40, "4155559876"),
                _OneWordBurst("page_response", M - 2, 60, "7735550000")]
    return [MobileEvent("page_response", 1, 120, "4155559876"),
            MobileEvent("page_response", M // 2 + 3, 300, "2125550000"),
            MobileEvent("page_response", M - 2, 400, "7735550000")]


@functools.cache
def _band(M):
    spec = JSpec(num_channels=M, taps_per_phase=8, fold="bank")
    events = _events(M)
    hops = WIDEST_BLOCK_HOPS if M == 8192 else BLOCK_HOPS
    return np.asarray(synthesize_reverse_band(events, spec, hops,
                                              noise_sigma=0.001)), events


def _specs(M):
    kw = dict(num_channels=M, taps_per_phase=8, fold="bank")
    return JSpec(**kw), TSpec(**kw)


@pytest.mark.parametrize("M", [96, 768, 4096, 8192])
def test_rx_block_matches_jax_at_width(M):
    """rx_multichannel_block, f32 spec, three planted bursts in 3600
    hops (at M=4096 a band of 7.4 M samples, ~20 s on one CPU thread;
    at M=8192 two one-word bursts in 1792 hops, 7.3 M samples, ~40 s):
    the port's plain path against the JAX block; noise-only slots whose
    first trigger moved are at most 2% of the slots."""
    x, events = _band(M)
    jspec, tspec = _specs(M)
    want = jax.device_get(jrx(jnp.asarray(x), jspec, max_bursts=2,
                              threshold=0.55))
    got = {k: v.numpy() for k, v in
           trx(torch.as_tensor(x), tspec, max_bursts=2).items()}
    valid = np.asarray(want["valid"])
    planted = np.zeros_like(valid)
    for ev in events:
        planted[ev.channel, 0] = True
    assert np.array_equal(valid, planted)
    for k in ("valid", "word_ok") + ("starts", "dcc_bits") + VALID_SLOT_KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if k in ("valid", "word_ok"):
            assert np.array_equal(got[k], w), k
        else:
            assert np.array_equal(got[k][valid], w[valid]), k
    moved = (got["starts"] != np.asarray(want["starts"])).any(-1).sum()
    assert moved <= 0.02 * M
    for ev in events:
        w = np.stack(ev.words())
        assert np.array_equal(got["words"][ev.channel, 0, :len(w)], w)


def _key(r):
    return (r.channel, r.abs_symbol, r.words.tolist(), r.word_ok.tolist(),
            np.asarray(r.bad_symbols).tolist(), r.dcc)


PUSH_HOPS = 4095           # odd: the hop parity alternates between pushes
ORIGINATION_HOPS = (30 + 11 + 7 + 7 * 240) * 2 * 3   # a 7-word burst


def test_receiver_push_matches_jax_at_96():
    """A 96-channel stream of 18380 hops pushed in blocks of 4095 hops
    (the last one ragged), with bursts across push boundaries and one
    placed a 7-word burst's length before the stream's end, then a padded
    flush (tests/test_torch_streamer.py's stream at M=16): the same
    reports as the JAX receiver, each planted burst once."""
    M = 96
    total = 4 * PUSH_HOPS + 2000
    events = [MobileEvent("origination", 3, 900, "5551234567",
                          "16505551234", esn=77),
              MobileEvent("page_response", M // 2 + 3, 3000, "2125550000"),
              MobileEvent("registration", 0, 6000, "7735550000", esn=5),
              MobileEvent("origination", M - 1, total - 4 - ORIGINATION_HOPS,
                          "3125550000", "7025551000", esn=9)]
    jspec, tspec = _specs(M)
    x = np.asarray(synthesize_reverse_band(events, jspec, total,
                                           noise_sigma=0.001))
    n = PUSH_HOPS * M // 2
    stream = [x[i: i + n] for i in range(0, len(x), n)]
    jrx_ = JRx(jspec, threshold=0.5, pipeline_depth=1)
    want = sum((jrx_.push(b) for b in stream), []) + jrx_.flush(pad_tail=True)
    trx_ = TRx(tspec, device="cpu", threshold=0.5, pipeline_depth=1)
    got = sum((trx_.push(torch.as_tensor(b)) for b in stream), []) \
        + trx_.flush(pad_tail=True)
    assert [_key(r) for r in got] == [_key(r) for r in want]
    for a, b in zip(got, want):
        assert abs(a.quality - b.quality) <= 1e-4
        assert abs(a.rssi - b.rssi) <= 1e-4 * abs(b.rssi)
    assert sorted(r.channel for r in got) == sorted(e.channel for e in events)
    for ev in events:
        r = next(r for r in got if r.channel == ev.channel)
        w = np.stack(ev.words())
        assert np.array_equal(r.words[: len(w)], w) and r.word_ok[: len(w)].all()


def test_transmitter_superframe_matches_jax_at_96():
    """One superframe of a 96-channel transmitter (FOCC on three slots,
    a page on one) against the JAX transmitter, atol 2e-4, and the same
    carried state."""
    from amps_tpu.codec import words as W
    from amps_tpu.ref import words_ref
    M = 96
    jspec, tspec = _specs(M)
    min1, min2 = words_ref.parse_min("5551234567")
    w1 = np.asarray(W.focc_word1(True, 0, min1))
    w2 = np.asarray(W.focc_word2_general(min2, 0, 0, 0))
    ctrl = [0, 41, 95]
    txs = (JTx(jspec, control_channels=ctrl),
           TTx(tspec, control_channels=ctrl, device="cpu"))
    for tx in txs:
        tx.focc[41].push_words(jfocc.STREAM_BOTH, [w1, w2], repeats=2)
    want = np.asarray(txs[0].next_block())
    got = txs[1].next_block()
    assert got.shape == want.shape == (18 * 463 * 2 * 3 * M // 2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    np.testing.assert_allclose(txs[1]._state.carry.numpy(),
                               np.asarray(txs[0]._state.carry), atol=2e-4)
