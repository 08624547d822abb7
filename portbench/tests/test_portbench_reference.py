"""The reference agrees with itself across push boundaries, and, as a
second witness on the CPU, with the port's plain front end."""

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.reference import backend, bank, recc
from small import small


def band(seed=1):
    f = small()
    return gen.rx_stream(f["cfg"], f["mix"], seed, torch.device("cpu"))


def test_analysis_chained_equals_whole():
    pool = band()
    blocks = pool.stream_blocks(cyclic=False)
    whole = bank.analyze(blocks, pool.M, pool.T, 0, 6000)
    cut = torch.cat([bank.analyze(blocks, pool.M, pool.T, 0, 2048),
                     bank.analyze(blocks, pool.M, pool.T, 2048, 6000,
                                  chunk=999)], dim=-1)
    assert (whole - cut).abs().max() < 1e-12
    d, pw = bank.discriminate(whole, torch.zeros(pool.M,
                                                 dtype=torch.complex128))
    d2, pw2 = bank.discriminate(whole[:, 2048:], whole[:, 2047])
    assert torch.equal(d[:, 2048:], d2) and torch.equal(pw[:, 2048:], pw2)


def test_reference_front_end_against_the_ports_plain_version():
    from amps_tpu_torch.kernels.rx_front import analyze_demod_reference
    pool = band()
    M, T, P = pool.M, pool.T, pool.M // 2
    n = 4096
    x = pool.x[: n * P]
    xe = torch.cat([torch.zeros(((2 * T - 1) * P, 2)), x])
    d, _, pw = analyze_demod_reference(xe, M, T, 0, torch.zeros(M, 2))
    y = bank.analyze(pool.stream_blocks(cyclic=False), M, T, 0, n)
    dr, pwr, keep = bank.discriminate(
        y, torch.zeros(M, dtype=torch.complex128), settled=True)
    e = torch.remainder(d.double() - dr + np.pi, 2 * np.pi) - np.pi
    w = pwr * keep
    assert float(((w * e * e).sum() / w.sum()).sqrt()) < 1e-5
    assert float(((pw.double() - pwr) ** 2).sum().sqrt()
                 / (pwr ** 2).sum().sqrt()) < 1e-5


def test_prototype_against_the_ports_taps():
    from amps_tpu_torch.dsp.polyphase import prototype_taps
    for M, T in ((64, 8), (1024, 8)):
        assert np.abs(bank.prototype(M, T) - prototype_taps(M, T)).max() \
            < 1e-8


def test_branch_edge_is_left_out():
    # a product on the diagonal: the two branches 0.0417 rad apart
    on = torch.tensor([1.0 + 1.0j, 1.0 + (1 + 1e-9) * 1j],
                      dtype=torch.complex128)
    a = bank.poly_arg(torch.tensor([1.0, 1.0 + 1e-12], dtype=torch.float64),
                      torch.tensor([1.0 + 1e-12, 1.0], dtype=torch.float64))
    assert 0.041 < float(a[1] - a[0]) < 0.042
    y = torch.stack([torch.ones(2, dtype=torch.complex128), on], -1)
    _, _, keep = bank.discriminate(y[:, 1:], y[:, 0], settled=True)
    assert not keep.any()
    far = torch.tensor([[1.0, 1.0 + 0.5j]], dtype=torch.complex128)
    assert bank.discriminate(far[:, 1:], far[:, 0], settled=True)[2].all()


@pytest.mark.parametrize("past_midpoint, decided", [(1e-7, False),
                                                    (1e-3, True)])
def test_a_level_rounding_may_move_leaves_the_slot_out(past_midpoint,
                                                       decided):
    # a capture that runs past the window's end reads 0 there, sliced
    # against a DC level of a few 1e-6: the level's sign follows one
    # demod sample's rounding when that sample lies at a bfloat16
    # rounding midpoint, and no other front end need round it alike
    sps, k0 = 3, 100
    nsym = k0 + 600
    sign = torch.where(torch.arange(nsym) % 2 == 0, 0.5, -0.5)
    d = sign.to(torch.float64).repeat_interleave(sps)[None]
    d[0, (k0 + 10) * sps + 2] = 0.5 + 2.0 ** -9 + past_midpoint
    starts = torch.tensor([[k0 * sps]])
    sym = backend.symbols(d, sps, True)
    assert bool(backend._gates(sym, starts, sps, True, d.shape[-1])[3])
    room = backend.room(d, None, sps, True)
    got = backend._gates(sym, starts, sps, True, d.shape[-1], room)[3]
    assert bool(got) == decided


def test_poly_arg_departs_from_atan2_as_stated():
    a = torch.linspace(-np.pi, np.pi, 100001, dtype=torch.float64)
    e = (bank.poly_arg(torch.sin(a), torch.cos(a)) - a).abs()
    e = torch.minimum(e, 2 * np.pi - e)
    assert 0.0207 < float(e.max()) < 0.0209
    assert float(bank.poly_arg(torch.zeros(1, dtype=torch.float64),
                               torch.zeros(1, dtype=torch.float64))) == 0


@pytest.mark.parametrize("nerr", [0, 1, 2])
def test_bch_corrects_up_to_two_errors(nerr):
    rng = np.random.default_rng(nerr)
    for _ in range(20):
        info = rng.integers(0, 2, 36).astype(np.uint8)
        cw = recc.bch_encode(info)
        rx = cw.copy()
        for p in rng.choice(48, nerr, replace=False):
            rx[p] ^= 1
        out, ok = recc.bch_decode(rx)
        assert ok and np.array_equal(out, info)


def test_bch_against_the_ports_codec():
    from amps_tpu_torch.codec.bch import recc_bch_decode, recc_bch_encode
    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, (50, 36)).astype(np.uint8)
    port = recc_bch_encode(torch.as_tensor(info)).numpy()
    assert np.array_equal(port, np.stack([recc.bch_encode(i) for i in info]))
    rx = rng.integers(0, 2, (200, 48)).astype(np.uint8)
    pw, pok = recc_bch_decode(torch.as_tensor(rx))
    for k in range(len(rx)):
        w, ok = recc.bch_decode(rx[k])
        assert ok == bool(pok[k]) and np.array_equal(w, pw[k].numpy())


def test_burst_bits_against_the_ports_format():
    from amps_tpu_torch.tx.recc_ms import burst_bits
    rng = np.random.default_rng(4)
    for n in (2, 7):
        for dcc in range(4):
            words = list(rng.integers(0, 2, (n, 36)).astype(np.uint8))
            assert np.array_equal(recc.burst_bits(words, dcc),
                                  burst_bits(words, dcc))
