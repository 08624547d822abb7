"""The generator plants what it says, and the reference receives every
planted burst as it was planted."""

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.reference import bank, recc
from small import rx_cell, small

SEEDS = [7, 2**31 + 11]


def test_place_bursts_keeps_its_rules():
    f = small()
    cfg, mix = f["cfg"], f["mix"]
    pool = mix["push_hops"] * mix["pool_pushes"]
    bh = gen.burst_hops(cfg["chan_sps"])
    slots = gen.control_slots(cfg)
    assert slots == [31, 32, 33, 34, 35, 36]
    for seed in SEEDS:
        bursts = gen.place_bursts(cfg, mix, seed)
        by_ch = {}
        for b in bursts:
            assert mix["edge_hops"] <= b.hop <= pool - bh - mix["edge_hops"]
            assert 2 <= len(b.words) <= 7 and b.dcc == mix["dcc"]
            by_ch.setdefault(b.channel, []).append(b.hop)
        # the same bursts on every seed: so many on each control channel
        assert sorted(by_ch) == slots
        for hops in by_ch.values():
            assert len(hops) == mix["bursts_per_channel"]
            for i, a in enumerate(hops):
                for c in hops[i + 1:]:
                    d = abs(a - c)
                    assert min(d, pool - d) >= bh + mix["min_gap_hops"]


def test_the_cells_mix_fits_its_pool():
    for cell in ("band1024.rx", "wide16384.rx"):
        found = rx_cell(cell)
        cfg, mix = found["cfg"], found["mix"]
        bursts = gen.place_bursts(cfg, mix, 2**31 + 5)
        assert len(bursts) == 42 * mix["bursts_per_channel"]
        assert {b.channel for b in bursts} == set(gen.control_slots(cfg))
        lo = (313 - 383) % cfg["num_channels"]
        assert gen.control_slots(cfg) == list(range(lo, lo + 42))


def test_same_seed_same_pool_other_seed_other():
    f = small()
    a = gen.rx_stream(f["cfg"], f["mix"], 5, torch.device("cpu"))
    b = gen.rx_stream(f["cfg"], f["mix"], 5, torch.device("cpu"))
    c = gen.rx_stream(f["cfg"], f["mix"], 6, torch.device("cpu"))
    assert torch.equal(a.x, b.x) and not torch.equal(a.x, c.x)
    assert [x.hop for x in a.bursts] == [x.hop for x in b.bursts]


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_receives_every_planted_burst(seed):
    f = small()
    cfg, r = f["cfg"], f["cfg"]["receiver"]
    pool = gen.rx_stream(cfg, f["mix"], seed, torch.device("cpu"))
    chans = sorted({b.channel for b in pool.bursts})
    y = bank.analyze(pool.stream_blocks(cyclic=True), pool.M, pool.T, 0,
                     pool.pool_hops, rows=chans)
    zero = torch.zeros((), dtype=torch.complex128)
    offsets = set()
    for b in pool.bursts:
        d, pw = bank.discriminate(y[chans.index(b.channel)], zero)
        got = recc.receive(d, pw, b.hop - 64, b.hop + 256, pool.sps,
                           r["threshold"], r["min_rssi"])
        n = len(b.words)
        assert got["reported"] and got["quality"] > 0.9
        assert got["word_ok"][:n].all() and got["dcc"] == b.dcc
        assert np.array_equal(got["words"][:n], b.words)
        assert got["trigger_errors"] == 0
        offsets.add(got["start"] - b.hop)
    # one delay for every burst: the precursor and the two filters'
    assert len(offsets) == 1


def test_noise_sets_the_channel_snr():
    f = small()
    cfg = dict(f["cfg"], recc_channels=[1, 0])
    pool = gen.rx_stream(cfg, f["mix"], 3, torch.device("cpu"))
    assert not pool.bursts
    y = bank.analyze(pool.stream_blocks(cyclic=True), pool.M, pool.T, 0,
                     pool.pool_hops)
    snr = -10 * np.log10(float((y.abs() ** 2).mean()))
    assert abs(snr - f["mix"]["snr_db"]) < 0.2
