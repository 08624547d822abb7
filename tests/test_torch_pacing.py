"""The port's wall-clock pacing legs (``amps_tpu_torch.eval.pacing``) on
the CPU at M=16: the staged periodic band against the JAX package's
synthesis of the same plane, and each leg's bookkeeping -- every planted
burst once a period, every transmitted block received, the summary's
keys.  Latencies and deadline misses are printed, never held: the suite
runs under xdist next to other work.  Each leg's executor joins with its
own timeout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp.fm import fm_modulate_symbols as jfm_symbols
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu.tx import recc_ms as jrecc
from amps_tpu_torch.eval import pacing, soak

torch.set_num_threads(2)

M = 16
BLOCK = 8192 * M // 2          # 8192 hops a block, as at M=1024
SUMMARY_KEYS = {"blocks", "block_dt_ms", "wall_s", "latency_ms",
                "deadline_misses", "underruns_1_block_buffer",
                "underruns_2_block_buffer", "arrival_jitter_ms_max",
                "rt_headroom_p99", "leg", "rate_msps"}


def test_staged_pool_matches_jax():
    """The period's plane of the five planted page responses (one across
    pool blocks 2 -> 3), synthesized by both packages, agrees to 1e-5."""
    spec = soak.production_spec(M)
    pool, planted = pacing.stage_pool(spec, "cpu", BLOCK, noise=0.0)
    assert len(pool) == pacing.POOL_BLOCKS
    assert all(b.shape == (BLOCK, 2) for b in pool)
    assert sorted(p.event.channel for p in planted) == [0, 1, 4, 10, 14]
    jspec = JSpec(num_channels=M, taps_per_phase=8, fold="bank")
    hops = pacing.POOL_BLOCKS * BLOCK // (M // 2)
    Y = np.zeros((hops, M, 2), np.float32)
    sens = 2 * np.pi * jspec.pipe.deviation_hz / jspec.pipe.chan_rate
    for ev in pacing.pacing_events(M):
        syms = jrecc.burst_symbols(np.stack(ev.words()), dcc=0,
                                   sps=jspec.chan_sps)
        bb = np.asarray(jfm_symbols(jnp.asarray(syms, jnp.int8), sens)[0])
        Y[ev.start_hop: ev.start_hop + len(bb), ev.channel] = bb
    x, _ = jchz.synthesize(jnp.asarray(Y), jspec.chz_spec,
                           jchz.synthesizer_init(jspec.chz_spec))
    got = torch.cat(pool).numpy()
    want = np.asarray(x)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_leg_rx_delivers_each_burst_once_a_period():
    """One period (8 blocks of 136.5 ms at M x 30 kHz = 0.48 Msamples/s,
    ~1.1 s) through the executor."""
    r = pacing.leg_rx(1.0, "cpu", M=M, block=BLOCK, timeout=120)
    print(r)
    assert SUMMARY_KEYS | {"reports", "reports_expected",
                           "exactly_once_per_period",
                           "max_backlog_s"} <= set(r)
    assert r["blocks"] == pacing.POOL_BLOCKS
    assert r["rate_msps"] == M * 30000 / 1e6
    assert r["reports"] == r["reports_expected"] == r["reports_exact"] == 5
    assert r["exactly_once_per_period"]


@pytest.mark.parametrize("threaded", [True, False])
def test_leg_fdx_receives_every_block(threaded):
    """~1 s of paced full duplex: two FOCC frames a 92.6 ms block, TX and
    RX threads over the bounded queue, or one thread."""
    r = pacing.leg_fdx(1.0, "cpu", M=M, threaded=threaded, timeout=120)
    print(r)
    assert SUMMARY_KEYS | {"tx_blocks", "rx_blocks",
                           "max_queue_depth"} <= set(r)
    assert r["tx_blocks"] == r["rx_blocks"] == r["blocks"] == 11
    assert r["leg"].endswith("_single_thread") != threaded
    assert r["max_queue_depth"] <= 2


def test_summarize_counts_misses_and_underruns():
    r = pacing.summarize([10.0, 50.0, 150.0, 250.0, 350.0], 100.0,
                         [0.1, 0.3], {"leg": "x"})
    assert r["blocks"] == 5 and r["deadline_misses"] == 3
    assert r["underruns_1_block_buffer"] == 2
    assert r["underruns_2_block_buffer"] == 1
    assert r["latency_ms"]["max"] == 350.0
    assert r["arrival_jitter_ms_max"] == 0.3 and r["leg"] == "x"
