"""Wall-clock pacing of the station, the PyTorch counterpart of the JAX
package's ``tools/realtime_pace_tpu.py``: the 1024-channel pipeline
driven through ``runtime/executor.py`` with input arriving on the
30.72 Msamples/s schedule of a 1024 x 30 kHz band, reporting each
block's latency (p50/p90/p99/max), arrival jitter, backlog and deadline
misses.

Two legs:

* ``leg_rx``: paced receive.  An 8-block periodic reverse band (noise +
  five planted page responses a period, one across the pool-block 2 -> 3
  boundary) is staged on the card (a radio's ADC writes into device
  memory) and released to the receiver on the schedule.  Every planted
  burst must be reported bit-exact, exactly once a period.
* ``leg_fdx``: paced full duplex.  Each 92.6 ms deadline synthesizes one
  block of two FOCC frames on all 1024 channels (``tx_multichannel_block``,
  the ``synth`` kernel) and pushes it through the receiver (the
  ``rx_front`` kernel): through ``ThreadedExecutor``'s TX feeder and RX
  drainer over a ``BlockQueue(depth=2)``, or in one thread.

Latency: the receiver runs at ``pipeline_depth=1``, so ``push`` returns
only after the block's reports are on the host; latency = completion -
arrival, and a deadline miss is a latency above one block's time.  The
garbage collector is off while a leg runs.

``python -m amps_tpu_torch.eval.pacing rx fdx fdx1 --seconds 70`` runs
legs on the card (``--device cpu`` on the CPU), one JSON line each.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.eval.soak import (burst_basebands, band_plane,
                                      production_spec, synthesize_band)
from amps_tpu_torch.eval.traffic import MobileEvent
from amps_tpu_torch.parallel.pipeline import (MultichannelSpec,
                                              tx_multichannel_block)
from amps_tpu_torch.runtime.executor import BlockQueue, ThreadedExecutor
from amps_tpu_torch.runtime.streamer import MultichannelReceiver

CHANNEL_RATE = 30000.0       # wideband samples/s per channel (M x 30 kHz)
POOL_BLOCKS = 8
BLOCK = 1 << 22              # samples a block: 8192 hops at M=1024, 136.53 ms
SECONDS = 70.0               # a leg at full length (>= 60 s)
FDX_FRAMES = 2               # FOCC frames a full-duplex block: 5556 hops

# at M=1024; one spans the pool-block 2 -> 3 boundary (hop 24576)
EVENTS = (MobileEvent("page_response", 100, 2000, "5551234567"),
          MobileEvent("page_response", 700, 12000, "4155559876"),
          MobileEvent("page_response", 300, 19576, "9165554321"),
          MobileEvent("page_response", 900, 40000, "7025551000"),
          MobileEvent("page_response", 50, 52000, "2125550000"))


def pacing_events(M: int) -> list:
    """The five planted events, their channels scaled to an M-channel
    bank."""
    return [MobileEvent(e.kind, e.channel * M // 1024, e.start_hop,
                        e.min_str) for e in EVENTS]


def _receiver(spec, dev):
    return MultichannelReceiver(spec, threshold=0.5, pipeline_depth=1,
                                max_bursts=2, min_rssi=0.05, device=dev)


def stage_pool(spec: MultichannelSpec, device, block: int = BLOCK,
               noise: float = 0.01):
    """The periodic reverse band as ``POOL_BLOCKS`` blocks of ``block``
    samples on ``device`` (views of one tensor), and its events."""
    P = spec.chz_spec.hop
    period_hops = POOL_BLOCKS * block // P
    bbs = burst_basebands(pacing_events(spec.num_channels), spec)
    for p, bb in bbs:
        if p.event.start_hop + len(bb) >= period_hops:
            raise ValueError(f"event at hop {p.event.start_hop} does not "
                             f"fit the {period_hops}-hop period")
    x = synthesize_band(band_plane(bbs, spec.num_channels, period_hops),
                        spec, device, noise, 7)
    return [x[i * block:(i + 1) * block] for i in range(POOL_BLOCKS)], \
        [p for p, _ in bbs]


def summarize(lat_ms, block_dt_ms: float, jit_ms, extra: dict) -> dict:
    """The JAX legs' summary: latency percentiles, misses, underruns
    with a 1- and 2-block buffer, arrival jitter and the p99 headroom."""
    lat = np.asarray(lat_ms, np.float64)
    p99 = float(np.percentile(lat, 99))
    out = {
        "blocks": int(len(lat)),
        "block_dt_ms": round(block_dt_ms, 3),
        "wall_s": round(len(lat) * block_dt_ms / 1e3, 3),
        "latency_ms": {
            "p50": round(float(np.percentile(lat, 50)), 3),
            "p90": round(float(np.percentile(lat, 90)), 3),
            "p99": round(p99, 3),
            "max": round(float(lat.max()), 3),
        },
        "deadline_misses": int((lat > block_dt_ms).sum()),
        # a radio front end buffers a couple of blocks: a sample is lost
        # only when a completion slips past the deadline plus the buffer
        "underruns_1_block_buffer": int((lat > 2 * block_dt_ms).sum()),
        "underruns_2_block_buffer": int((lat > 3 * block_dt_ms).sum()),
        "arrival_jitter_ms_max": round(float(np.max(jit_ms)), 3),
        "rt_headroom_p99": round(block_dt_ms / p99, 2),
    }
    out.update(extra)
    return out


def leg_rx(seconds: float = SECONDS, device=None, *, M: int = 1024,
           block: int = BLOCK, timeout: Optional[float] = None) -> dict:
    """Paced receive for ``seconds`` (whole periods of the pool, at
    least one) at M x 30 kHz samples/s."""
    dev = resolve_device(device)
    spec = production_spec(M)
    rate = M * CHANNEL_RATE
    pool, planted = stage_pool(spec, dev, block)
    block_dt = block / rate
    n_blocks = int(np.ceil(seconds / block_dt))
    n_blocks = max(POOL_BLOCKS, n_blocks - n_blocks % POOL_BLOCKS)
    # a scratch receiver of the same shapes takes the first calls' costs
    warm = _receiver(spec, dev)
    for b in range(2):
        warm.push(pool[b])
    del warm

    rx = _receiver(spec, dev)
    reports, lat, jit, backlog = [], [], [], []
    state = {"b": 0}
    t0 = time.monotonic() + 0.2

    def source():
        b = state["b"]
        if b >= n_blocks:
            return None
        state["b"] = b + 1
        arrival = t0 + (b + 1) * block_dt     # the block has fully arrived
        now = time.monotonic()
        if now < arrival:
            time.sleep(arrival - now)
        jit.append((time.monotonic() - arrival) * 1e3)
        # how far the previous completion overran this arrival
        late = (lat[-1] / 1e3 - block_dt) if lat else 0.0
        backlog.append(max(0.0, late))
        return pool[b % POOL_BLOCKS]

    def push(blk):
        b = state["b"] - 1
        reports.extend(rx.push(blk))
        lat.append((time.monotonic() - (t0 + (b + 1) * block_dt)) * 1e3)

    gc.collect()
    gc.disable()      # a collection mid-deadline is a spurious tail spike
    try:
        ex = ThreadedExecutor(rx_source=source, rx_push=push).start()
        ex.join(timeout=timeout or seconds * 2 + 300)
    finally:
        gc.enable()
    reports.extend(rx.flush())

    periods = n_blocks // POOL_BLOCKS
    expect = periods * len(planted)
    per_event = [0] * len(planted)
    exact = 0
    for r in reports:
        for i, p in enumerate(planted):
            nw = p.words.shape[0]
            if r.channel == p.event.channel and r.word_ok[:nw].all() \
                    and np.array_equal(r.words[:nw], p.words):
                per_event[i] += 1
                exact += 1
                break
    return summarize(lat, block_dt * 1e3, jit, {
        "leg": "rx_paced", "rate_msps": rate / 1e6,
        "reports": len(reports), "reports_expected": expect,
        "reports_word_ok": int(sum(bool(r.word_ok[:2].all())
                                   for r in reports)),
        "reports_exact": exact,
        "exactly_once_per_period": bool(
            all(c == periods for c in per_event) and len(reports) == expect),
        "max_backlog_s": round(max(backlog), 3) if backlog else 0.0})


def leg_fdx(seconds: float = SECONDS, device=None, *, threaded: bool = True,
            M: int = 1024, timeout: Optional[float] = None) -> dict:
    """Paced full duplex for ``seconds``: each block's deadline
    synthesizes two FOCC frames of random words on every channel
    and pushes the block through the receiver; ``threaded=False`` runs
    TX then RX in one thread."""
    dev = resolve_device(device)
    spec = production_spec(M)
    rate = M * CHANNEL_RATE
    frames = FDX_FRAMES
    n_hops = frames * 463 * 2 * spec.chan_sps
    block = n_hops * spec.chz_spec.hop
    block_dt = block / rate
    n_blocks = int(np.ceil(seconds / block_dt))
    rng = np.random.default_rng(0)
    wp = torch.as_tensor(rng.integers(0, 2, (M, frames, 2, 28))
                         .astype(np.uint8), device=dev)

    def tx_run():
        return tx_multichannel_block(wp, spec)

    warm = _receiver(spec, dev)
    warm.push(tx_run())
    del warm

    rx = _receiver(spec, dev)
    q = BlockQueue(depth=2)
    lat, jit, qdepth = [], [], []
    state = {"tx": 0, "rx": 0}
    t0 = time.monotonic() + 0.2

    def tx_step():
        b = state["tx"]
        if b >= n_blocks:
            q.close()
            return None
        state["tx"] = b + 1
        deadline = t0 + b * block_dt               # produce block b now
        now = time.monotonic()
        if now < deadline:
            time.sleep(deadline - now)
        jit.append((time.monotonic() - deadline) * 1e3)
        return tx_run()

    def rx_source():
        qdepth.append(q._q.qsize())
        return q.get()

    def rx_push(blk):
        b = state["rx"]
        state["rx"] = b + 1
        rx.push(blk)
        # block b's samples have left the antenna by t0 + (b+1) dt: the
        # whole TX + RX round of full duplex stays ahead of that clock
        lat.append((time.monotonic() - (t0 + b * block_dt)) * 1e3)

    gc.collect()
    gc.disable()
    try:
        if threaded:
            ex = ThreadedExecutor(tx_step=tx_step, tx_sink=q.put,
                                  rx_source=rx_source,
                                  rx_push=rx_push).start()
            ex.join(timeout=timeout or seconds * 2 + 300)
        else:
            while True:
                blk = tx_step()
                if blk is None:
                    break
                rx_push(blk)
    finally:
        gc.enable()
    return summarize(lat, block_dt * 1e3, jit, {
        "leg": "full_duplex_paced_loopback"
               + ("" if threaded else "_single_thread"),
        "rate_msps": rate / 1e6,
        "tx_blocks": state["tx"], "rx_blocks": state["rx"],
        "max_queue_depth": int(max(qdepth)) if qdepth else 0})


LEGS = {"rx": leg_rx, "fdx": leg_fdx,
        "fdx1": lambda seconds, device=None, **kw: leg_fdx(
            seconds, device, threaded=False, **kw)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m amps_tpu_torch.eval.pacing",
        description="Paced real-time legs of the 1024-channel station.")
    ap.add_argument("legs", nargs="*", choices=sorted(LEGS),
                    help="default: rx fdx")
    ap.add_argument("--seconds", type=float, default=SECONDS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps({"device": str(dev),
                      "name": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "spec": "1024ch bench config",
                      "rate_msps": 1024 * CHANNEL_RATE / 1e6}), flush=True)
    for name in args.legs or ["rx", "fdx"]:
        t0 = time.time()
        res = LEGS[name](args.seconds, dev)
        res["leg_wall_s_total"] = round(time.time() - t0, 1)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
