"""BS-in-a-box application -- the grc/ampsbs.grc equivalent, the PyTorch
port of the single-device mode of ``apps/bs_app.py``.

A running AMPS base station over the multichannel pipeline:

* forward: FOCC on the configured control slot, synthesized
  superframe-by-superframe into wideband IQ on the device by the
  synthesis kernel (written to --tx-out, a raw interleaved float32 I/Q
  file, or discarded on the device);
* reverse: wideband IQ blocks read from --rx-in (raw float32 I/Q file,
  e.g. a recorded capture resampled to the bank rate) or from the
  built-in mobile simulator (--simulate), demodulated by the front-end
  kernel and decoded;
* control: TCP command server on port 64652 ('page <MIN>',
  'fvc on/off/alert'), plus automatic call handling (page response /
  registration / origination) exactly as the reference dispatches.

Three threads: the TX feeder and the RX drainer of
``runtime.executor.ThreadedExecutor`` launch on the card; the control
plane (the TCP server and the call state) stays on the asyncio thread.
Both device threads launch on the current stream, so their kernels run
one after another.  No CUDA graph is captured here: a capture fails
while another thread launches.

Runs on the current CUDA device unless ``--device`` names another
(``--device cpu`` runs the kernels' plain versions).  The multi-device
``--mesh`` mode of the JAX package is not ported yet (ROADMAP M7).

Examples:
  python -m amps_tpu_torch bs --channels 8 --simulate origination:5551234567:5551230000
  python -m amps_tpu_torch bs --channels 1024 --rx-in capture.f32 --superframes 4
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

import torch


def _station_config(args):
    """(SystemConfig, per_channel_fvc) from the CLI args.  With mapped
    voice slots the station runs per-channel FVC streams, and the
    voice-channel PLAN is the mapped channels themselves: capacity
    scales with the map (the reference hardcodes two channels,
    lib/recc_decode_impl.cc:205,252), and assigning an unmapped plan
    channel would leave its FVC stream unpulled (alert never
    transmits; the release-pending withholding would then leak the
    channel from the pool forever)."""
    from amps_tpu_torch.config import SystemConfig
    per_chan = bool(args.voice_slot_map)
    mapped_chans = tuple(sorted(
        int(pair.split(":")[0])
        for pair in filter(None, args.voice_slot_map.split(","))))
    system = SystemConfig(
        aggressive_registration=args.aggressive_registration,
        **({"voice_channels": mapped_chans} if per_chan else {}))
    return system, per_chan


def build_parser():
    p = argparse.ArgumentParser(description="amps_tpu_torch BS-in-a-box")
    p.add_argument("--channels", type=int, default=8,
                   help="channelizer bank size M (a power of two, >= 8)")
    p.add_argument("--control-slot", type=int, default=1,
                   help="bank slot carrying the FOCC")
    p.add_argument("--superframes", type=int, default=2,
                   help="forward superframes to run")
    p.add_argument("--tx-out", type=str, default=None,
                   help="write wideband TX IQ (raw float32 interleaved)")
    p.add_argument("--rx-in", type=str, default=None,
                   help="read wideband RX IQ (raw float32 interleaved)")
    p.add_argument("--simulate", type=str, action="append", default=[],
                   help="one-shot mobile event on slot 3 of the reverse "
                        "band: origination:MIN:DIALED | page_response:MIN "
                        "| registration:MIN[:ESN]; repeatable")
    p.add_argument("--port", type=int, default=64652,
                   help="TCP command port (reference Socket PDU port; 0 "
                        "binds a free one)")
    p.add_argument("--voice-slot-map", type=str, default="",
                   help="AMPS_chan:bank_slot pairs for RVC supervision, "
                        "e.g. '355:4,356:5' -- SAT/ST on those slots is "
                        "measured per block and drives call supervision")
    p.add_argument("--min-rssi", type=float, default=0.02,
                   help="per-channel band-power gate: FM capture of a "
                        "strong neighbor's leakage decodes cleanly on an "
                        "idle channel but at 20+ dB lower power; 0 "
                        "disables")
    p.add_argument("--no-server", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; "
                        "'cpu' runs the kernels' plain versions)")
    p.add_argument("--aggressive-registration", action="store_true",
                   help="38-frame registration superframe (reference flag)")
    p.add_argument("--mesh", type=str, default=None,
                   help="the multi-device station ('TxC' mesh) is not "
                        "ported yet (ROADMAP M7): naming it exits")
    return p


def _sim_block(text: str, spec, dev):
    """One reverse-band block of 16384 hops with the simulated mobile's
    burst on slot 3 from hop 1000 (DCC 0), made on ``dev``; None (and a
    message) for an unknown kind."""
    from amps_tpu_torch.eval.traffic import (MobileEvent,
                                             synthesize_reverse_band)
    try:
        ev = MobileEvent.parse(text, channel=3, start_hop=1000)
    except ValueError:
        print(f"unknown --simulate kind {text.split(':')[0]!r}",
              file=sys.stderr)
        return None
    return synthesize_reverse_band([ev], spec, 16384, device=dev)


def main(argv=None, _result: dict | None = None):
    """Run the station.  ``_result`` (optional dict) receives the
    station, the executor's stats, the receiver's reports, the two
    RateMeters and the per-block host times of the TX and RX threads
    (seconds), for tests and measurement scripts."""
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise SystemExit("bs --mesh: the multi-device station is not ported "
                         "yet (ROADMAP M7); run without --mesh")

    from amps_tpu_torch.control.server import CommandServer
    from amps_tpu_torch.control.station import BaseStation
    from amps_tpu_torch.device import resolve_device
    from amps_tpu_torch.parallel.pipeline import MultichannelSpec
    from amps_tpu_torch.runtime.executor import ThreadedExecutor
    from amps_tpu_torch.runtime.sdr import FileIQSink, FileIQSource
    from amps_tpu_torch.runtime.sources import VoiceFvcSlot
    from amps_tpu_torch.runtime.streamer import (MultichannelReceiver,
                                                 MultichannelTransmitter)
    from amps_tpu_torch.utils.profiling import meter, trace

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # build the kernels before the threads start, so that a first
        # nvcc build is not timed by the executor's join
        from amps_tpu_torch.kernels import build
        build.load()

    spec = MultichannelSpec(num_channels=args.channels)
    # mapped voice slots get per-channel FVC streams + blank-and-burst
    # sources (independent concurrent-call signaling); without a map the
    # station keeps the reference's single shared fvc block
    system, per_chan = _station_config(args)
    station = BaseStation(system, sps=spec.chan_sps,
                          per_channel_fvc=per_chan)
    tx = MultichannelTransmitter(spec, system,
                                 control_channels=[args.control_slot],
                                 device=dev)
    station.focc = tx.focc[args.control_slot]

    def on_burst(rep):
        print(f"[rx] burst ch={rep.channel} q={rep.quality:.2f} "
              f"ok={int(rep.word_ok.sum())}/7")
        station.handle_burst(rep.words, rep.word_ok, rep.bad_symbols)

    slot_map = {}
    for pair in filter(None, args.voice_slot_map.split(",")):
        chan_s, slot_s = pair.split(":")
        slot_map[int(slot_s)] = int(chan_s)
    for bank_slot, amps_chan in slot_map.items():
        tx.set_channel_source(
            bank_slot, VoiceFvcSlot(station, chan=amps_chan, device=dev))

    def on_supervision(slot, levels, power):
        station.push_supervision(slot_map[slot], levels, power)

    rx = MultichannelReceiver(spec, on_burst=on_burst, threshold=0.5,
                              pipeline_depth=2, min_rssi=args.min_rssi,
                              supervision_slots=tuple(slot_map),
                              on_supervision=(on_supervision
                                              if slot_map else None),
                              device=dev)

    async def run():
        server = None
        if not args.no_server:
            server = CommandServer(station, port=args.port)
            await server.start()
            print(f"[ctl] command server on 127.0.0.1:{server.port}")

        tx_meter = meter("tx_wideband")
        rx_meter = meter("rx_wideband")
        sim_blocks = [b for b in (_sim_block(ev, spec, dev)
                                  for ev in args.simulate) if b is not None]

        tx_sink = FileIQSink(args.tx_out) if args.tx_out else None
        rx_src = FileIQSource(args.rx_in) if args.rx_in else None
        P = spec.chz_spec.hop
        rx_block_samples = 16384 * max(P // 4, 1)
        tx_block_s, rx_block_s = [], []

        def tx_step():
            t0 = time.perf_counter()
            with trace("bs_app.tx_superframe"):
                blk = tx.next_block()      # stays on the device
            tx_meter.update(blk.shape[0])
            tx_block_s.append(time.perf_counter() - t0)
            print(f"[tx] superframe: {blk.shape[0]} samples "
                  f"({tx_meter.rate / 1e6:.1f} Msps)")
            return blk

        def tx_out(blk):
            if tx_sink:
                tx_sink.write(blk)         # the one copy to the host

        def rx_source():
            if rx_src is not None:
                blk = rx_src.read(rx_block_samples)
                if blk is None:
                    return None
                return blk[: (len(blk) // P) * P]
            if sim_blocks:
                return sim_blocks.pop(0)
            return None

        def rx_push(blk):
            t0 = time.perf_counter()
            with trace("bs_app.rx_block"):
                reports = rx.push(blk)
            rx_meter.update(blk.shape[0])
            rx_block_s.append(time.perf_counter() - t0)
            print(f"[rx] block: {blk.shape[0]} samples, "
                  f"{len(reports)} burst(s)")

        ex = ThreadedExecutor(tx_step=tx_step, tx_sink=tx_out,
                              rx_source=rx_source, rx_push=rx_push,
                              max_tx_blocks=args.superframes).start()
        while ex.alive:
            await asyncio.sleep(0.05)
        stats = ex.join(timeout=60)
        rx.flush()
        print(f"[run] tx {stats.tx_blocks} blocks "
              f"({stats.tx_samples} samples), rx {stats.rx_blocks} blocks "
              f"({stats.rx_samples} samples) in {stats.wall_s:.1f}s")

        for ev in station.events:
            if ev.kind in ("debug", "command"):
                print(f"[station] {ev.kind}: {str(ev.payload).strip()}")
        if tx_sink:
            tx_sink.close()
        if rx_src:
            rx_src.close()
        if server:
            await server.stop()
        if _result is not None:
            _result.update(station=station, stats=stats,
                           reports=list(rx.reports), tx_meter=tx_meter,
                           rx_meter=rx_meter, tx_block_s=tx_block_s,
                           rx_block_s=rx_block_s)

    asyncio.run(run())


if __name__ == "__main__":
    main()
