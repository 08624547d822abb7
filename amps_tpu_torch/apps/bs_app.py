"""BS-in-a-box application -- the grc/ampsbs.grc equivalent, the PyTorch
port of ``apps/bs_app.py``.

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
(``--device cpu`` runs the kernels' plain versions).

``--mesh TxC`` runs the multi-device station: ``ShardedTransceiver``
full-duplex blocks over a (time, chan) worker mesh under the same
control plane (command server, BaseStation, SAT/ST supervision through
the sharded analysis).  The T*C workers go round-robin over the visible
cards (all on one card when there is one), or all on ``--device``.

Examples:
  python -m amps_tpu_torch bs --channels 8 --simulate origination:5551234567:5551230000
  python -m amps_tpu_torch bs --channels 1024 --rx-in capture.f32 --superframes 4
  python -m amps_tpu_torch bs --mesh 2x2 --channels 1024 --voice-slot-map 355:4,356:5 --simulate mobile:5551234567:originate:7025551000
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
                   help="channelizer bank size M (any even M >= 2 on "
                        "the card: up to 16384 and M = C*N with C <= 8, "
                        "N <= 4096 up to 32768 in shared memory, every "
                        "other M through device memory; M x 30 kHz is the "
                        "radio's sample rate)")
    p.add_argument("--control-slot", type=int, default=1,
                   help="bank slot carrying the FOCC")
    p.add_argument("--superframes", type=int, default=2,
                   help="forward superframes to run")
    p.add_argument("--tx-out", type=str, default=None,
                   help="write wideband TX IQ (raw float32 interleaved)")
    p.add_argument("--rx-in", type=str, default=None,
                   help="read wideband RX IQ (raw float32 interleaved)")
    p.add_argument("--simulate", type=str, action="append", default=[],
                   help="single-device mode -- one-shot mobile event on "
                        "slot 3 of the reverse band: origination:MIN:DIALED "
                        "| page_response:MIN | registration:MIN[:ESN].  "
                        "Mesh mode -- a live scripted mobile: mobile:MIN "
                        "(answers a page, hangs up) | mobile:MIN:hangup:N "
                        "(paged; talks N blocks) | mobile:MIN:originate:"
                        "DIGITS[:BLOCK[:HANGUP_AFTER]] | "
                        "mobile:MIN:register[:BLOCK]; repeatable")
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
                   help="run the multi-device station: a 'TxC' worker mesh "
                        "(e.g. 2x2) of ShardedTransceiver full-duplex "
                        "blocks under the same control plane; the workers "
                        "go round-robin over the visible cards")
    p.add_argument("--fvc-slot", type=int, default=None,
                   help="bank slot carrying the FVC blank-and-burst stream "
                        "in mesh mode (default control_slot+1)")
    p.add_argument("--blocks", type=int, default=40,
                   help="mesh mode: most full-duplex blocks to run (the "
                        "loop ends early once the simulated calls are torn "
                        "down)")
    p.add_argument("--sup-timers", type=str, default=None,
                   help="compress supervision timers for demos: "
                        "'<fade_s>:<st_release_s>' (e.g. 2.0:0.8)")
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


def _run_mesh(args, result: dict | None = None):
    """The multi-device station: the sharded full-duplex transceiver
    under the control plane -- the command server (an operator 'page'
    in through the socket, the reference's Socket PDU), BaseStation call
    control, and SAT/ST supervision measured through the sharded analysis
    (the RVC tap of grc/ampsbs_rvc.grc).

    With ``--simulate mobile:MIN`` a scripted SimMobile lives on the
    reverse band: it hears the sharded FOCC/FVC wideband through its own
    analysis bank, answers on the RECC (slot 3), transponds SAT + ST on
    its assigned voice channel, answers one block after ringing and hangs
    up after three conversation blocks.  ``result`` (optional dict)
    receives the command server's bound port (``"port"``) once it
    serves, and at the end the station, the mobiles, the timeline, the
    host time of each block (seconds) and the RX samples a block."""
    import dataclasses

    import numpy as np

    from amps_tpu_torch.control.server import CommandServer
    from amps_tpu_torch.control.station import BaseStation
    from amps_tpu_torch.dsp import channelizer as chz
    from amps_tpu_torch.dsp.fm import fm_modulate_symbols, quadrature_demod
    from amps_tpu_torch.ms import SimMobile
    from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from amps_tpu_torch.parallel.pipeline import MultichannelSpec
    from amps_tpu_torch.parallel.stream import ShardedTransceiver
    from amps_tpu_torch.runtime.sources import VoiceFvcSlot
    from amps_tpu_torch.utils.profiling import meter, trace

    T, C = (int(v) for v in args.mesh.lower().split("x"))
    mesh = make_mesh(MeshSpec(time=T, chan=C),
                     None if args.device is None else [args.device])
    dev = mesh.device
    if dev.type == "cuda":
        from amps_tpu_torch.kernels import build
        build.load()
    spec = MultichannelSpec(num_channels=args.channels)
    M, Phop, SPS = args.channels, args.channels // 2, spec.chan_sps
    system, per_chan = _station_config(args)
    station = BaseStation(system, sps=SPS, per_channel_fvc=per_chan)
    if args.sup_timers:
        fade_s, st_s = (float(v) for v in args.sup_timers.split(":"))
        station.supervision_config = dataclasses.replace(
            station.supervision_config, fade_timeout_s=fade_s,
            st_release_s=st_s)

    # voice-slot map: bank_slot -> AMPS channel (RVC supervision tap)
    slot_map = {}
    for pair in filter(None, args.voice_slot_map.split(",")):
        chan_s, slot_s = pair.split(":")
        slot_map[int(slot_s)] = int(chan_s)
    chan_to_slot = {c: s for s, c in slot_map.items()}

    def on_burst(rep):
        print(f"[rx] burst ch={rep.channel} q={rep.quality:.2f} "
              f"ok={int(rep.word_ok.sum())}/7 rssi={rep.rssi:.3f}")
        station.handle_burst(rep.words, rep.word_ok, rep.bad_symbols)

    def on_sup(slot, lv, pw):
        station.push_supervision(slot_map[slot], lv, pw)

    trx = ShardedTransceiver(
        mesh, spec, system=system, control_channels=[args.control_slot],
        threshold=0.5, min_rssi=args.min_rssi, on_burst=on_burst,
        supervision_slots=tuple(sorted(slot_map)),
        on_supervision=on_sup if slot_map else None)
    station.focc = trx.focc[args.control_slot]
    # every mapped voice slot carries its blank-and-burst voice channel
    # (FVC data or voice + SAT by its own mute pair); the FVC slot carries
    # the shared stream unless it is mapped
    for bank_slot, amps_chan in slot_map.items():
        trx.set_channel_source(
            bank_slot, VoiceFvcSlot(station,
                                    chan=amps_chan if per_chan else None,
                                    device=dev))
    fvc_slot = (args.fvc_slot if args.fvc_slot is not None
                else args.control_slot + 1)
    if fvc_slot not in slot_map:
        trx.set_channel_source(fvc_slot, VoiceFvcSlot(station, device=dev))

    # reverse-band block: each time row's span (block hops / T) must
    # cover the carried halo (trx.ovr channel samples)
    rxh = T * (-(-(trx.ovr + 8) // C) * C)
    sens = spec.fm_sensitivity
    fs = float(spec.pipe.chan_rate)

    mobs = []        # {mob, action, sched}
    for ev in args.simulate:
        parts = ev.split(":")
        if parts[0] == "mobile":
            mobs.append({"mob": SimMobile(parts[1], sps=SPS, system=system),
                         "action": tuple(parts[2:]) if len(parts) > 2
                         else None,
                         "sched": {"ring": 0, "conv": 0}})
        else:
            print(f"[bs] mesh mode ignores --simulate {ev!r}: use "
                  f"'mobile:MIN[:originate:DIGITS[:BLOCK[:N]]]' "
                  f"(live scripted mobile)", file=sys.stderr)
    mob = mobs[0]["mob"] if mobs else None
    REVERSE_SLOT = 3
    # the mobiles' ear and the reverse-band "ether" are continuous
    # streams: both carry their state across blocks (a fresh synthesizer
    # a block puts an FM click at every boundary, which breaks the
    # supervision tone runs)
    ana_state = {"s": chz.analyzer_init(spec.chz_spec, device=dev)}
    rev_state = {"s": chz.synthesizer_init(spec.chz_spec, device=dev)}
    sched = {"block": 0}
    block_s = []

    def hear(m, action, ms, ya):
        """One mobile hears the block and acts on its script."""
        m.hear_focc(quadrature_demod(ya[args.control_slot])[0].cpu().numpy(),
                    sps=SPS)
        # FVC data arrives on the mobile's assigned voice channel
        # (per-channel mode) or the shared slot
        fvc_bank = (chan_to_slot.get(m.voice_chan, fvc_slot) if per_chan
                    else fvc_slot)
        m.hear_fvc(quadrature_demod(ya[fvc_bank])[0].cpu().numpy(), sps=SPS)
        # originate at its block (default 2), answer one block after
        # ringing, hang up after hangup_after (default 3) conversation
        # blocks
        if (action and action[0] == "originate" and m.state == "idle"
                and sched["block"] ==
                (int(action[2]) if len(action) > 2 else 2)):
            m.originate(action[1])
        elif (action and action[0] == "register" and "register" not in m.log
                and sched["block"] >=
                (int(action[1]) if len(action) > 1 else 2)):
            # retried until the access queues: with concurrent mobiles
            # the busy/idle bit can read busy at the scheduled block
            m.register()
        hang_after = 3
        if action and action[0] == "originate" and len(action) > 3:
            hang_after = int(action[3])
        elif action and action[0] == "hangup":
            hang_after = int(action[1])
        if m.state == "ringing":
            ms["ring"] += 1
            if ms["ring"] >= 2:
                m.answer()
        elif m.state == "conversation":
            ms["conv"] += 1
            if ms["conv"] > hang_after:
                m.hang_up()

    def one_block():
        """One full-duplex sharded block: the reverse band in, TX out, the
        mobiles' ears fed from the TX wideband."""
        t0 = time.perf_counter()
        Y = torch.zeros((rxh, M, 2), device=dev)
        cursor = 2000
        for rec in mobs:
            m = rec["mob"]
            # stagger concurrent accesses on the shared RECC; a burst
            # that does not fit this block waits for the next one
            if m.outbox and cursor + len(m.outbox[0][1]) <= rxh:
                _, syms = m.outbox.pop(0)
                bb = fm_modulate_symbols(
                    torch.as_tensor(syms.astype(np.int8), device=dev),
                    sens)[0]
                Y[cursor: cursor + bb.shape[0], REVERSE_SLOT] = bb
                cursor += bb.shape[0] + 2000
            if m.voice_chan in chan_to_slot:
                Y[:, chan_to_slot[m.voice_chan]] += torch.as_tensor(
                    m.rvc_baseband(rxh, fs, sens), device=dev)
        x_rx, rev_state["s"] = chz.synthesize(Y, spec.chz_spec,
                                              rev_state["s"])
        with trace("bs_app.mesh_block"):
            tx, _ = trx.push(x_rx)
        if mobs:
            ya, ana_state["s"] = chz.analyze(tx, spec.chz_spec,
                                             ana_state["s"], chmajor=True)
            sched["block"] += 1
            for rec in mobs:
                hear(rec["mob"], rec["action"], rec["sched"], ya)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        block_s.append(time.perf_counter() - t0)
        return tx.shape[0]

    async def run():
        server = None
        if not args.no_server:
            server = CommandServer(station, port=args.port)
            await server.start()
            print(f"[ctl] command server on 127.0.0.1:{server.port} "
                  f"(mesh {T}x{C})")
            if result is not None:
                result["port"] = server.port
        tx_meter = meter("tx_wideband", dev)
        loop = asyncio.get_running_loop()
        had_call = False
        for b in range(args.blocks):
            ntx = await loop.run_in_executor(None, one_block)
            tx_meter.update(ntx)
            print(f"[bs] block {b}: tx {ntx} samples "
                  f"({tx_meter.rate / 1e6:.1f} Msps), rx {rxh * Phop}; "
                  f"calls={sorted(station.supervisors)}"
                  + (f" mob={mob.state}" if mob else ""))
            had_call = had_call or bool(station.supervisors)
            if (mobs and had_call and not station.supervisors
                    and all(r["mob"].state == "released" for r in mobs)):
                print("[bs] call(s) complete and torn down")
                break
        if server:
            await server.stop()

    asyncio.run(run())
    timeline = [(e.kind, e.payload.kind if hasattr(e.payload, "kind")
                 else e.payload) for e in station.events
                if e.kind in ("supervision_event", "release", "handoff")]
    print(f"[bs] station events: {timeline}")
    for rec in mobs:
        print(f"[bs] mobile {rec['mob'].min_str} log: {rec['mob'].log}")
    if result is not None:
        result.update(station=station, mob=mob,
                      mobs=[r["mob"] for r in mobs], timeline=timeline,
                      block_s=block_s, rx_samples=rxh * Phop)


def main(argv=None, _result: dict | None = None):
    """Run the station.  ``_result`` (optional dict) receives the
    command server's bound port (``"port"``, the free one of ``--port
    0``) once it serves, and at the end the station, the executor's
    stats, the receiver's reports, the two RateMeters and the per-block
    host times of the TX and RX threads (seconds), for tests and
    measurement scripts."""
    args = build_parser().parse_args(argv)
    if args.mesh:
        _run_mesh(args, _result)
        return

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
            if _result is not None:
                _result["port"] = server.port

        tx_meter = meter("tx_wideband", dev)
        rx_meter = meter("rx_wideband", dev)
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
