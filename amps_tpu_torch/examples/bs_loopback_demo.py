"""BS-in-a-box loopback demo (no radio), the PyTorch port of
``examples/bs_loopback_demo.py``.

An 8-slot channelizer base station: slot 1 runs a FOCC; a simulated
mobile originates a call on the reverse band; the station assigns a
voice channel and pages the dialed number -- the §3.2 chain of the
reference (recc -> recc_decode -> focc/command_processor) end to end on
the array pipeline.

Run: python -m amps_tpu_torch demo  (the current CUDA device), or
``main(device="cpu")``.
"""

from __future__ import annotations

import torch


def main(device=None):
    from amps_tpu_torch.control.station import BaseStation
    from amps_tpu_torch.device import resolve_device
    from amps_tpu_torch.dsp import channelizer as chz
    from amps_tpu_torch.dsp.fm import fm_modulate_symbols
    from amps_tpu_torch.parallel.pipeline import MultichannelSpec
    from amps_tpu_torch.runtime.streamer import (MultichannelReceiver,
                                                 MultichannelTransmitter)
    from amps_tpu_torch.tx import recc_ms

    dev = resolve_device(device)
    spec = MultichannelSpec(num_channels=8, taps_per_phase=8)
    sps = spec.chan_sps
    fs = spec.chz_spec.num_channels * spec.chz_spec.spacing_hz

    station = BaseStation()
    tx = MultichannelTransmitter(spec, control_channels=[1], device=dev)
    station.focc = tx.focc[1]  # station's FOCC words go out on slot 1

    def on_burst(rep):
        print(f"[rx] burst on channel {rep.channel} "
              f"q={rep.quality:.2f} words_ok={rep.word_ok.tolist()}")
        station.handle_burst(rep.words, rep.word_ok, rep.bad_symbols)

    rx = MultichannelReceiver(spec, on_burst=on_burst, threshold=0.5,
                              device=dev)

    # --- forward: one superframe of RF ---
    rf = tx.next_block()
    print(f"[tx] wideband superframe: {rf.shape[0]} samples "
          f"({rf.shape[0] / fs * 1e3:.1f} ms of RF at {fs / 1e6:.2f} Msps)")

    # --- reverse: a mobile originates a call on slot 3 ---
    words = recc_ms.origination_words("5551234567", "5551230000")
    syms = recc_ms.burst_symbols(words, dcc=0, sps=sps)
    bb, _ = fm_modulate_symbols(torch.as_tensor(syms, device=dev),
                                spec.fm_sensitivity)
    hops = 40960
    Y = torch.zeros((hops, 8, 2), device=dev)
    Y[2000:2000 + bb.shape[0], 3] = bb
    rev_rf, _ = chz.synthesize(Y, spec.chz_spec,
                               chz.synthesizer_init(spec.chz_spec,
                                                    device=dev))
    print("[ms] origination burst transmitted on reverse slot 3 "
          "(dialing 5551230000)")

    rx.push(rev_rf)

    print("[station] events:")
    for ev in station.events:
        if ev.kind in ("debug", "command"):
            print(f"   {ev.kind}: {str(ev.payload).strip()}")
        else:
            print(f"   {ev.kind}")
    print(f"[station] FOCC queue depth: {station.focc.queue_depth()} "
          f"(voice assignment + page words await the next superframe)")
    assert any(ev.kind == "command" for ev in station.events), \
        "the origination was not dispatched"

    # next superframe carries the response; the page is REPEATED over
    # SystemConfig.page_repeats superframes (so a mobile deferring
    # during a busy-marked superframe still hears one), so the queue
    # drains over that many blocks
    for k in range(station.system.page_repeats):
        rf2 = tx.next_block()
        print(f"[tx] superframe {k + 1} sent ({rf2.shape[0]} samples); "
              f"queue depth now {station.focc.queue_depth()}")
    assert station.focc.queue_depth() == 0
    print("[tx] assignment and repeated page delivered")
    return 0


if __name__ == "__main__":
    main()
