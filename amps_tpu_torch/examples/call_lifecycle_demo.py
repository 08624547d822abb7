"""Full call lifecycle, closed loop, no radio -- the PyTorch port of
``examples/call_lifecycle_demo.py``.

A BaseStation and a SimMobile talk through the real air-interface
encodings in both directions: page (FOCC frames with busy/idle bits) ->
page response (RECC burst through the correlator + BCH decoder) ->
voice assignment (FOCC) -> alert (FVC blank-and-burst) -> ringing ->
answer (ST drop) -> handoff 355->356 (FVC designation) -> mobile
release (1.8 s ST).  The reference required real phones for any of
this.

Run: ``main()`` (the RECC capture on the current CUDA device) or
``main(device="cpu")``.
"""

from __future__ import annotations

import numpy as np
import torch

SPS = 5


def deliver_recc(bs, syms, dev):
    from amps_tpu_torch.rx import correlator, decoder

    lead = np.tile(np.array([1, -1], np.int8), 300)
    stream = np.concatenate(
        [lead, syms, np.zeros(correlator.CAPTURE_SYMBOLS * SPS, np.int8)]
    ).astype(np.float32)
    _, valid, _, hard, _ = correlator.find_and_extract(
        torch.as_tensor(stream, device=dev), SPS, max_bursts=1,
        threshold=0.5)
    assert bool(valid[0])
    dec = decoder.decode_bursts(hard[0])
    bs.handle_burst(dec.words.cpu().numpy(), dec.word_ok.cpu().numpy())


def main(device=None):
    from amps_tpu_torch.control.station import BaseStation
    from amps_tpu_torch.device import resolve_device
    from amps_tpu_torch.ms import SimMobile

    dev = resolve_device(device)
    bs = BaseStation(on_event=lambda e: print(f"  [bs] {e.kind}: "
                                              f"{str(e.payload)[:60]}"))
    mob = SimMobile("5551234567", sps=SPS)

    print("== operator pages the mobile ==")
    bs.handle_command("page 5551234567")
    mob.hear_focc(np.asarray(bs.focc.next_superframe_symbols(), np.float32))
    print(f"  [ms] log: {mob.log}")

    print("== mobile seizes the RECC; station assigns channel 355 ==")
    _, burst = mob.outbox.pop(0)
    deliver_recc(bs, burst, dev)
    mob.hear_focc(np.asarray(bs.focc.next_superframe_symbols(), np.float32))
    print(f"  [ms] voice_chan={mob.voice_chan} recc_busy_seen={mob.recc_busy}")

    print("== FVC alert rings the mobile; user answers ==")
    mob.hear_fvc(bs.fvc.next_block(1032 * 2 * SPS + 500).astype(np.float32))
    bs.push_supervision(355, *mob.supervision_frames(30))
    mob.answer()
    bs.push_supervision(355, *mob.supervision_frames(30))
    print(f"  [ms] state={mob.state}; station audio_mute={bs.audio_mute}")

    print("== operator hands the call off to channel 356 ==")
    bs.handle_command("handoff 355 356")
    mob.hear_fvc(bs.fvc.next_block(1032 * 2 * SPS + 500).astype(np.float32))
    bs.push_supervision(356, *mob.supervision_frames(50))
    print(f"  [ms] voice_chan={mob.voice_chan}")

    print("== mobile hangs up (1.8 s signaling tone) ==")
    mob.hang_up()
    bs.push_supervision(356, *mob.supervision_frames(200))
    print(f"  [ms] log: {mob.log}")
    assert 356 not in bs.supervisors
    print("call torn down cleanly.")
    return mob.log


if __name__ == "__main__":
    main()
