"""RECC capture replay/monitor -- the grc/recctest.grc equivalent, the
PyTorch port of ``apps/recc_monitor.py``.

Replays a recorded (or synthesized) 400 ksps IQ capture through the
single-channel reference-parity RX chain: freq-xlating FIR (-160 kHz,
decim 2) -> FM discriminator -> correlator timing recovery -> burst
decode -> parsed words printed.  The file format is raw interleaved
float32 I/Q, like GR file sinks.  Runs on the current CUDA device
unless ``--device`` names another.

  python -m amps_tpu_torch monitor capture.f32
  python -m amps_tpu_torch monitor --synthesize origination:5551234567:5551230000 out.f32
      (writes a synthetic capture, then decodes it -- self-test mode)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def synthesize_capture(path: str, events, rx_offset=-160e3, device=None):
    """Write a 400 ksps capture with MS bursts at the rx_offset (where
    the reference's front end expects the reverse channel); returns its
    sample count.  The modulation runs on ``device`` (default the current
    CUDA device), the frequency shift on the host."""
    from amps_tpu_torch.config import PipelineConfig
    from amps_tpu_torch.device import resolve_device
    from amps_tpu_torch.eval.traffic import MobileEvent
    from amps_tpu_torch.tx import recc_ms
    from amps_tpu_torch.tx.modulator import fm_modulate

    dev = resolve_device(device)
    pipe = PipelineConfig()
    blocks = []
    lead = np.tile(np.array([1, -1], np.int8), 2000)
    for ev in events:
        words = MobileEvent.parse(ev).words()
        syms = recc_ms.burst_symbols(words, 0, pipe.sps)
        stream = np.concatenate([lead, syms, lead]).astype(np.int8)
        bb, _ = fm_modulate(torch.as_tensor(stream, device=dev), pipe)
        bb = bb.cpu().numpy()                      # 400 ksps riq
        # place at rx_offset
        n = len(bb)
        t = np.arange(n) / pipe.rx_rate
        lo = np.stack([np.cos(2 * np.pi * rx_offset * t),
                       np.sin(2 * np.pi * rx_offset * t)],
                      -1).astype(np.float32)
        shifted = np.stack([bb[:, 0] * lo[:, 0] - bb[:, 1] * lo[:, 1],
                            bb[:, 0] * lo[:, 1] + bb[:, 1] * lo[:, 0]], -1)
        blocks.append(shifted)
    cap = np.concatenate(blocks)
    cap.astype(np.float32).tofile(path)
    return len(cap)


def monitor(path: str, rx_offset=-160e3, threshold=0.5, device=None):
    """Decode every burst of the capture at ``path`` on ``device``
    (default the current CUDA device), print each one's words, and
    return how many were found."""
    from amps_tpu_torch.config import PipelineConfig
    from amps_tpu_torch.control import fields
    from amps_tpu_torch.device import resolve_device
    from amps_tpu_torch.rx.correlator import CAPTURE_SYMBOLS, find_and_extract
    from amps_tpu_torch.rx.decoder import decode_bursts
    from amps_tpu_torch.rx.frontend import rx_frontend

    dev = resolve_device(device)
    pipe = PipelineConfig()
    iq = np.fromfile(path, dtype=np.float32).reshape(-1, 2)
    n = len(iq) - len(iq) % pipe.rx_decim
    demod, _ = rx_frontend(torch.as_tensor(iq[:n], device=dev), pipe,
                           center_freq=rx_offset)
    sps = (pipe.rx_rate // pipe.rx_decim) // pipe.baud  # 10
    demod = torch.cat([demod, demod.new_zeros(CAPTURE_SYMBOLS * sps)])
    starts, valid, quality, hard, _ = find_and_extract(
        demod, sps, max_bursts=8, threshold=threshold)
    dec = decode_bursts(hard)
    starts, valid, quality = (a.cpu().numpy()
                              for a in (starts, valid, quality))
    words_all, ok_all = dec.words.cpu().numpy(), dec.word_ok.cpu().numpy()
    found = 0
    for k in range(len(valid)):
        if not valid[k]:
            continue
        found += 1
        words, ok = words_all[k], ok_all[k]
        print(f"burst @{int(starts[k])} q={float(quality[k]):.2f} "
              f"words_ok={ok.astype(int).tolist()}")
        if ok[0]:
            wa = fields.RxWordA.parse(words[0])
            line = (f"  A: T={int(wa.T)} S={int(wa.S)} NAWC={wa.NAWC} "
                    f"MIN1={wa.MIN1:#08x}")
            if ok[1]:
                wb = fields.RxWordB.parse(words[1])
                line += (f" | B: ORDER={wb.ORDER:#x} ORDQ={wb.ORDQ} "
                         f"MIN={fields.calc_min(wa.MIN1, wb.MIN2)}")
            print(line)
    print(f"{found} burst(s) decoded from {len(iq)} samples")
    return found


def main(argv=None):
    p = argparse.ArgumentParser(description="RECC capture monitor")
    p.add_argument("capture", help="raw float32 interleaved IQ @400 ksps")
    p.add_argument("--synthesize", action="append", default=[],
                   help="write a synthetic capture first "
                        "(origination:MIN:DIALED | page_response:MIN | "
                        "registration:MIN[:ESN])")
    p.add_argument("--rx-offset", type=float, default=-160e3)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device)")
    args = p.parse_args(argv)

    if args.synthesize:
        n = synthesize_capture(args.capture, args.synthesize,
                               args.rx_offset, device=args.device)
        print(f"wrote {n} samples to {args.capture}")
    found = monitor(args.capture, args.rx_offset, device=args.device)
    return 0 if found else 1


if __name__ == "__main__":
    sys.exit(main())
