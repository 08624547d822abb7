"""The port's counterparts of ``__graft_entry__``: the flagship forward
``entry()`` and the multi-worker dry run of the sharded station.

``entry(device=None)`` returns ``(fn, (x,))``: ``fn`` is
``rx_multichannel_block`` at M=16, T=8 (on a CUDA device its front end
is the ``rx_phases`` kernel) and ``x`` the JAX entry's input, 8192
samples of N(0, 0.1) IQ from ``default_rng(0)``, on the device.

``dryrun_multichip(n_workers)`` drives the full sharded base-station
step (FOCC synthesis on every channel through the synthesis kernel,
reverse-band traffic through the analysis kernel, the all_to_all, demod,
trigger search and decode) over the squarest ``(time, chan)`` mesh of
``n_workers``, with the collectives of ``parallel.halo``, and proves the
stateful paths:

* three streaming steps with carried state at M=32, T=8 and the full
  demod halo decode planted bursts bit-exactly: one mid-row, one across
  a time-row boundary (when time > 1), one across the first block
  boundary and one in the last block;
* a checkpoint/restore through an .npz file between blocks 1 and 2 (the
  block-boundary burst spans exactly the restored carry);
* one pass of ``make_sharded_closed_loop_stream`` decoding a burst
  across a block boundary with external traffic.

It raises on any miss.  Run: ``python -c "from amps_tpu_torch.dryrun
import dryrun_multichip; dryrun_multichip(4)"`` (the workers share the
current CUDA device when there is one card; ``device="cpu"`` on the CPU).
"""

from __future__ import annotations

import os
import tempfile
from math import gcd

import numpy as np
import torch


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def entry(device=None):
    """(fn, example_args): the multichannel receive block (polyphase
    channelizer -> FM demod -> RECC correlate -> batched BCH word decode)
    at the JAX entry's spec and input, on ``device`` (the current CUDA
    device unless the CPU is named)."""
    from amps_tpu_torch.device import resolve_device
    from amps_tpu_torch.parallel.pipeline import (MultichannelSpec,
                                                  rx_multichannel_block)
    spec = MultichannelSpec(num_channels=16, taps_per_phase=8)
    n = 16 * 512   # wideband samples (a multiple of the hop)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 0.1, (n, 2)).astype(np.float32),
                        device=resolve_device(device))

    def fn(xb):
        return rx_multichannel_block(xb, spec)

    return fn, (x,)


def dryrun_multichip(n_workers: int, device=None) -> dict:
    """The dry run above on ``n_workers`` workers, round-robin over
    ``device`` (default every visible CUDA device; without one this
    raises).  Returns a summary dict; prints one line."""
    from amps_tpu_torch.eval.traffic import (MobileEvent,
                                             synthesize_reverse_band)
    from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from amps_tpu_torch.parallel.pipeline import (
        MultichannelSpec, full_demod_halo, make_sharded_bs_stream_step,
        make_sharded_closed_loop_stream, sharded_state_from_arrays,
        sharded_stream_state)
    from amps_tpu_torch.rx import correlator
    from amps_tpu_torch.tx.focc import superframe_word_pairs

    # squarest (time, chan) factorization
    chan = next(c for c in range(int(np.sqrt(n_workers)), 0, -1)
                if n_workers % c == 0)
    tsize = n_workers // chan
    mesh = make_mesh(MeshSpec(time=tsize, chan=chan),
                     None if device is None else [device])
    dev = mesh.device
    M = 32
    while M % chan:
        M += chan - M % chan
    spec = MultichannelSpec(num_channels=M, taps_per_phase=8)
    sps, P = spec.chan_sps, M // 2
    halo = full_demod_halo(spec)
    row_hops = 12480
    while row_hops % chan:
        row_hops += 1
    block_hops = tsize * row_hops
    nblocks = 3
    events = [MobileEvent("origination", 1, 700, "5551234567", "7025551000",
                          esn=777),
              MobileEvent("page_response", 3, block_hops - 4000,
                          "4155559876"),
              MobileEvent("registration", 5, 2 * block_hops + 3000,
                          "2125550000", esn=5)]
    if tsize > 1:
        events.append(MobileEvent("registration", 2, row_hops - 5000,
                                  "9165554321", esn=42))
    x = synthesize_reverse_band(events, spec, nblocks * block_hops,
                                noise_sigma=0.001, device=dev)

    # the TX hop stream must divide by the worker ring (no padding)
    frames = n_workers // gcd(463 * 2 * sps, n_workers)
    frames *= max(1, 2 // frames)
    pairs = superframe_word_pairs()[:frames]
    word_pairs = torch.as_tensor(
        np.broadcast_to(pairs, (M,) + pairs.shape).copy(), device=dev)
    sup_slots = (1, M - 1)
    step = make_sharded_bs_stream_step(mesh, spec, halo, max_bursts=2,
                                       threshold=0.55, rx_external=True,
                                       supervision_slots=sup_slots)
    state = sharded_stream_state(spec, halo, dev)
    found = {}
    restored = False
    for b in range(nblocks):
        if b == 1:
            # the whole state through the host and an .npz: the
            # block-boundary burst's head lives in this carry
            snap = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                        else np.int32(v)) for k, v in state.items()}
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "dryrun_state.npz")
                np.savez(path, **snap)
                with np.load(path) as z:
                    state = sharded_state_from_arrays(z, dev)
            restored = True
        xb = x[b * block_hops * P:(b + 1) * block_hops * P]
        out, state = step(word_pairs, state, xb)
        tx = out["tx_wideband"]
        _check(bool(torch.isfinite(tx).all()), "TX wideband not finite")
        _check(float(tx.abs().max()) > 0.01, "TX synthesis produced silence")
        sup = out["sup_demod"]
        _check(tuple(sup.shape) == (tsize, len(sup_slots),
                                    block_hops // tsize),
               f"supervision tap of shape {tuple(sup.shape)}")
        _check(bool(torch.isfinite(sup).all()), "supervision tap not finite")
        o = {k: out[k].cpu().numpy()
             for k in ("valid", "starts", "quality", "words", "word_ok")}
        for r in range(tsize):
            for c in range(M):
                for k in range(o["starts"].shape[2]):
                    if not o["valid"][r, c, k]:
                        continue
                    a = ((b * tsize + r) * row_hops - halo
                         + int(o["starts"][r, c, k]))
                    # a burst found again in an overlapping window
                    if any(ch == c and abs(a - pos) <
                           correlator.CAPTURE_SYMBOLS * sps // 2
                           for ch, pos in found):
                        continue
                    found[(c, a)] = (float(o["quality"][r, c, k]),
                                     o["words"][r, c, k],
                                     o["word_ok"][r, c, k])
    _check(restored, "no restore")
    _check(len(found) == len(events), (sorted(found), events))
    for ev in events:
        hits = [(a, v) for (c, a), v in found.items() if c == ev.channel]
        _check(len(hits) == 1, (ev.channel, hits))
        _, (q, words, ok) = hits[0]
        want = np.stack(ev.words())
        _check(q >= 0.55, (ev.channel, q))
        _check(bool(ok[: len(want)].all()), (ev.channel, ok))
        _check(np.array_equal(words[: len(want)], want), ev.channel)
    # the boundary bursts really spanned their boundaries
    for ev, boundary in [(events[1], block_hops)] + (
            [(events[3], row_hops)] if tsize > 1 else []):
        a = next(a for (c, a) in found if c == ev.channel)
        _check(a < boundary < a + correlator.CAPTURE_SYMBOLS * sps,
               (ev.channel, a, boundary))

    # the closed loop decodes a burst across its block boundary
    cl_frames = frames
    while (cl_frames * 463 * 2 * sps) % n_workers:
        cl_frames += frames
    cl_nblocks, cl_row = 2, 10560
    while cl_row % chan:
        cl_row += 1
    cl_block = tsize * cl_row
    cl_events = [MobileEvent("origination", 4, cl_block - 5000, "5551234567",
                             "7025551000", esn=77)]
    x_cl = synthesize_reverse_band(cl_events, spec, cl_nblocks * cl_block,
                                   noise_sigma=0.001, device=dev)
    cl_pairs = np.broadcast_to(superframe_word_pairs()[:cl_frames],
                               (M, cl_frames, 2, 28)).copy()
    run, _ = make_sharded_closed_loop_stream(
        mesh, spec, cl_nblocks, frames=cl_frames, max_bursts=2,
        threshold=0.55, demod_halo=halo, rx_external=True)
    n_valid, q_max, n_ok = (v.cpu().numpy() for v in run(
        cl_pairs, x_cl.reshape(cl_nblocks, cl_block * P, 2)))
    want_words = len(cl_events[0].words())
    _check(int(n_valid.sum()) >= 1, n_valid)
    _check(int(n_ok.sum()) >= want_words, (n_ok, want_words))
    _check(float(q_max.max()) >= 0.55, q_max)
    summary = {"mesh": (tsize, chan), "M": M, "halo": halo,
               "blocks": nblocks, "block_hops": block_hops,
               "bursts": len(found),
               "min_quality": min(v[0] for v in found.values()),
               "loop_bursts": int(n_valid.sum()),
               "loop_words_ok": int(n_ok.sum()),
               "devices": sorted({str(d) for d in mesh.devices})}
    print(f"dryrun_multichip ok: mesh=({tsize}x{chan}) on "
          f"{summary['devices']} M={M} T=8 halo={halo} blocks={nblocks}x"
          f"{block_hops} hops; {len(found)} planted bursts decoded bit-exact "
          f"(row/block-boundary spanning included) with a mid-stream "
          f"checkpoint/restore at the block-1 boundary; min quality="
          f"{summary['min_quality']:.3f}; closed loop: "
          f"{summary['loop_bursts']} burst(s), {summary['loop_words_ok']} "
          f"words ok across {cl_nblocks} blocks")
    return summary
