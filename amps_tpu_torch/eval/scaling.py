"""Weak-scaling harness of the sharded station, the PyTorch port of
``amps_tpu.eval.scaling``: samples/s of the full sharded TX -> RX step
(``parallel.pipeline.make_sharded_bs_step``) against the mesh size, with
the workload (superframes) growing with the size.

Workers that share one card measure no multi-card scaling: they run one
after another on the same card, so the card's total rate stays about
flat and the "efficiency" falls as 1/size.  On a shared card the harness
only shows that the sharded step runs at every size; scaling needs one
card a worker.  Each result says how many distinct devices its workers
had.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from amps_tpu_torch.parallel.pipeline import (MultichannelSpec,
                                              make_sharded_bs_step)
from amps_tpu_torch.tx.focc import superframe_word_pairs


def weak_scaling(sizes: Optional[Sequence[int]] = None,
                 spec: Optional[MultichannelSpec] = None,
                 frames_per_device: int = 2, iters: int = 3,
                 devices=None) -> Dict[int, dict]:
    """The sharded full step on time meshes of ``sizes`` workers (default
    1, 2, 4), ``frames_per_device`` FOCC frames a worker.  ``devices``:
    those of ``parallel.mesh.make_mesh`` (default every visible CUDA
    device, the workers round-robin over them; ["cpu"] on the CPU).
    Timed with CUDA events on a card, the host clock on the CPU.
    Returns {size: {workers, devices, wideband_samples, samples_per_sec,
    per_worker, efficiency}}."""
    sizes = list(sizes or (1, 2, 4))
    spec = spec or MultichannelSpec(num_channels=8, taps_per_phase=4)
    pairs = superframe_word_pairs()[:2]
    out: Dict[int, dict] = {}
    for size in sizes:
        mesh = make_mesh(MeshSpec(time=size, chan=1), devices)
        dev = mesh.device
        frames = frames_per_device * size
        while (frames * 463 * 2 * spec.chan_sps) % size:
            frames += 1
        n_hops = frames * 463 * 2 * spec.chan_sps
        word_pairs = torch.as_tensor(np.broadcast_to(
            np.tile(pairs, (-(-frames // 2), 1, 1))[:frames],
            (spec.num_channels, frames, 2, 28)).copy(), device=dev)
        step = make_sharded_bs_step(mesh, spec, demod_halo=32, max_bursts=1)
        res = step(word_pairs)                           # warm-up
        float(res[2].float().sum())
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                res = step(word_pairs)
            b.record()
            torch.cuda.synchronize(dev)
            dt = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                res = step(word_pairs)
            float(res[2].float().sum())
            dt = time.perf_counter() - t0
        wideband = n_hops * (spec.num_channels // 2)
        total = wideband * iters / dt
        out[size] = {"workers": size, "devices": len(set(mesh.devices)),
                     "wideband_samples": wideband, "samples_per_sec": total,
                     "per_worker": total / size}
    base = out[min(out)]["per_worker"]
    for size in out:
        out[size]["efficiency"] = out[size]["per_worker"] / base
    return out
