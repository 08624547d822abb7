"""The ``(time, chan)`` worker mesh, the PyTorch port of
``amps_tpu.parallel.mesh``.

A ``Mesh`` is a grid of worker slots.  Each slot has a ``torch.device``,
and slots may share one: all four workers of a 2x2 mesh can sit on one
card, as the JAX package's tests run eight workers on one CPU.  One
process drives every worker it owns, one after another, as JAX's single
controller drives its ``shard_map``; the collectives of
``parallel.halo`` move tensors between workers.  Across processes
(``parallel.distributed.global_mesh``) each process owns whole time rows,
so ``chan`` never spans processes.

Worker ``w = t * chan + c`` is the w-th slot of the flattened
``("time", "chan")`` ring, the order the sharded steps cut a wideband
block in.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from amps_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    time: int = 1
    chan: int = 1

    @property
    def size(self) -> int:
        return self.time * self.chan


class Mesh:
    """The ``(time, chan)`` grid of ``spec`` as this process sees it.

    ``devices``: one per worker of this process, in ring order (row by
    row): ``spec.time // process_count`` rows of ``spec.chan`` workers.
    ``process_index`` owns rows ``[row0, row0 + rows)``."""

    def __init__(self, spec: MeshSpec, devices: Sequence[torch.device],
                 process_index: int = 0, process_count: int = 1):
        if spec.time < 1 or spec.chan < 1:
            raise ValueError(f"mesh {spec} has no worker")
        if spec.time % process_count:
            raise ValueError(f"{process_count} processes cannot share the "
                             f"{spec.time} time rows of {spec}")
        self.spec = spec
        self.shape = {"time": spec.time, "chan": spec.chan}
        self.process_index = process_index
        self.process_count = process_count
        self.rows = spec.time // process_count
        self.row0 = process_index * self.rows
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if len(self.devices) != self.rows * spec.chan:
            raise ValueError(f"{len(self.devices)} devices for the "
                             f"{self.rows} x {spec.chan} workers of this "
                             f"process")

    @property
    def size(self) -> int:
        return self.spec.size

    @property
    def device(self) -> torch.device:
        """The first worker's device: where the carried state and the
        assembled outputs of the sharded steps live."""
        return self.devices[0]

    def worker(self, i: int):
        """(w, t, c) of this process's i-th worker: its index on the
        flattened ring, its time row and its chan rank."""
        t = self.row0 + i // self.spec.chan
        c = i % self.spec.chan
        return t * self.spec.chan + c, t, c

    def local(self, w: int) -> Optional[int]:
        """This process's index of ring worker ``w``, or None when
        another process owns it."""
        i = w - self.row0 * self.spec.chan
        return i if 0 <= i < len(self.devices) else None

    def process_of(self, w: int) -> int:
        return (w // self.spec.chan) // self.rows


def visible_cuda_devices() -> List[torch.device]:
    """Every visible CUDA device; without one this raises (the CPU is
    used only when named)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the mesh: name its devices "
                           "(devices=['cpu'] on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(spec: Optional[MeshSpec] = None, devices=None) -> Mesh:
    """A one-process ``(time, chan)`` mesh over the given devices.

    ``devices``: a list of devices, which may repeat one; by default
    every visible CUDA device (without one this raises: the CPU
    is used only when named).  The workers go round-robin over the list,
    so four workers share one card, or spread over four.  With no
    ``spec`` every device is one worker on the time axis (time is the
    axis that always scales: channels are bounded by the band plan)."""
    if devices is None:
        devices = visible_cuda_devices()
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("no device for the mesh")
    if spec is None:
        spec = MeshSpec(time=len(devices), chan=1)
    return Mesh(spec, [devices[w % len(devices)] for w in range(spec.size)])
