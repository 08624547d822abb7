"""Multi-process meshes over ``torch.distributed``, the PyTorch port of
``amps_tpu.parallel.distributed``.

Topology as in the JAX package's global mesh: ``time`` spans the
processes (each owns whole time rows, a contiguous time range) and
``chan`` spans the workers of one process.  Only the collectives that
run along ``time`` cross a process boundary: the halo to the next row
(point-to-point to the neighbour), the sum over the ring (``all_reduce``
after the in-process sum) and the carried tail of the last worker
(``broadcast`` from the last process).  The backend is gloo on the CPU
and NCCL where each process owns its own cards; NCCL takes one rank a
card, so workers sharing a card stay in one process.

Nothing tells a program of its cluster: ``initialize`` takes the
coordinator's address, the process count and this process's index, or
reads them from ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
``PROCESS_ID``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.parallel.mesh import Mesh, MeshSpec, visible_cuda_devices


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """``init_process_group`` over ``tcp://coordinator_address`` (host:port;
    a ``tcp://`` prefix is kept) with ``num_processes`` ranks, this one
    ``process_id``; each None is read from the environment variable of
    the JAX package.  The backend is NCCL when CUDA is available, else
    gloo."""
    addr = coordinator_address or os.environ["COORDINATOR_ADDRESS"]
    n = int(num_processes if num_processes is not None
            else os.environ["NUM_PROCESSES"])
    pid = int(process_id if process_id is not None
              else os.environ["PROCESS_ID"])
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                            init_method=addr, world_size=n, rank=pid)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def global_mesh(spec: Optional[MeshSpec] = None, devices=None) -> Mesh:
    """The ``(time, chan)`` mesh over every process of the job.

    ``devices``: this process's workers in ring order (a device may
    repeat), by default its visible CUDA devices.  Default spec: one
    time row a process, ``chan`` = the workers of a process."""
    devices = [resolve_device(d)
               for d in (visible_cuda_devices() if devices is None
                         else devices)]
    n_proc = process_count()
    if spec is None:
        spec = MeshSpec(time=n_proc, chan=len(devices))
    if spec.size != n_proc * len(devices):
        raise ValueError(f"{spec} needs {spec.size} workers, the job has "
                         f"{n_proc} x {len(devices)}")
    return Mesh(spec, devices, process_index(), n_proc)


# -- the cross-process legs of parallel.halo --------------------------------

def exchange(sends: List[tuple], recvs: List[tuple]) -> None:
    """Point-to-point: ``sends`` (tensor, process, tag) go out and
    ``recvs`` (buffer, process, tag) are filled, in one batch."""
    ops = ([dist.P2POp(dist.irecv, t, p, tag=g) for t, p, g in recvs]
           + [dist.P2POp(dist.isend, t.contiguous(), p, tag=g)
              for t, p, g in sends])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every process, in place."""
    dist.all_reduce(t)
    return t


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` of process ``src`` on every process, in place."""
    dist.broadcast(t, src)
    return t
