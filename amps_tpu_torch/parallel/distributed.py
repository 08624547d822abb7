"""Multi-process meshes over ``torch.distributed``, the PyTorch port of
``amps_tpu.parallel.distributed``.

Topology as in the JAX package's global mesh: ``time`` spans the
processes (each owns whole time rows, a contiguous time range) and
``chan`` spans the workers of one process.  Only the collectives that
run along ``time`` cross a process boundary: the halo to the next row
(point-to-point to the neighbour), the sum over the ring (``all_reduce``
after the in-process sum) and the carried tail of the last worker
(``broadcast`` from the last process).

The backend is NCCL where every process has a card of its own, and gloo
otherwise: on the CPU, and where processes share a card (NCCL refuses
two ranks on one card).  ``initialize`` decides from each process's card
UUID, gathered over the job's store before the group starts.  Under
gloo a CUDA tensor crosses through a pinned host copy in both
directions.

Nothing tells a program of its cluster: ``initialize`` takes the
coordinator's address, the process count and this process's index, or
reads them from ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
``PROCESS_ID``.  Process 0 serves the job's store; given port 0 it binds
a free one and prints it (``COORDINATOR_LINE``) before it waits for the
others, and ``launch`` starts a job that way.  ``shutdown``, registered
at exit by ``initialize``, ends the job as ``jax.distributed.shutdown``
does: no process leaves while another still needs it.
"""

from __future__ import annotations

import atexit
import datetime
import os
import re
import select
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

import torch
import torch.distributed as dist

from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.parallel.mesh import Mesh, MeshSpec, visible_cuda_devices

BACKENDS = ("nccl", "gloo")
STORE_TIMEOUT_S = 300
# process 0's line, given port 0, naming the address it bound
COORDINATOR_LINE = "COORDINATOR_ADDRESS="
_KEY = "amps_tpu_torch/"
_job = None     # (store, process count, process index) until shutdown


def choose_backend(cards: Sequence[Optional[str]],
                   backend: Optional[str] = None) -> str:
    """The backend of a job whose ranks hold ``cards`` (each rank's card
    UUID, None for a rank without one).  None picks NCCL when every rank
    has a card no other rank holds, else gloo.  ``backend`` asked for
    explicitly is checked: NCCL with a rank on the CPU, or with two ranks
    on one card, raises ``ValueError``."""
    holders = {}
    for rank, card in enumerate(cards):
        if card is not None:
            holders.setdefault(card, []).append(rank)
    shared = {c: r for c, r in holders.items() if len(r) > 1}
    bare = [rank for rank, card in enumerate(cards) if card is None]
    if backend is None:
        return "gloo" if bare or shared or not cards else "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        if bare:
            raise ValueError(f"NCCL needs a CUDA card in every process: "
                             f"ranks {bare} have none")
        if shared:
            card, ranks = next(iter(shared.items()))
            raise ValueError(f"NCCL takes one process a card: ranks {ranks} "
                             f"share card {card}")
    return backend


def _card() -> str:
    """This process's current CUDA card as its UUID, "" without one."""
    if not torch.cuda.is_available():
        return ""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return f"{props.name} {props.uuid}"


def _rendezvous(store, name: str, n: int, pid: int) -> None:
    """Every one of the ``n`` ranks checks in under ``name`` and waits
    until all have.  Process 0, the store's server, returns last: only
    after every other rank has seen all check in and has checked out, so
    it never takes the store away from a rank that still waits on it."""
    store.set(f"{_KEY}{name}/in/{pid}", b"1")
    store.wait([f"{_KEY}{name}/in/{r}" for r in range(n)])
    if pid:
        store.set(f"{_KEY}{name}/out/{pid}", b"1")
    else:
        store.wait([f"{_KEY}{name}/out/{r}" for r in range(1, n)])


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """``init_process_group`` over a TCP store at ``coordinator_address``
    (host:port, a ``tcp://`` prefix allowed; process 0 serves it) with
    ``num_processes`` ranks, this one ``process_id``; each None is read
    from the environment variable of the JAX package.  Port 0 is for
    process 0 alone: it binds a free port and prints
    ``COORDINATOR_LINE`` + host:port before it waits for the others.
    ``backend``: see ``choose_backend``; the processes' cards are
    gathered over the store first and every rank checks in before any
    chooses, so all make the same choice, or all raise.  Registers
    ``shutdown`` at exit."""
    global _job
    addr = coordinator_address or os.environ["COORDINATOR_ADDRESS"]
    n = int(num_processes if num_processes is not None
            else os.environ["NUM_PROCESSES"])
    pid = int(process_id if process_id is not None
              else os.environ["PROCESS_ID"])
    url = urlsplit(addr if "://" in addr else "tcp://" + addr)
    if url.port is None or (url.port == 0 and pid != 0):
        raise ValueError(f"coordinator address {addr!r}: process {pid} "
                         f"needs the port process 0 serves (port 0, a "
                         f"free one, is for process 0 alone)")
    store = dist.TCPStore(url.hostname, url.port, n, is_master=pid == 0,
                          timeout=datetime.timedelta(seconds=STORE_TIMEOUT_S),
                          wait_for_workers=False)
    if url.port == 0:
        print(f"{COORDINATOR_LINE}{url.hostname}:{store.port}", flush=True)
    store.set(f"{_KEY}card/{pid}", _card())
    cards = [store.get(f"{_KEY}card/{r}").decode() or None
             for r in range(n)]
    _rendezvous(store, "initialize", n, pid)
    dist.init_process_group(choose_backend(cards, backend), store=store,
                            world_size=n, rank=pid)
    _job = (store, n, pid)
    atexit.unregister(_at_exit)
    atexit.register(_at_exit)


def shutdown() -> None:
    """End the job, the counterpart of ``jax.distributed.shutdown``: a
    barrier of every process, then ``destroy_process_group``; process 0
    leaves last, its store up until every other rank has checked out.
    Does nothing before ``initialize`` or a second time."""
    global _job
    if _job is None:
        return
    store, n, pid = _job
    _job = None
    dist.barrier()
    dist.destroy_process_group()
    _rendezvous(store, "shutdown", n, pid)


def _at_exit() -> None:
    """``shutdown`` at exit; after an uncaught exception the process
    leaves at once, without a barrier its peers could not meet, and they
    fail on the closed connection."""
    if getattr(sys, "last_exc", None) is None:
        shutdown()
    elif dist.is_initialized():
        dist.destroy_process_group()


def launch(command: Callable[[int, str], List[str]], num_processes: int = 2,
           timeout: float = 180, host: str = "127.0.0.1"
           ) -> List[Tuple[int, str]]:
    """Run one job: ``command(pid, address)`` is the argv of process
    ``pid``, which joins with ``initialize(address, num_processes,
    pid)``.  Process 0 gets port 0, binds a free port and reports it;
    the others start once it has, with that address, so no port number
    passes through a closed probe socket.  Each process has ``timeout``
    seconds of its own (``subprocess.TimeoutExpired`` past it; every
    process is gone on return).  Returns each process's (exit code,
    output with stderr merged), in process order."""
    def start(pid, address):
        return subprocess.Popen(command(pid, address),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)

    procs = [start(0, f"{host}:0")]
    heads = [b""]
    try:
        fd, deadline = procs[0].stdout.fileno(), time.monotonic() + timeout
        while True:
            found = re.search(rf"^{COORDINATOR_LINE}(\S+)\n".encode(),
                              heads[0], re.M)
            if found:
                break
            left = deadline - time.monotonic()
            if left <= 0:
                raise subprocess.TimeoutExpired(procs[0].args, timeout,
                                                heads[0])
            if select.select([fd], [], [], left)[0]:
                chunk = os.read(fd, 65536)
                if not chunk:
                    procs[0].wait()
                    raise RuntimeError(
                        f"process 0 exited {procs[0].returncode} before it "
                        f"reported the job's address:\n"
                        f"{heads[0].decode(errors='replace')[-3000:]}")
                heads[0] += chunk
        address = found.group(1).decode()
        for pid in range(1, num_processes):
            procs.append(start(pid, address))
            heads.append(b"")
        outs = [head + p.communicate(timeout=timeout)[0]
                for head, p in zip(heads, procs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out.decode(errors="replace"))
            for p, out in zip(procs, outs)]


def backend() -> Optional[str]:
    """The backend of the job's process group (None before
    ``initialize``)."""
    return dist.get_backend() if dist.is_initialized() else None


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

def _staged() -> bool:
    """Whether CUDA tensors cross through the host: gloo takes CPU
    tensors."""
    return dist.get_backend() == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t``, complete on return
    (the copy is queued on the current stream, which is then waited
    for)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


def exchange(sends: List[tuple], recvs: List[tuple]) -> None:
    """Point-to-point: ``sends`` (tensor, process, tag) go out and
    ``recvs`` (buffer, process, tag) are filled, in one batch, the
    receives posted first.  Under gloo a CUDA tensor is sent from a
    pinned host copy and received into one, then copied into its
    buffer."""
    if not sends and not recvs:
        return
    stage = _staged()
    ops, landed = [], []
    for buf, p, g in recvs:
        if stage and buf.is_cuda:
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            landed.append((buf, host))
            buf = host
        ops.append(dist.P2POp(dist.irecv, buf, p, tag=g))
    for t, p, g in sends:
        t = t.contiguous()
        if stage and t.is_cuda:
            t = _to_host(t)
        ops.append(dist.P2POp(dist.isend, t, p, tag=g))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for buf, host in landed:
        buf.copy_(host)


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over every process, in place (under gloo a CUDA
    tensor is summed in a pinned host copy)."""
    if _staged() and t.is_cuda:
        host = _to_host(t)
        dist.all_reduce(host)
        return t.copy_(host)
    dist.all_reduce(t)
    return t


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """``t`` of process ``src`` on every process, in place (under gloo a
    CUDA tensor goes through a pinned host copy)."""
    if _staged() and t.is_cuda:
        host = (_to_host(t) if dist.get_rank() == src else
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
        dist.broadcast(host, src)
        return t.copy_(host)
    dist.broadcast(t, src)
    return t
