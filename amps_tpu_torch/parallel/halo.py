"""Collectives between the workers of a ``parallel.mesh.Mesh``, the
PyTorch port of ``amps_tpu.parallel.halo`` with the collectives of the
JAX package's sharded steps (``lax.all_to_all``, ``lax.all_gather``,
``lax.psum``).

A sharded value is a list with one tensor per worker of this process,
in ring order (``Mesh.worker``).  Each collective returns such a list,
every tensor on its worker's device.  The semantics are JAX's exactly:
along an axis, shard 0 receives zeros or the carry, and the last
worker's tail is dropped (the caller keeps it as the next block's
carry).  ``axis_name`` (``axis`` for the in-row collectives) is
``"time"``, ``"chan"`` or the flattened ring ``("time", "chan")``
(row-major: w = t * chan + c).

Within a process a collective is a copy to the receiving worker's device
(none when the two share one).  Across processes only ``time`` moves
data, through ``parallel.distributed``: the halo as point-to-point to
the neighbour, ``psum`` as the in-process sum then ``all_reduce``, and
``from_last`` as a ``broadcast`` from the last process.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from amps_tpu_torch.parallel import distributed
from amps_tpu_torch.parallel.mesh import Mesh

RING = ("time", "chan")
Parts = List[torch.Tensor]


def _axis(axis) -> tuple:
    a = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    if a not in (("time",), ("chan",), RING):
        raise ValueError(f"axis must be 'time', 'chan' or {RING}, got {axis}")
    return a


def _neighbour(mesh: Mesh, axis: tuple, w: int, step: int) -> Optional[int]:
    """Ring index of worker w's neighbour ``step`` (-1 left, +1 right)
    along ``axis``, or None past the axis' end."""
    T, C = mesh.spec.time, mesh.spec.chan
    t, c = divmod(w, C)
    if axis == RING:
        v = w + step
        return v if 0 <= v < T * C else None
    if axis == ("time",):
        return (t + step) * C + c if 0 <= t + step < T else None
    return t * C + c + step if 0 <= c + step < C else None


def _shift_right(mesh: Mesh, axis, parts: Parts) -> List[Optional[torch.Tensor]]:
    """Each worker's tensor from its left neighbour along ``axis`` (None
    for shard 0), on the receiver's device."""
    axis = _axis(axis)
    recv: List[Optional[torch.Tensor]] = [None] * len(parts)
    sends, recvs = [], []
    for i, p in enumerate(parts):
        w = mesh.worker(i)[0]
        left = _neighbour(mesh, axis, w, -1)
        if left is not None:
            j = mesh.local(left)
            if j is not None:
                recv[i] = parts[j].to(mesh.devices[i])
            else:
                recv[i] = torch.empty(p.shape, dtype=p.dtype,
                                      device=p.device)
                recvs.append((recv[i], mesh.process_of(left), w))
        right = _neighbour(mesh, axis, w, 1)
        if right is not None and mesh.local(right) is None:
            sends.append((p, mesh.process_of(right), right))
    distributed.exchange(sends, recvs)
    return recv


def _per_worker(mesh: Mesh, value, i: int, like: torch.Tensor):
    """Worker i's share of ``value``: a tensor for every worker or a list
    of one per worker; cast and moved to the worker."""
    v = value[i] if isinstance(value, (list, tuple)) else value
    return v.to(device=mesh.devices[i], dtype=like.dtype)


def _tail(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    return x.narrow(dim, x.shape[dim] - n, n)


def halo_exchange_left(mesh: Mesh, x: Parts, n: int, axis_name,
                       sample_axis: int = 0) -> Parts:
    """Prepend each shard of ``x`` with the last ``n`` samples of its
    left neighbour along ``axis_name``; shard 0 gets zeros (cold stream
    start)."""
    tails = [_tail(p, n, sample_axis) for p in x]
    recv = _shift_right(mesh, axis_name, tails)
    return [torch.cat([torch.zeros_like(t) if r is None else r, p],
                      dim=sample_axis)
            for p, t, r in zip(x, tails, recv)]


def halo_exchange_left_carry(mesh: Mesh, x: Parts, n: int, axis_name,
                             carry: Union[torch.Tensor, Sequence],
                             sample_axis: int = 0) -> Parts:
    """Streaming halo: as ``halo_exchange_left``, but shard 0 of each
    group gets ``carry`` (the previous block's tail; one tensor for every
    worker, or a list of one per worker) instead of zeros, so successive
    blocks form one continuous stream."""
    tails = [_tail(p, n, sample_axis) for p in x]
    recv = _shift_right(mesh, axis_name, tails)
    return [torch.cat([_per_worker(mesh, carry, i, p) if r is None else r, p],
                      dim=sample_axis)
            for i, (p, r) in enumerate(zip(x, recv))]


def _add_head(x: torch.Tensor, head: torch.Tensor, dim: int) -> torch.Tensor:
    n = head.shape[dim]
    return torch.cat([x.narrow(dim, 0, n) + head,
                      x.narrow(dim, n, x.shape[dim] - n)], dim=dim)


def overlap_add_with_carry(mesh: Mesh, x: Parts, tail: Parts, axis_name,
                           carry: Union[torch.Tensor, Sequence],
                           sample_axis: int = 0) -> Parts:
    """Streaming overlap-add: each shard's ``tail`` is added onto the
    head of its right neighbour's block of ``x``; shard 0 adds ``carry``
    (the previous block's last tail).  The last shard's tail is dropped:
    the caller keeps it as the next block's carry."""
    recv = _shift_right(mesh, axis_name, tail)
    return [_add_head(p, _per_worker(mesh, carry, i, p) if r is None else r,
                      sample_axis)
            for i, (p, r) in enumerate(zip(x, recv))]


def add_tail_to_right(mesh: Mesh, x: Parts, tail: Parts, axis_name,
                      sample_axis: int = 0) -> Parts:
    """Overlap-add across shards: each shard's ``tail`` is added onto the
    head of its right neighbour's block of ``x``; shard 0 receives
    nothing and the last shard's tail is dropped (the stream ends
    there)."""
    recv = _shift_right(mesh, axis_name, tail)
    return [p if r is None else _add_head(p, r, sample_axis)
            for p, r in zip(x, recv)]


def _row_start(mesh: Mesh, i: int) -> int:
    return i - mesh.worker(i)[2]


def all_to_all(mesh: Mesh, parts: Parts, axis="chan", split_axis: int = 0,
               concat_axis: int = 0) -> Parts:
    """Tiled all_to_all within each time row: rank c keeps the c-th of
    the ``chan`` equal pieces of every rank's tensor along
    ``split_axis``, joined along ``concat_axis`` in source-rank order."""
    if _axis(axis) != ("chan",):
        raise ValueError("all_to_all runs within a time row: axis 'chan'")
    C = mesh.spec.chan
    out = []
    for i in range(len(parts)):
        c, r0 = mesh.worker(i)[2], _row_start(mesh, i)
        if parts[r0].shape[split_axis] % C:
            raise ValueError(f"axis {split_axis} of {tuple(parts[r0].shape)} "
                             f"does not split into {C} ranks")
        out.append(torch.cat(
            [parts[r0 + s].chunk(C, dim=split_axis)[c].to(mesh.devices[i])
             for s in range(C)], dim=concat_axis))
    return out


def all_gather(mesh: Mesh, parts: Parts, axis="chan", dim: int = 0) -> Parts:
    """Tiled all_gather within each time row: every rank gets the row's
    tensors joined along ``dim`` in rank order."""
    if _axis(axis) != ("chan",):
        raise ValueError("all_gather runs within a time row: axis 'chan'")
    C = mesh.spec.chan
    out = []
    for i in range(len(parts)):
        r0 = _row_start(mesh, i)
        out.append(torch.cat([parts[r0 + s].to(mesh.devices[i])
                              for s in range(C)], dim=dim))
    return out


def psum(mesh: Mesh, parts: Parts, axis) -> Parts:
    """The sum over ``axis`` of the workers' tensors, on every worker."""
    axis = _axis(axis)
    C, n = mesh.spec.chan, len(parts)
    if axis == ("chan",):
        sums = {}
        for i in range(n):
            r0 = _row_start(mesh, i)
            if r0 not in sums:
                dev = mesh.devices[r0]
                sums[r0] = sum(parts[r0 + s].to(dev) for s in range(C))
        return [sums[_row_start(mesh, i)].to(mesh.devices[i])
                for i in range(n)]
    dev = mesh.device
    if axis == RING:
        total = sum(p.to(dev) for p in parts)
        if mesh.process_count > 1:
            distributed.all_reduce(total)
        return [total.to(d) for d in mesh.devices]
    # "time": a sum a chan rank, over the rows of every process
    per_c = torch.stack([sum(parts[i].to(dev) for i in range(c, n, C))
                         for c in range(C)])
    if mesh.process_count > 1:
        distributed.all_reduce(per_c)
    return [per_c[mesh.worker(i)[2]].to(mesh.devices[i]) for i in range(n)]


def from_last(mesh: Mesh, parts: Parts, dim: Optional[int] = None
              ) -> torch.Tensor:
    """The last ring worker's tensor (``dim`` None), or the last time
    row's tensors joined along ``dim`` in rank order, on ``mesh.device``
    of every process: where a block's carried state comes from."""
    C = mesh.spec.chan
    src = parts[-1:] if dim is None else parts[-C:]
    last = mesh.process_count - 1
    if mesh.process_index == last:
        val = (src[0].to(mesh.device) if dim is None else
               torch.cat([p.to(mesh.device) for p in src], dim=dim))
    else:
        shape = list(src[0].shape)
        if dim is not None:
            shape[dim] = sum(p.shape[dim] for p in src)
        val = torch.empty(shape, dtype=src[0].dtype, device=mesh.device)
    if mesh.process_count > 1:
        val = distributed.broadcast(val.contiguous(), last)
    return val
