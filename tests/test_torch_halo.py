"""The port's mesh collectives (``amps_tpu_torch.parallel.halo``) against
the JAX package's under ``shard_map`` on the virtual 8-device CPU mesh:
the halo exchanges and overlap-adds over ``time``, ``chan`` and the
flattened ``(time, chan)`` ring, and the tiled all_to_all / all_gather
and psum the sharded steps issue.  Every worker's output is held exactly
(the inputs are small integers in float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from amps_tpu.parallel import halo as jhalo
from amps_tpu.parallel.mesh import MeshSpec as JMeshSpec
from amps_tpu.parallel.mesh import make_mesh as jmake_mesh
from amps_tpu_torch.parallel import halo
from amps_tpu_torch.parallel.distributed import global_mesh
from amps_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh

RING = ("time", "chan")
# (time, chan, axis): tsize 2/4/8 on a time mesh, and the 4x2 mesh along
# each axis and the flattened ring
CASES = [(2, 1, "time"), (4, 1, "time"), (8, 1, "time"), (4, 2, RING),
         (4, 2, "time"), (4, 2, "chan"), (2, 4, RING)]
IDS = [f"{t}x{c}-{a if isinstance(a, str) else 'ring'}" for t, c, a in CASES]


def _jax(t, c, f, *args, specs=None):
    """f under shard_map on a (t, c) mesh, every argument and the output
    sharded along the ring on axis 0 unless ``specs`` says otherwise;
    returns the output as one block a worker."""
    mesh = jmake_mesh(JMeshSpec(time=t, chan=c), jax.devices()[:t * c])
    specs = specs or (P(RING),) * len(args)
    out = jax.jit(shard_map(f, mesh=mesh, in_specs=specs,
                            out_specs=P(RING)))(*args)
    return np.split(np.asarray(out), t * c)


def _port(t, c, fn, *args):
    mesh = make_mesh(MeshSpec(time=t, chan=c), ["cpu"])
    parts = [list(torch.as_tensor(a).chunk(t * c)) for a in args]
    return [p.numpy() for p in fn(mesh, *parts)]


def _data(t, c, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-50, 50, (t * c * shape[0],) + shape[1:]).astype(
        np.float32)


def _equal(got, want):
    assert len(got) == len(want)
    for w, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and np.array_equal(a, b), w


@pytest.mark.parametrize("t,c,axis", CASES, ids=IDS)
def test_halo_exchange_left(t, c, axis):
    x = _data(t, c, (6, 3), 1)
    want = _jax(t, c, lambda xl: jhalo.halo_exchange_left(xl, 4, axis, 0), x)
    got = _port(t, c, lambda m, xs: halo.halo_exchange_left(m, xs, 4, axis),
                x)
    _equal(got, want)


@pytest.mark.parametrize("t,c,axis", CASES, ids=IDS)
def test_halo_exchange_left_carry(t, c, axis):
    """A carry of one block a worker: shard 0 of each group takes its
    own (the time-row IQ carry of the sharded step is per chan rank)."""
    x, carry = _data(t, c, (6, 3), 2), _data(t, c, (4, 3), 3)
    want = _jax(t, c, lambda xl, cl: jhalo.halo_exchange_left_carry(
        xl, 4, axis, cl, 0), x, carry)
    got = _port(t, c, lambda m, xs, cs: halo.halo_exchange_left_carry(
        m, xs, 4, axis, cs), x, carry)
    _equal(got, want)


@pytest.mark.parametrize("t,c", [(2, 1), (8, 1), (4, 2)])
def test_halo_exchange_left_carry_replicated(t, c):
    """One carry for every worker (the analyzer history of the ring),
    on the sample axis 1 of planar planes."""
    x = _data(t, c, (2, 7), 4).reshape(-1, 7)
    carry = _data(1, 1, (2, 5), 5)
    want = _jax(t, c, lambda xl, cl: jhalo.halo_exchange_left_carry(
        xl, 5, RING, cl, 1), x, carry, specs=(P(RING), P()))
    mesh = make_mesh(MeshSpec(time=t, chan=c), ["cpu"])
    got = halo.halo_exchange_left_carry(
        mesh, list(torch.as_tensor(x).chunk(t * c)), 5, RING,
        torch.as_tensor(carry), sample_axis=1)
    _equal([g.numpy() for g in got], want)


@pytest.mark.parametrize("t,c,axis", CASES, ids=IDS)
def test_overlap_add_with_carry(t, c, axis):
    x, tails = _data(t, c, (8, 2), 6), _data(t, c, (3, 2), 7)
    carry = _data(1, 1, (3, 2), 8)
    want = _jax(t, c, lambda xl, tl, cl: jhalo.overlap_add_with_carry(
        xl, tl, axis, cl, 0), x, tails, carry,
        specs=(P(RING), P(RING), P()))
    mesh = make_mesh(MeshSpec(time=t, chan=c), ["cpu"])
    got = halo.overlap_add_with_carry(
        mesh, list(torch.as_tensor(x).chunk(t * c)),
        list(torch.as_tensor(tails).chunk(t * c)), axis,
        torch.as_tensor(carry))
    _equal([g.numpy() for g in got], want)


@pytest.mark.parametrize("t,c,axis", CASES, ids=IDS)
def test_add_tail_to_right(t, c, axis):
    x, tails = _data(t, c, (8, 2), 9), _data(t, c, (3, 2), 10)
    want = _jax(t, c, lambda xl, tl: jhalo.add_tail_to_right(xl, tl, axis, 0),
                x, tails)
    got = _port(t, c, lambda m, xs, ts: halo.add_tail_to_right(
        m, xs, ts, axis), x, tails)
    _equal(got, want)


@pytest.mark.parametrize("t,c", [(2, 2), (4, 2), (2, 4), (1, 8)])
def test_all_to_all_within_rows(t, c):
    """The sharded step's reshard: (2, M, n) planes split along the
    channels, joined along the hops in source-rank order."""
    M, n = 8, 5
    x = _data(t, c, (2, M, n), 11).reshape(-1, M, n)
    want = _jax(t, c, lambda xl: lax.all_to_all(
        xl, "chan", split_axis=1, concat_axis=2, tiled=True), x)
    got = _port(t, c, lambda m, xs: halo.all_to_all(
        m, xs, "chan", split_axis=1, concat_axis=2), x)
    _equal(got, want)


@pytest.mark.parametrize("t,c", [(2, 2), (4, 2), (1, 8)])
def test_all_gather_within_rows(t, c):
    x = _data(t, c, (3, 4, 2), 12)
    want = _jax(t, c, lambda xl: lax.all_gather(xl, "chan", axis=0,
                                                tiled=True), x)
    got = _port(t, c, lambda m, xs: halo.all_gather(m, xs, "chan", dim=0), x)
    _equal(got, want)


@pytest.mark.parametrize("t,c,axis", [(4, 2, RING), (4, 2, "time"),
                                      (4, 2, "chan"), (8, 1, "time"),
                                      (2, 4, "chan")])
def test_psum(t, c, axis):
    x = _data(t, c, (5,), 13)
    want = _jax(t, c, lambda xl: lax.psum(xl, axis), x)
    got = _port(t, c, lambda m, xs: halo.psum(m, xs, axis), x)
    _equal(got, want)


def test_from_last_is_the_last_worker_and_row():
    mesh = make_mesh(MeshSpec(time=4, chan=2), ["cpu"])
    parts = [torch.full((2, 3), float(w)) for w in range(8)]
    assert torch.equal(halo.from_last(mesh, parts), parts[7])
    assert torch.equal(halo.from_last(mesh, parts, dim=0),
                       torch.cat(parts[6:]))


def test_collectives_refuse_other_axes():
    mesh = make_mesh(MeshSpec(time=2, chan=2), ["cpu"])
    xs = [torch.zeros(4, 2)] * 4
    with pytest.raises(ValueError, match="within a time row"):
        halo.all_to_all(mesh, xs, "time")
    with pytest.raises(ValueError, match="axis must be"):
        halo.halo_exchange_left(mesh, xs, 1, ("chan", "time"))


def test_make_mesh_places_workers_round_robin():
    mesh = make_mesh(MeshSpec(time=2, chan=2), ["cpu"])
    assert mesh.shape == {"time": 2, "chan": 2} and mesh.size == 4
    assert mesh.devices == [torch.device("cpu")] * 4
    assert [mesh.worker(i) for i in range(4)] == [(0, 0, 0), (1, 0, 1),
                                                  (2, 1, 0), (3, 1, 1)]
    assert make_mesh(devices=["cpu", "cpu", "cpu"]).shape == {"time": 3,
                                                              "chan": 1}
    with pytest.raises(ValueError):
        Mesh(MeshSpec(2, 2), [torch.device("cpu")] * 3)


def test_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(MeshSpec(2, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(MeshSpec(2, 2), ["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        global_mesh()


def test_global_mesh_in_one_process_is_one_row():
    mesh = global_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"time": 1, "chan": 2}
    assert (mesh.process_index, mesh.process_count) == (0, 1)
