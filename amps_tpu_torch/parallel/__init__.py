"""The multichannel pipeline and its sharding over a ``(time, chan)``
worker mesh: ``pipeline`` (the blocks and the sharded steps), ``mesh``,
``halo`` (the collectives), ``distributed`` (across processes) and
``stream`` (the sharded receiver and transceiver)."""

from amps_tpu_torch.parallel.halo import halo_exchange_left  # noqa: F401
from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh  # noqa: F401
