"""Peak bytes of live tensors of the station app's two device threads,
counted on the CPU at a small bank and scaled to a wide one.

The app (``python -m amps_tpu_torch bs --simulate ...``) runs the
transmitter's superframe (``MultichannelTransmitter.next_block``, one
control channel) on one thread and the receiver's push of the simulated
mobile's 16384-hop block (``MultichannelReceiver.push``, depth 2) on the
other.  This script runs each once on the CPU at ``--channels`` M and
counts the bytes of live tensor storage after every op (a
TorchDispatchMode: a storage counts from the op that makes it until the
last Python tensor on it is gone), reporting each peak in planes of
(M, 16384) float32 and in GB at ``--scale-to``: every plane of both
threads grows with M at a fixed hop count.  The synthesis and the front
end are stand-ins that return zero tensors of their kernels' output
shapes (the card's kernels make no other plane, bar the route's 1 GiB
scratch); the block handed to the push counts.  Run from the repository
root:

    python3 tools/live_planes.py [--channels 512] [--scale-to 32766]
"""

from __future__ import annotations

import argparse
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class LiveBytes(TorchDispatchMode):
    """Live tensor-storage bytes after each op of this thread, and their
    peak."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._refs, self._sizes = {}, {}

    def _drop(self, key):
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st.data_ptr()
            if not key:
                continue
            if key not in self._refs:
                self._refs[key] = 0
                self._sizes[key] = st.nbytes()
                self.live += st.nbytes()
            self._refs[key] += 1
            weakref.finalize(t, self._drop, key)
        self.peak = max(self.peak, self.live)
        return out


def main() -> None:
    from amps_tpu_torch.config import SystemConfig
    from amps_tpu_torch.eval.traffic import (MobileEvent,
                                             synthesize_reverse_band)
    from amps_tpu_torch.parallel.pipeline import MultichannelSpec
    from amps_tpu_torch.runtime.streamer import (MultichannelReceiver,
                                                 MultichannelTransmitter)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=512)
    ap.add_argument("--scale-to", type=int, default=32766)
    args = ap.parse_args()
    M, hops = args.channels, 16384
    spec = MultichannelSpec(num_channels=M)
    plane = M * hops * 4
    scale = args.scale_to / M / 1e9

    def synth(Y, M, T, parity, carry):
        return (torch.zeros((Y.shape[0] * (M // 2), 2)),
                torch.zeros_like(carry))

    def front_end(x_ext, M, T, parity, prev):
        Nh = x_ext.shape[0] // (M // 2) - 2 * T + 1
        return (torch.zeros((M, Nh)), torch.zeros((M, 2)),
                torch.zeros((M, Nh)))

    tx = MultichannelTransmitter(spec, SystemConfig(), control_channels=[1],
                                 device="cpu", synthesize=synth)
    with LiveBytes() as tx_bytes:
        tx.next_block()
    ev = MobileEvent.parse("origination:5551234567:5551230000", channel=3,
                           start_hop=1000)
    block = synthesize_reverse_band([ev], spec, hops, device="cpu")
    rx = MultichannelReceiver(spec, threshold=0.5, pipeline_depth=2,
                              device="cpu", front_end=front_end)
    with LiveBytes() as rx_bytes:
        # the block the app holds through its push counts too: copied
        # inside the count
        rx.push(block.clone())
    for name, b in (("TX superframe", tx_bytes.peak),
                    ("RX push of 16384 hops", rx_bytes.peak)):
        print(f"{name}: peak {b / plane:.2f} planes of (M, {hops}) f32 at "
              f"M={M}, {b * scale:.2f} GB at M={args.scale_to}")


if __name__ == "__main__":
    main()
