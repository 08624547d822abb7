"""Failure detection and recovery for the streaming receiver, the
PyTorch port of ``amps_tpu.runtime.resilient``.

* Every ``checkpoint_blocks`` pushes, the receiver's carried state is
  snapshotted on the host (runtime/state.py) and the replay ring
  dropped.
* If the receiver's push raises (a device lost or wedged, a failed
  launch), a FRESH receiver is built by the factory, the snapshot is
  restored, the retained blocks are replayed, and the stream continues
  identical to an uninterrupted one.
* Burst reports are delivered exactly once across replays, deduplicated
  by (channel, absolute symbol); a callback exception propagates to the
  caller and never triggers a rebuild.

Only a receiver error that persists through ``max_retries`` rebuilds is
re-raised.  Supervision callbacks need the voice receive path, which is
not ported yet, so there is none to guard.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from amps_tpu_torch.runtime.state import restore_receiver, snapshot_receiver
from amps_tpu_torch.runtime.streamer import BurstReport


class ResilientReceiver:
    """Elastic wrapper: ``make_receiver`` is a zero-argument factory
    returning a fresh MultichannelReceiver at pipeline_depth=1 and
    WITHOUT an on_burst callback; reports flow through this wrapper's
    return values and ``on_burst`` so that replay dedup applies."""

    def __init__(self, make_receiver: Callable[[], object],
                 checkpoint_blocks: int = 4, max_retries: int = 2,
                 on_burst: Optional[Callable[[BurstReport], None]] = None):
        self._make = make_receiver
        self.rx = make_receiver()
        if self.rx.depth != 1:
            raise ValueError("ResilientReceiver requires pipeline_depth=1")
        if self.rx.on_burst is not None:
            raise ValueError("configure on_burst on ResilientReceiver, not "
                             "on the factory's receiver")
        self.checkpoint_blocks = max(1, checkpoint_blocks)
        self.max_retries = max_retries
        self.on_burst = on_burst
        self._snap = snapshot_receiver(self.rx)
        self._ring: List = []
        self._delivered = set()          # (channel, abs_symbol)
        self.recoveries = 0

    def _deliver(self, reports) -> List[BurstReport]:
        out = []
        for r in reports:
            key = (r.channel, r.abs_symbol)
            if key in self._delivered:
                continue
            self._delivered.add(key)
            out.append(r)
            if self.on_burst:
                self.on_burst(r)
        return out

    def _recover_and_replay_raw(self) -> List[BurstReport]:
        """Fresh receiver + snapshot restore + ring replay (raw reports;
        dedup happens at delivery)."""
        self.recoveries += 1
        self.rx = self._make()
        restore_receiver(self._snap, self.rx)
        raw: List[BurstReport] = []
        for blk in self._ring:
            raw += self.rx.push(blk)       # copied to the receiver's device
        return raw

    def push(self, block) -> List[BurstReport]:
        # the ring keeps a host copy, which survives a lost device; the
        # block itself goes to the receiver where it lies
        if isinstance(block, torch.Tensor):
            self._ring.append(block.detach().cpu())
        else:
            block = np.asarray(block)
            self._ring.append(block)
        for attempt in range(self.max_retries + 1):
            try:
                raw = (self.rx.push(block) if attempt == 0
                       else self._recover_and_replay_raw())
            except Exception:  # noqa: BLE001 -- any receiver failure
                if attempt == self.max_retries:
                    # drop the failed block, so a caller that catches and
                    # re-pushes it does not have it replayed twice
                    self._ring.pop()
                    raise
                continue
            break
        out = self._deliver(raw)
        if len(self._ring) >= self.checkpoint_blocks:
            self._snap = snapshot_receiver(self.rx)
            self._ring.clear()
            # replay can only start at this snapshot now, so older dedup
            # keys can never recur
            floor = int(self._snap["abs_base"]) // self.rx.sps \
                - self._snap["carry"].shape[-1] // self.rx.sps
            self._delivered = {k for k in self._delivered if k[1] >= floor}
        return out

    def flush(self) -> List[BurstReport]:
        """End-of-stream drain with the resilience contract: the burst
        pending in the carried overlap is completed against one block of
        trailing silence, pushed through push() (retry, recovery and
        dedup).  The pad goes whenever a block was pushed, also when the
        stream ended on a checkpoint boundary and the ring is empty (the
        JAX package skips it there and loses that burst)."""
        out = []
        if self.rx._last_block_len:
            out = self.push(np.zeros((self.rx._last_block_len, 2),
                                     np.float32))
        return out + self._deliver(self.rx.flush())
