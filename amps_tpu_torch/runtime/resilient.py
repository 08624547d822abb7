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
* Supervision frames are delivered exactly once too: a replay delivers
  only the frames of the block whose push failed (the earlier blocks'
  frames went out before the failure, and a second delivery would advance
  the SAT/ST timers twice), and an exception of the ``on_supervision``
  callback is held back until the push has finished, then raised with
  the block's burst reports attached as ``burst_reports``.

Only a receiver error that persists through ``max_retries`` rebuilds is
re-raised.
"""

from __future__ import annotations

import contextlib
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

    @contextlib.contextmanager
    def _sup_guard(self, cb_errors: List[Exception]):
        """Run the current receiver with its ``on_supervision`` wrapped:
        an exception of the user's callback is recorded in ``cb_errors``
        instead of leaving ``rx.push``, where it would pass for a device
        failure and trigger a rebuild and a replay that delivers the
        block's frames again."""
        rx = self.rx
        cb = rx.on_supervision
        if cb is None:
            yield
            return

        def guarded(*a, **kw):
            try:
                cb(*a, **kw)
            except Exception as e:  # noqa: BLE001 -- the user's callback
                cb_errors.append(e)

        rx.on_supervision = guarded
        try:
            yield
        finally:
            # on the receiver that ran under the guard: self.rx may be a
            # rebuilt one by now
            if rx.on_supervision is guarded:
                rx.on_supervision = cb

    def _recover_and_replay_raw(self, cb_errors: List[Exception]
                                ) -> List[BurstReport]:
        """Fresh receiver + snapshot restore + ring replay (raw reports;
        dedup happens at delivery).  Supervision frames are delivered for
        the last replayed block only, the one whose push failed, under
        the callback guard."""
        self.recoveries += 1
        self.rx = self._make()
        restore_receiver(self._snap, self.rx)
        raw: List[BurstReport] = []
        saved_cb = self.rx.on_supervision
        try:
            with self._sup_guard(cb_errors):
                guarded_cb = self.rx.on_supervision
                for i, blk in enumerate(self._ring):
                    if saved_cb is not None:
                        self.rx.on_supervision = (
                            guarded_cb if i == len(self._ring) - 1 else None)
                    raw += self.rx.push(blk)   # copied to its device
        finally:
            # a failed replay must not leave the rebuilt receiver mute
            if saved_cb is not None:
                self.rx.on_supervision = saved_cb
        return raw

    def push(self, block) -> List[BurstReport]:
        # the ring keeps a host copy, which survives a lost device; the
        # block itself goes to the receiver where it lies
        if isinstance(block, torch.Tensor):
            self._ring.append(block.detach().cpu())
        else:
            block = np.asarray(block)
            self._ring.append(block)
        cb_errors: List[Exception] = []
        for attempt in range(self.max_retries + 1):
            cb_errors.clear()   # a retried attempt delivers the frames anew
            try:
                if attempt == 0:
                    with self._sup_guard(cb_errors):
                        raw = self.rx.push(block)
                else:
                    raw = self._recover_and_replay_raw(cb_errors)
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
        if cb_errors:
            # the push itself succeeded (state advanced, reports
            # delivered and marked): surface the callback's error with
            # the block's reports attached, or a caller that only catches
            # it would lose them to the positional dedup
            err = cb_errors[0]
            try:
                err.burst_reports = out
            except AttributeError:
                pass    # an exception class with __slots__
            raise err
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
