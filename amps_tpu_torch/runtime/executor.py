"""Threaded streaming executor: concurrent TX feed / RX drain / control,
the PyTorch port of ``amps_tpu.runtime.executor``.

The reference leans on GNU Radio's thread-per-block scheduler (one
thread per block, ring buffers between them -- SURVEY.md §1 L3).  Here
the device work is the transmitter's superframe (the synthesis kernel)
and the receiver's push (the front-end kernel, correlator and decoder),
so the useful host concurrency is exactly three threads:

  TX feeder   -- synthesize the next wideband block while the previous
                 one is being written/consumed (kernel launches and
                 waits release the GIL, so host-side framing overlaps
                 device compute);
  RX drainer  -- pull wideband blocks from the source and push them
                 through the streaming receiver;
  control     -- the caller's thread (TCP command server / call control)
                 stays free; burst reports arrive via callbacks.

Both device threads launch on the current stream of the current device
(the legacy default stream unless the caller sets another), so their
kernels run one after another on the card.

Backpressure is a bounded queue (``BlockQueue``), the moral equivalent
of GR's bounded ring buffers: a fast producer blocks instead of
ballooning memory.  Any thread exception is captured and re-raised on
``join()`` -- failures are not swallowed.

Blocks pass through as the very objects the callables return: numpy
arrays or tensors on any device.  Sample counts are read from
``block.shape``, which never copies a device tensor to the host.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, List, Optional


@dataclasses.dataclass
class ExecutorStats:
    tx_blocks: int = 0
    tx_samples: int = 0
    rx_blocks: int = 0
    rx_samples: int = 0
    started_at: float = 0.0
    stopped_at: float = 0.0

    @property
    def wall_s(self) -> float:
        end = self.stopped_at or time.monotonic()
        return max(end - self.started_at, 1e-9)


class BlockQueue:
    """Bounded block FIFO usable as a TX sink and an RX source.

    ``put`` blocks when ``depth`` blocks are in flight (backpressure);
    ``close()`` makes subsequent ``get`` return None (end of stream).
    """

    def __init__(self, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._closed = threading.Event()

    def put(self, block) -> None:
        while not self._closed.is_set():
            try:
                self._q.put(block, timeout=0.1)
                return
            except queue.Full:
                continue

    def get(self):
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._closed.is_set():
                    return None

    def close(self) -> None:
        self._closed.set()


class ThreadedExecutor:
    """Run TX synthesis and RX decode concurrently.

    All four roles are plain callables so any front end (files, rings,
    SDR adapters, simulators, queues) plugs in:

      tx_step()        -> (n, 2) wideband block, or None to finish TX
      tx_sink(block)   -> consume a TX block (may block: backpressure)
      rx_source()      -> (n, 2) wideband block, or None to finish RX
      rx_push(block)   -> feed the streaming receiver

    Omitting the TX pair (or RX pair) runs a receive-only (or
    transmit-only) executor.
    """

    def __init__(self,
                 tx_step: Optional[Callable[[], Any]] = None,
                 tx_sink: Optional[Callable[[Any], None]] = None,
                 rx_source: Optional[Callable[[], Any]] = None,
                 rx_push: Optional[Callable[[Any], None]] = None,
                 max_tx_blocks: Optional[int] = None):
        assert (tx_step is None) == (tx_sink is None)
        assert (rx_source is None) == (rx_push is None)
        self._tx_step, self._tx_sink = tx_step, tx_sink
        self._rx_source, self._rx_push = rx_source, rx_push
        self._max_tx = max_tx_blocks
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        self.stats = ExecutorStats()

    # -- thread bodies -------------------------------------------------------

    def _run_tx(self) -> None:
        try:
            while not self._stop.is_set():
                if (self._max_tx is not None
                        and self.stats.tx_blocks >= self._max_tx):
                    break
                block = self._tx_step()
                if block is None:
                    break
                # the block is handed on as it is: a device-resident
                # block stays on the card unless the sink copies it
                self._tx_sink(block)
                self.stats.tx_blocks += 1
                self.stats.tx_samples += int(block.shape[0])
        except BaseException as e:  # surfaced on join()
            self._errors.append(e)
            self._stop.set()

    def _run_rx(self) -> None:
        try:
            while not self._stop.is_set():
                block = self._rx_source()
                if block is None:
                    break
                self._rx_push(block)
                self.stats.rx_blocks += 1
                # .shape reads metadata only (no device->host copy)
                self.stats.rx_samples += int(block.shape[0])
        except BaseException as e:
            self._errors.append(e)
            self._stop.set()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ThreadedExecutor":
        self.stats.started_at = time.monotonic()
        if self._tx_step is not None:
            t = threading.Thread(target=self._run_tx, name="amps-tx-feeder",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        if self._rx_source is not None:
            t = threading.Thread(target=self._run_rx, name="amps-rx-drainer",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()

    @property
    def alive(self) -> bool:
        return any(t.is_alive() for t in self._threads)

    def join(self, timeout: Optional[float] = None) -> ExecutorStats:
        """Wait for both threads; re-raise the first thread error."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in self._threads:
            t.join(None if deadline is None
                   else max(deadline - time.monotonic(), 0.0))
        self.stats.stopped_at = time.monotonic()
        if self._errors:
            raise self._errors[0]
        if any(t.is_alive() for t in self._threads):
            raise TimeoutError("executor threads still running")
        return self.stats


def chunked_source(x, block_samples: int):
    """Split a prebuilt wideband array or tensor into a streaming
    rx_source (slices are views: no copy)."""
    pos = {"i": 0}

    def source():
        i = pos["i"]
        if i >= len(x):
            return None
        pos["i"] = i + block_samples
        return x[i: i + block_samples]

    return source
