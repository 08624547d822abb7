"""The port's threaded executor (``amps_tpu_torch.runtime.executor``):
concurrent TX/RX with call control end to end at M=8 on the CPU, error
propagation, backpressure, and blocks handed on as the very objects the
callables return (numpy arrays and tensors)."""

import threading

import numpy as np
import pytest
import torch

from amps_tpu_torch.config import SystemConfig
from amps_tpu_torch.control.station import BaseStation
from amps_tpu_torch.eval.traffic import MobileEvent, synthesize_reverse_band
from amps_tpu_torch.parallel.pipeline import MultichannelSpec
from amps_tpu_torch.runtime.executor import (BlockQueue, ThreadedExecutor,
                                             chunked_source)
from amps_tpu_torch.runtime.streamer import (MultichannelReceiver,
                                             MultichannelTransmitter)

torch.set_num_threads(1)

M = 8


def test_threaded_executor_full_station():
    """TX feeder + RX drainer running concurrently; the RX side carries
    an origination and a page response, and the station must handle
    both while the TX side keeps producing superframes."""
    spec = MultichannelSpec(num_channels=M)
    system = SystemConfig()
    station = BaseStation(system, sps=spec.chan_sps)
    tx = MultichannelTransmitter(spec, system, control_channels=[1],
                                 device="cpu")
    station.focc = tx.focc[1]

    reports = []

    def on_burst(rep):
        reports.append(rep)
        station.handle_burst(rep.words, rep.word_ok)

    rx = MultichannelReceiver(spec, on_burst=on_burst, threshold=0.5,
                              device="cpu")

    total_hops = 3 * 16384
    events = [
        MobileEvent("origination", 3, 1500, "5551234567",
                    dialed="16505551234"),
        MobileEvent("page_response", 5, 26000, "7735550000"),
    ]
    band = synthesize_reverse_band(events, spec, total_hops, device="cpu")

    sink = BlockQueue(depth=2)
    consumed = []

    def drain_tx(block):
        sink.put(block)
        consumed.append(sink.get().shape[0])

    ex = ThreadedExecutor(
        tx_step=tx.next_block, tx_sink=drain_tx,
        rx_source=chunked_source(band, 16384 * (M // 2)),
        rx_push=rx.push,
        max_tx_blocks=3,
    ).start()
    stats = ex.join(timeout=300)

    assert stats.tx_blocks == 3 and stats.rx_blocks == 3
    assert stats.rx_samples == total_hops * (M // 2)
    assert len(consumed) == 3
    kinds = {}
    for rep in reports:
        kinds[rep.channel] = kinds.get(rep.channel, 0) + 1
    assert kinds == {3: 1, 5: 1}, kinds
    cmds = [e.payload for e in station.events if e.kind == "command"]
    assert any(str(c).startswith("page 16505551234") for c in cmds)
    # page response produced a voice assignment + alert + supervision
    assert station.supervisors, "page response did not start supervision"


def test_executor_propagates_thread_errors():
    def bad_source():
        raise RuntimeError("boom")

    ex = ThreadedExecutor(rx_source=bad_source, rx_push=lambda b: None)
    ex.start()
    with pytest.raises(RuntimeError, match="boom"):
        ex.join(timeout=30)


def test_block_queue_backpressure_and_close():
    q = BlockQueue(depth=1)
    q.put(np.zeros(4))
    got = []

    def getter():
        got.append(q.get())
        got.append(q.get())

    t = threading.Thread(target=getter)
    t.start()
    q.put(np.ones(4))
    q.close()
    t.join(10)
    assert not t.is_alive()
    assert got[0] is not None and got[1] is not None
    assert q.get() is None


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_executor_passes_blocks_through_without_copy(kind):
    """The executor hands the EXACT object to the sink/push (a device
    tensor is never copied to the host) and counts samples from the
    block's shape alone."""
    if kind == "numpy":
        blocks = [np.zeros((64, 2), np.float32) for _ in range(3)]
    else:
        blocks = [torch.zeros((64, 2)) for _ in range(3)]
    it = iter(blocks)
    seen_tx, seen_rx = [], []
    ex = ThreadedExecutor(
        tx_step=lambda: next(it, None),
        tx_sink=seen_tx.append,
        rx_source=lambda: blocks[len(seen_rx)] if len(seen_rx) < 3 else None,
        rx_push=seen_rx.append).start()
    stats = ex.join(timeout=30)
    assert len(seen_tx) == len(seen_rx) == 3
    assert all(a is b for a, b in zip(seen_tx, blocks))
    assert all(a is b for a, b in zip(seen_rx, blocks))
    assert stats.tx_samples == stats.rx_samples == 3 * 64


def test_executor_tensor_blocks_never_reach_numpy():
    """A tensor block that the host must not read: converting it to
    numpy raises, and the executor still runs it through both threads
    and counts its samples."""
    class DeviceBlock(torch.Tensor):
        def __array__(self, *a, **k):
            raise AssertionError("a device block was copied to the host")

    blocks = [torch.zeros((32, 2)).as_subclass(DeviceBlock)
              for _ in range(2)]
    it = iter(blocks)
    src = chunked_source(torch.zeros((96, 2)).as_subclass(DeviceBlock), 32)
    seen = []
    ex = ThreadedExecutor(tx_step=lambda: next(it, None),
                          tx_sink=seen.append, rx_source=src,
                          rx_push=seen.append).start()
    stats = ex.join(timeout=30)
    assert stats.tx_samples == 64 and stats.rx_samples == 96
    assert stats.rx_blocks == 3 and len(seen) == 5
