"""The port's SDR seam (``amps_tpu_torch.runtime.sdr``): file and native
ring sources and sinks, the executor over a capture file, sinks that take
host arrays and tensors, and the SoapySDR streaming loops against a fake
SoapySDR module (no SoapySDR is needed)."""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from amps_tpu.eval.traffic import MobileEvent as JEvent
from amps_tpu.eval.traffic import synthesize_reverse_band as jband
from amps_tpu.parallel.pipeline import MultichannelSpec as JSpec
from amps_tpu_torch.eval.traffic import MobileEvent, synthesize_reverse_band
from amps_tpu_torch.parallel.pipeline import MultichannelSpec
from amps_tpu_torch.runtime.executor import ThreadedExecutor
from amps_tpu_torch.runtime.native_rt import Ring
from amps_tpu_torch.runtime.sdr import (FileIQSink, FileIQSource, RingIQSink,
                                        RingIQSource, sink_writer,
                                        soapy_sink, soapy_source,
                                        source_reader)
from amps_tpu_torch.runtime.streamer import MultichannelReceiver

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_sdr_file_roundtrip(tmp_path, kind):
    p = str(tmp_path / "iq.f32")
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    blocks = [x[:12], x[12:]]
    if kind == "tensor":
        blocks = [torch.as_tensor(b) for b in blocks]
    sink = FileIQSink(p)
    writer = sink_writer(sink)
    for b in blocks:
        writer(b)
    sink.close()
    src = FileIQSource(p)
    a = src.read(8)
    b = src.read(100)
    c = src.read(8)
    assert np.array_equal(np.vstack([a, b]), x)
    assert c is None
    src.close()


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_sdr_ring_roundtrip(kind):
    ring = Ring(1 << 16)
    sink = RingIQSink(ring)
    src = RingIQSource(ring, timeout_s=0.2)
    x = np.random.default_rng(0).normal(size=(300, 2)).astype(np.float32)
    sink.write(torch.as_tensor(x) if kind == "tensor" else x)
    got = src.read(300)
    assert np.array_equal(got, x)
    assert src.read(10) is None  # times out empty


def test_ring_source_drains_after_eof():
    """The writer's mark_eof ends the stream only once the ring is
    drained: a read after the mark returns what is left without waiting,
    then None."""
    ring = Ring(1 << 12)
    src = RingIQSource(ring, timeout_s=30.0)
    x = np.arange(100, dtype=np.float32).reshape(50, 2)
    RingIQSink(ring).write(x)
    src.mark_eof()
    t0 = time.monotonic()
    assert np.array_equal(src.read(80), x)
    assert src.read(80) is None
    assert time.monotonic() - t0 < 5.0


def test_ring_sink_backpressure_through_the_executor():
    """A block larger than the ring drains through it in spurts while a
    reader thread pulls blocks: the executor over a ring source sees
    every sample once, in order."""
    ring = Ring(1 << 12)                       # 512 samples
    src = RingIQSource(ring, timeout_s=5.0)
    x = np.random.default_rng(1).normal(size=(5000, 2)).astype(np.float32)

    def writer():
        RingIQSink(ring).write(x)
        src.mark_eof()

    t = threading.Thread(target=writer)
    t.start()
    got = []
    ThreadedExecutor(rx_source=source_reader(src, 300),
                     rx_push=got.append).start().join(timeout=60)
    t.join(10)
    assert np.array_equal(np.concatenate(got), x)


def test_executor_with_sdr_file_source(tmp_path):
    """Full RX over the SDR file seam: capture replay -> reports, the
    capture written by the JAX package's band and read by the port."""
    band = np.asarray(jband(
        [JEvent("registration", 2, 1500, "5551234567", esn=0x77)],
        JSpec(num_channels=8), 2 * 16384))
    p = str(tmp_path / "cap.f32")
    s = FileIQSink(p)
    s.write(band)
    s.close()
    spec = MultichannelSpec(num_channels=8)
    rx = MultichannelReceiver(spec, threshold=0.5, pipeline_depth=2,
                              device="cpu")
    src = FileIQSource(p)
    ex = ThreadedExecutor(rx_source=source_reader(src, 16384 * 4),
                          rx_push=rx.push).start()
    ex.join(timeout=300)
    rx.flush()
    assert len(rx.reports) == 1 and rx.reports[0].channel == 2
    # the port's own band gives the same report
    x = synthesize_reverse_band(
        [MobileEvent("registration", 2, 1500, "5551234567", esn=0x77)],
        spec, 2 * 16384, device="cpu")
    rx2 = MultichannelReceiver(spec, threshold=0.5, device="cpu")
    reps = rx2.push(x) + rx2.flush()
    assert [(r.channel, r.abs_symbol) for r in reps] == \
        [(r.channel, r.abs_symbol) for r in rx.reports]


# -- SoapySDR, against a fake module ----------------------------------------

def _install_fake_soapy(monkeypatch, rx_wave=None, flaky_codes=(),
                        mtu=256, tx_capture=None, tx_accept=97,
                        endless_code=None):
    """Inject a fake SoapySDR module implementing the subset of the Soapy
    streaming API that SoapyIQSource/Sink drive, with the real
    SoapySDR/Errors.h codes (TIMEOUT=-1, STREAM_ERROR=-2, OVERFLOW=-4,
    UNDERFLOW=-7)."""
    sp = types.ModuleType("SoapySDR")
    sp.SOAPY_SDR_RX, sp.SOAPY_SDR_TX = "RX", "TX"
    sp.SOAPY_SDR_CF32 = "CF32"
    sp.SOAPY_SDR_TIMEOUT, sp.SOAPY_SDR_OVERFLOW = -1, -4
    sp.SOAPY_SDR_UNDERFLOW = -7
    sp.errToStr = lambda code: {-1: "TIMEOUT", -2: "STREAM_ERROR",
                                -4: "OVERFLOW",
                                -7: "UNDERFLOW"}.get(code, f"ERR{code}")

    class _SR:
        def __init__(self, ret):
            self.ret = ret

    class Device:
        instances = []

        def __init__(self, args=""):
            self.settings = {}
            self.pos = 0
            self.codes = list(flaky_codes)
            self.active = False
            self.closed = False
            Device.instances.append(self)

        def setSampleRate(self, d, ch, v):
            self.settings[("rate", d, ch)] = v

        def setFrequency(self, d, ch, v):
            self.settings[("freq", d, ch)] = v

        def setGain(self, d, ch, v):
            self.settings[("gain", d, ch)] = v

        def setupStream(self, d, fmt, chans):
            assert fmt == "CF32", fmt
            return ("stream", d, tuple(chans))

        def activateStream(self, st):
            self.active = True

        def deactivateStream(self, st):
            self.active = False

        def closeStream(self, st):
            self.closed = True

        def readStream(self, st, bufs, n, timeoutUs=0):
            assert self.active
            if endless_code is not None:
                return _SR(endless_code)
            if self.codes:
                return _SR(self.codes.pop(0))
            take = min(n, mtu, len(rx_wave) - self.pos)
            if take <= 0:
                return _SR(sp.SOAPY_SDR_TIMEOUT)
            bufs[0][:take] = rx_wave[self.pos:self.pos + take]
            self.pos += take
            return _SR(take)

        def writeStream(self, st, bufs, n, timeoutUs=0):
            assert self.active
            if endless_code is not None:
                return _SR(endless_code)
            if self.codes:
                return _SR(self.codes.pop(0))
            take = min(n, tx_accept)
            tx_capture.append(np.array(bufs[0][:take]))
            return _SR(take)

    sp.Device = Device
    monkeypatch.setitem(sys.modules, "SoapySDR", sp)
    return sp


def test_soapy_source_streams_riq(monkeypatch):
    """Partial reads accumulate to the block size, overflow codes are
    counted and survived, CF32 converts to riq float32 (n, 2), and the
    configuration reaches the device."""
    n = 1000
    wave = (np.arange(n) + 1j * (2 * np.arange(n) + 1)).astype(np.complex64)
    sp = _install_fake_soapy(monkeypatch, rx_wave=wave, flaky_codes=[-4, -4],
                             mtu=256)
    src = soapy_source("driver=fake", rate=400e3, freq=835.59e6, gain=12.0)
    dev = sp.Device.instances[-1]
    assert dev.settings[("rate", "RX", 0)] == 400e3
    assert dev.settings[("freq", "RX", 0)] == 835.59e6
    assert dev.settings[("gain", "RX", 0)] == 12.0

    blk = src.read(600)             # needs 3 partial reads at mtu=256
    assert blk.shape == (600, 2) and blk.dtype == np.float32
    assert np.array_equal(blk[:, 0], np.arange(600, dtype=np.float32))
    assert np.array_equal(blk[:, 1], 2 * np.arange(600, dtype=np.float32) + 1)
    assert src.overflows == 2

    blk2 = src.read(600)            # only 400 left -> partial block
    assert blk2.shape == (400, 2)
    assert np.array_equal(blk2[:, 0], np.arange(600, 1000, dtype=np.float32))
    src.timeout_s = 0.05
    assert src.read(16) is None     # dry stream -> None (EOS signal)
    src.close()
    assert dev.closed and not dev.active
    assert src.read(16) is None     # post-close


def test_soapy_source_raises_on_stream_error(monkeypatch):
    _install_fake_soapy(monkeypatch, rx_wave=np.zeros(8, np.complex64),
                        flaky_codes=[-2])   # fatal STREAM_ERROR
    src = soapy_source("driver=fake")
    with pytest.raises(RuntimeError, match="readStream error -2"):
        src.read(8)


def test_soapy_source_overflow_storm_honors_deadline(monkeypatch):
    """A stalled driver returning OVERFLOW on every call must not hang
    read(): it returns None within ~timeout_s."""
    _install_fake_soapy(monkeypatch, rx_wave=np.zeros(8, np.complex64),
                        endless_code=-4)
    src = soapy_source("driver=fake", timeout_s=0.1)
    t0 = time.monotonic()
    assert src.read(64) is None
    assert time.monotonic() - t0 < 2.0
    assert src.overflows >= 1


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_soapy_sink_writes_riq(monkeypatch, kind):
    """riq blocks (host arrays or tensors) convert to CF32 and drain
    through partial writeStream acceptances; underflow codes are counted
    and survived."""
    got = []
    sp = _install_fake_soapy(monkeypatch, tx_capture=got, tx_accept=97,
                             flaky_codes=[-7])
    sink = soapy_sink("driver=fake", rate=400e3, freq=880.59e6)
    dev = sp.Device.instances[-1]
    assert dev.settings[("rate", "TX", 0)] == 400e3
    n = 500
    riq = np.stack([np.arange(n, dtype=np.float32),
                    -np.arange(n, dtype=np.float32)], axis=1)
    sink.write(torch.as_tensor(riq) if kind == "tensor" else riq)
    sent = np.concatenate(got)
    assert len(sent) == n
    assert np.array_equal(sent.real, riq[:, 0])
    assert np.array_equal(sent.imag, riq[:, 1])
    assert sink.underflows == 1
    sink.close()
    assert dev.closed


def test_soapy_sink_underflow_storm_honors_deadline(monkeypatch):
    """A driver returning UNDERFLOW with no progress must not hang
    write(): the no-progress deadline raises."""
    _install_fake_soapy(monkeypatch, tx_capture=[], endless_code=-7)
    sink = soapy_sink("driver=fake", timeout_s=0.1)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="underflow storm"):
        sink.write(np.zeros((64, 2), np.float32))
    assert time.monotonic() - t0 < 2.0
    assert sink.underflows >= 1
