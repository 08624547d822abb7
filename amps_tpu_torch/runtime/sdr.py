"""SDR I/O adapters, the PyTorch port of ``amps_tpu.runtime.sdr``: the
uhd_usrp_source/sink seam of the reference.

The reference talks to radios through GR's UHD blocks
(grc/ampsbs.grc uhd_usrp_sink @880.59 MHz / uhd_usrp_source, SURVEY.md
§2 rows 'FM modulator chain' / 'RECC receiver front end').  This
framework keeps radio I/O behind two tiny interfaces so the same
executor runs against files, the native SPSC ring (fed by an external
radio process), a simulator, or — where a SoapySDR/UHD Python module
exists — real hardware:

  IQSource.read(n)  -> (n, 2) float32 riq host numpy block (or None at
                       end); the receiver copies it to its device
  IQSink.write(blk) -> consume an (n, 2) float32 riq block: host numpy
                       or a tensor on any device, copied to the host
                       once, inside write

Raw format on files/rings is interleaved float32 I,Q — the same raw
format the reference's file-source test graphs use (grc/recctest.grc).

SoapySDR is optional: ``soapy_source`` raises ImportError with
instructions unless its Python module is installed (stub-or-gate
policy).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch


def _host_riq(block) -> np.ndarray:
    """A contiguous float32 host array of ``block``: a tensor is copied
    from its device once; a host array is converted only if it must."""
    if isinstance(block, torch.Tensor):
        return block.detach().to("cpu", torch.float32).contiguous().numpy()
    return np.ascontiguousarray(np.asarray(block, np.float32))


class IQSource:
    def read(self, n: int) -> Optional[np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class IQSink:
    def write(self, block) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FileIQSource(IQSource):
    """Raw interleaved float32 I/Q file (the recctest.grc replay seam)."""

    def __init__(self, path: str, repeat: bool = False):
        self._f = open(path, "rb")
        self.repeat = repeat

    def read(self, n: int) -> Optional[np.ndarray]:
        raw = np.fromfile(self._f, dtype=np.float32, count=2 * n)
        if len(raw) < 2 and self.repeat:
            self._f.seek(0)
            raw = np.fromfile(self._f, dtype=np.float32, count=2 * n)
        if len(raw) < 2:
            return None
        return raw[: (len(raw) // 2) * 2].reshape(-1, 2)

    def close(self) -> None:
        self._f.close()


class FileIQSink(IQSink):
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, block) -> None:
        _host_riq(block).tofile(self._f)

    def close(self) -> None:
        self._f.close()


class RingIQSource(IQSource):
    """Reads riq blocks from a native SPSC ring (runtime.native_rt.Ring)
    written by an external radio process; blocks until enough samples
    arrive or ``timeout_s`` passes (then returns what it has, or None).
    Once the writer has called ``mark_eof`` a read waits no more: it
    returns what is left in the ring, and None when the ring is empty
    (the JAX package's source returns None at once, dropping what the
    writer put in before its mark).
    """

    def __init__(self, ring, timeout_s: float = 1.0):
        self.ring = ring
        self.timeout_s = timeout_s
        self._eof = False

    def read(self, n: int) -> Optional[np.ndarray]:
        want = n * 8  # float32 I+Q
        deadline = time.monotonic() + self.timeout_s
        while (self.ring.readable < want and not self._eof
               and time.monotonic() < deadline):
            time.sleep(0.001)
        avail = min(self.ring.readable, want) // 8 * 8
        if avail == 0:
            return None
        raw = np.frombuffer(self.ring.read(avail), np.float32)
        return raw.reshape(-1, 2).copy()

    def mark_eof(self) -> None:
        """The writer is done: drain what is left, then end the stream."""
        self._eof = True


class RingIQSink(IQSink):
    """Writes riq blocks into a native SPSC ring read by an external
    radio process; blocks on backpressure."""

    def __init__(self, ring, timeout_s: float = 5.0):
        self.ring = ring
        self.timeout_s = timeout_s

    def write(self, block) -> None:
        data = memoryview(_host_riq(block)).cast("B")
        deadline = time.monotonic() + self.timeout_s
        off = 0
        while off < len(data):
            wrote = self.ring.write(data[off:])
            off += wrote
            if wrote == 0:
                if time.monotonic() > deadline:
                    raise TimeoutError("ring sink backpressure timeout")
                time.sleep(0.001)
            else:
                # progress re-arms the deadline (same rule as
                # SoapyIQSink.write): a block longer than timeout_s of
                # real-time-paced samples drains in healthy spurts —
                # only a stall with NO progress for timeout_s is a fault
                deadline = time.monotonic() + self.timeout_s


def _import_soapy():
    try:
        import SoapySDR
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "SoapySDR python module not available in this environment; "
            "use FileIQSource/RingIQSource, or install SoapySDR") from e
    return SoapySDR


# SoapySDR.h Errors.h codes (fixed by the Soapy ABI; read from the
# module when present so a fake/test module can override).  NOTE the
# real ABI: TIMEOUT=-1, STREAM_ERROR=-2, CORRUPTION=-3, OVERFLOW=-4,
# NOT_SUPPORTED=-5, TIME_ERROR=-6, UNDERFLOW=-7.
_SOAPY_TIMEOUT = -1
_SOAPY_OVERFLOW = -4
_SOAPY_UNDERFLOW = -7


class SoapyIQSource(IQSource):
    """Real-hardware RX via SoapySDR — the reference's uhd_usrp_source
    seam (grc/ampsbs.grc:3069: 400 ksps tuned fcc_freq-45 MHz-rx_offset).

    Streams CF32 off the device and yields riq float32 (n, 2) blocks
    (complex stays host-side only — the device path is riq by design).
    Overflows are counted, not fatal (the RECC
    correlator re-synchronizes on the next burst's dotting, exactly as
    the reference's ring buffer does after a scheduler stall).
    """

    def __init__(self, args: str = "", rate: float = 400e3,
                 freq: float = 835.59e6, gain: float = 30.0,
                 channel: int = 0, timeout_s: float = 1.0):
        sp = _import_soapy()
        self._sp = sp
        self.timeout_s = timeout_s
        self.overflows = 0
        self.dev = sp.Device(args)
        rx = sp.SOAPY_SDR_RX
        self.dev.setSampleRate(rx, channel, rate)
        self.dev.setFrequency(rx, channel, freq)
        self.dev.setGain(rx, channel, gain)
        self._stream = self.dev.setupStream(rx, sp.SOAPY_SDR_CF32,
                                            [channel])
        self.dev.activateStream(self._stream)
        self._closed = False

    def read(self, n: int) -> Optional[np.ndarray]:
        """Blocking read of up to ``n`` samples; returns what arrived
        within ``timeout_s`` (None only when nothing did or after
        close — the executor's end-of-stream signal)."""
        if self._closed:
            return None
        sp = self._sp
        buf = np.empty(n, np.complex64)
        filled = 0
        deadline = time.monotonic() + self.timeout_s
        per_call_us = max(1000, int(min(self.timeout_s, 0.1) * 1e6))
        while filled < n:
            sr = self.dev.readStream(self._stream, [buf[filled:]],
                                     n - filled, timeoutUs=per_call_us)
            ret = int(sr.ret)
            if ret > 0:
                filled += ret
            elif ret == getattr(sp, "SOAPY_SDR_OVERFLOW", _SOAPY_OVERFLOW):
                # samples were dropped in the driver; keep streaming —
                # but still honor the deadline (a stalled driver can
                # return OVERFLOW forever; read() must return within
                # timeout_s regardless)
                self.overflows += 1
                if time.monotonic() >= deadline:
                    break
            elif ret == getattr(sp, "SOAPY_SDR_TIMEOUT", _SOAPY_TIMEOUT) \
                    or ret == 0:
                if time.monotonic() >= deadline:
                    break
            else:
                raise RuntimeError(f"SoapySDR readStream error {ret}: "
                                   f"{_soapy_err_str(sp, ret)}")
        if filled == 0:
            return None
        return buf[:filled].view(np.float32).reshape(-1, 2).copy()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.dev.deactivateStream(self._stream)
            self.dev.closeStream(self._stream)


class SoapyIQSink(IQSink):
    """Real-hardware TX via SoapySDR — the reference's uhd_usrp_sink
    seam (grc/ampsbs.grc:2246: the channelized wideband @880.59 MHz /
    400 ksps).  Consumes riq float32 (n, 2) blocks; blocks on device
    backpressure (the hardware pacing that makes the whole station run
    at true real time)."""

    def __init__(self, args: str = "", rate: float = 400e3,
                 freq: float = 880.59e6, gain: float = 30.0,
                 channel: int = 0, timeout_s: float = 5.0):
        sp = _import_soapy()
        self._sp = sp
        self.timeout_s = timeout_s
        self.underflows = 0
        self.dev = sp.Device(args)
        tx = sp.SOAPY_SDR_TX
        self.dev.setSampleRate(tx, channel, rate)
        self.dev.setFrequency(tx, channel, freq)
        self.dev.setGain(tx, channel, gain)
        self._stream = self.dev.setupStream(tx, sp.SOAPY_SDR_CF32,
                                            [channel])
        self.dev.activateStream(self._stream)
        self._closed = False

    def write(self, block) -> None:
        sp = self._sp
        riq = _host_riq(block)
        assert riq.ndim == 2 and riq.shape[1] == 2, riq.shape
        cbuf = riq.view(np.complex64).reshape(-1)
        off = 0
        deadline = time.monotonic() + self.timeout_s
        per_call_us = max(1000, int(min(self.timeout_s, 0.1) * 1e6))
        while off < len(cbuf):
            sr = self.dev.writeStream(self._stream, [cbuf[off:]],
                                      len(cbuf) - off,
                                      timeoutUs=per_call_us)
            ret = int(sr.ret)
            if ret > 0:
                off += ret
                # progress re-arms the deadline: a block longer than
                # timeout_s of samples is LEGITIMATELY paced by the
                # device for longer than timeout_s total — only a stall
                # with no progress for timeout_s is a backpressure fault
                deadline = time.monotonic() + self.timeout_s
            elif ret == getattr(sp, "SOAPY_SDR_UNDERFLOW", _SOAPY_UNDERFLOW):
                # count and keep draining — but honor the no-progress
                # deadline (a broken driver returning UNDERFLOW forever
                # must not hang the executor TX thread, the same storm
                # class as read()'s OVERFLOW branch)
                self.underflows += 1
                if time.monotonic() >= deadline:
                    raise TimeoutError("SoapySDR writeStream underflow "
                                       "storm with no progress")
            elif ret == getattr(sp, "SOAPY_SDR_TIMEOUT", _SOAPY_TIMEOUT) \
                    or ret == 0:
                if time.monotonic() >= deadline:
                    raise TimeoutError("SoapySDR writeStream backpressure "
                                       "timeout")
            else:
                raise RuntimeError(f"SoapySDR writeStream error {ret}: "
                                   f"{_soapy_err_str(sp, ret)}")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.dev.deactivateStream(self._stream)
            self.dev.closeStream(self._stream)


def _soapy_err_str(sp, ret: int) -> str:
    fn = getattr(sp, "errToStr", None)
    return fn(ret) if fn else "unknown"


def soapy_source(args: str = "", rate: float = 400e3,
                 freq: float = 835.59e6, gain: float = 30.0,
                 **kw) -> SoapyIQSource:
    """Real-hardware source via SoapySDR, if the module is installed
    (deployments that install SoapySDR get the reference's USRP/HackRF
    coverage)."""
    return SoapyIQSource(args, rate, freq, gain, **kw)


def soapy_sink(args: str = "", rate: float = 400e3,
               freq: float = 880.59e6, gain: float = 30.0,
               **kw) -> SoapyIQSink:
    """Real-hardware sink via SoapySDR (uhd_usrp_sink parity)."""
    return SoapyIQSink(args, rate, freq, gain, **kw)


def source_reader(src: IQSource, block_samples: int):
    """Adapt an IQSource to the executor's rx_source callable."""
    def reader():
        return src.read(block_samples)
    return reader


def sink_writer(sink: IQSink):
    """Adapt an IQSink to the executor's tx_sink callable."""
    def writer(block):
        sink.write(block)
    return writer
