"""Samples/s rate meters, host spans and device stage spans, the PyTorch
port of ``amps_tpu.utils.profiling``.

* ``RateMeter`` / ``meter``: an EMA of samples/s.  On a CUDA device it
  is the rate the device achieved, from timing events on its stream;
  elsewhere the host's wall clock between ``update`` calls.
* ``trace(label)``: a host span.  It is a ``torch.profiler``
  ``record_function`` range (shown in any profiler window open around
  it) and a record kept in memory: name, start and end on
  ``time.monotonic_ns()``, the call id, and whether a profiler was
  recording (its times then carry the profiler's cost).
  Kineto stamps host events on the Unix clock (``trace_start_ns`` plus
  each event's offset): add ``time.time_ns() - time.monotonic_ns()`` to
  a span's times to place it there.
* ``stage(label, device)``: a device span of work that may be captured
  in a CUDA graph: a timing event recorded on the current stream at
  entry and at exit (inside ``capturing()``, an event-record node that
  every replay stamps again; ``replayed`` keeps them under the call),
  or the host's monotonic clock on the CPU, where ops run
  synchronously.  Nothing here synchronises: ``collect()`` turns the
  stages whose events have completed into samples (ms of the last block
  of a call) and leaves the others pending.
* ``begin_call()``: opens a call (one call of the closed loop's
  ``run``): the spans and stages that follow carry its id.

Records are kept in rings of ``RING`` a name and never written out.  The
JAX package's ``start_server`` (a ``jax.profiler`` server for
TensorBoard capture) has no torch counterpart and is not ported.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch

RING = 4096                     # records kept a name
METER_STAMPS = 64               # a meter's stamps not yet folded in


class _HostStamp:
    """A stamp of the host's monotonic clock with the interface of a
    CUDA timing event (``query``, ``elapsed_time`` in ms)."""

    __slots__ = ("ns",)

    def __init__(self):
        self.ns = time.monotonic_ns()

    def query(self) -> bool:
        return True

    def elapsed_time(self, end: "_HostStamp") -> float:
        return (end.ns - self.ns) / 1e6


def _stamp(device: torch.device):
    """A stamp of the work queued so far on ``device``: a timing event
    recorded on its current stream (an external event-record node while
    the stream is captured), or the host clock off CUDA."""
    if device.type != "cuda":
        return _HostStamp()
    ev = torch.cuda.Event(enable_timing=True,
                          external=torch.cuda.is_current_stream_capturing())
    ev.record(torch.cuda.current_stream(device))
    return ev


class RateMeter:
    """Exponential-moving-average samples/s counter.  ``device``: where
    the samples are processed; on a CUDA device each ``update`` stamps
    a timing event on the current stream, and the rate folds in the
    device time between consecutive stamps once both have completed
    (found with ``query``, never by a sync), so it is the rate the
    device achieved, idle gaps included, not the host's enqueue rate.
    Elsewhere it is the host's ``perf_counter`` between updates."""

    def __init__(self, name: str, alpha: float = 0.2, device=None):
        self.name = name
        self.alpha = alpha
        self.rate = 0.0
        self.total = 0
        self.device = None if device is None else torch.device(device)
        self._t_last: Optional[float] = None
        self._stamps: Deque = collections.deque(maxlen=METER_STAMPS)

    def _fold(self, n_samples: int, dt: float) -> None:
        if dt > 0:
            inst = n_samples / dt
            self.rate = (self.alpha * inst
                         + (1 - self.alpha) * (self.rate or inst))

    def update(self, n_samples: int) -> None:
        self.total += n_samples
        if self.device is None or self.device.type != "cuda":
            now = time.perf_counter()
            if self._t_last is not None:
                self._fold(n_samples, now - self._t_last)
            self._t_last = now
            return
        self._stamps.append((_stamp(self.device), n_samples))
        while len(self._stamps) >= 2 and self._stamps[1][0].query():
            (e0, _), (e1, n) = self._stamps[0], self._stamps[1]
            self._fold(n, e0.elapsed_time(e1) / 1e3)
            self._stamps.popleft()

    def __repr__(self) -> str:
        return f"RateMeter({self.name}: {self.rate/1e6:.2f} Msamples/s)"


_METERS: Dict[str, RateMeter] = {}


def meter(name: str, device=None) -> RateMeter:
    """The process's meter ``name``, made on first use (with
    ``device``)."""
    if name not in _METERS:
        _METERS[name] = RateMeter(name, device=device)
    return _METERS[name]


@dataclasses.dataclass(frozen=True)
class Span:
    """A host span: times in ns of ``time.monotonic_ns()``;
    ``profiled``: a ``torch.profiler`` window was recording."""
    name: str
    start_ns: int
    end_ns: int
    call: int
    profiled: bool

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_LOCK = threading.Lock()
_call = 0
_SPANS: Dict[str, Deque[Span]] = {}
_STAGES: Dict[str, Deque[Tuple[int, float]]] = {}      # (call, ms)
# (call, label) -> (start, end) stamps not yet complete or collected
_PENDING: Dict[Tuple[int, str], tuple] = {}
_LAST_END: Dict[object, object] = {}     # stream -> the last stage's end
_capture: Optional[list] = None         # the open capture's stages
COUNTERS = {"stage_pending": 0}          # left pending by the last collect


def _ring(store: dict, name: str) -> Deque:
    ring = store.get(name)
    if ring is None:
        ring = store.setdefault(name, collections.deque(maxlen=RING))
    return ring


def begin_call() -> int:
    """Collect what is complete, then open a new call; returns its id."""
    global _call
    collect()
    with _LOCK:
        _call += 1
        _LAST_END.clear()
        return _call


@contextlib.contextmanager
def trace(label: str):
    """A host span named ``label``: a ``torch.profiler`` range and a
    record in memory (see ``spans``)."""
    with torch.profiler.record_function(label):
        call = _call
        profiled = torch.autograd.profiler._is_profiler_enabled
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            t1 = time.monotonic_ns()
            _ring(_SPANS, label).append(Span(label, t0, t1, call, profiled))


def _pend(call: int, stages) -> None:
    """Keep stages' (label, start, end) stamps until ``collect``: the
    last block of a call replaces the earlier ones; an entry of an
    earlier call that holds the same stamps (a graph replayed again) can
    no longer be read and is dropped."""
    with _LOCK:
        ends = {id(end) for _, _, end in stages}
        for k, (_, e) in list(_PENDING.items()):
            if k[0] != call and id(e) in ends:
                del _PENDING[k]
        for label, start, end in stages:
            _PENDING.pop((call, label), None)
            _PENDING[(call, label)] = (start, end)


@contextlib.contextmanager
def stage(label: str, device=None, joined: bool = False):
    """A device span named ``label`` of the work the body queues on
    ``device``'s current stream (the host's clock when ``device`` is
    None or not a CUDA device).  ``joined``: the stage starts at the stamp that
    ended the last stage on this stream, so adjacent stages share one
    event; launch nothing between two such stages that should not count
    to the later one.  Under CUDA graph capture a stage stamps only
    inside ``capturing()``, whose list takes its events for
    ``replayed``; a graph captured outside it has no event nodes."""
    dev = torch.device("cpu" if device is None else device)
    capturing = dev.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()
    if capturing and _capture is None:
        yield
        return
    key = (torch.cuda.current_stream(dev).cuda_stream
           if dev.type == "cuda" else "cpu")
    start = _LAST_END.pop(key, None) if joined else None
    if start is None:
        start = _stamp(dev)
    yield
    end = _stamp(dev)
    _LAST_END[key] = end
    if capturing:
        _capture.append((label, start, end))
    else:
        _pend(_call, [(label, start, end)])


@contextlib.contextmanager
def capturing():
    """Gather the stages captured in the body (a ``torch.cuda.graph``
    capture): yields their list of (label, start, end), for
    ``replayed`` after each call's replays."""
    global _capture
    prev, _capture = _capture, []
    try:
        yield _capture
    finally:
        _capture = prev


def replayed(stages: list) -> None:
    """Keep a captured graph's stages under the open call, once its
    replays are queued: their events hold the last replay's times."""
    _pend(_call, stages)


def collect() -> None:
    """Turn the pending stages whose stamps have completed into samples
    (``stage_samples``); the others stay pending, counted in
    ``COUNTERS["stage_pending"]``.  Never synchronises."""
    with _LOCK:
        for k, (start, end) in list(_PENDING.items()):
            if end.query() and start.query():
                del _PENDING[k]
                _ring(_STAGES, k[1]).append(
                    (k[0], start.elapsed_time(end)))
        COUNTERS["stage_pending"] = len(_PENDING)


def spans(name: str) -> List[Span]:
    """The host spans named ``name`` kept, oldest first."""
    return list(_SPANS.get(name, ()))


def stage_samples(label: str) -> List[Tuple[int, float]]:
    """(call id, ms) of the collected samples of stage ``label``, oldest
    first: the last block of each call."""
    return list(_STAGES.get(label, ()))


def reset() -> None:
    """Drop every span, sample, pending stage and counter."""
    with _LOCK:
        for store in (_SPANS, _STAGES, _PENDING, _LAST_END):
            store.clear()
        for k in COUNTERS:
            COUNTERS[k] = 0
