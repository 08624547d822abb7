"""``utils.profiling``'s host spans and device stages on the CPU: a
``trace`` span's record and its place on Kineto's clock, the closed
loop's stages and entry span a call, ``collect`` on stamps not yet
complete, the benchmark's readers of the spans, the loop's results with
the stages on and off, and ``RateMeter`` on stamps of a device."""

import contextlib
import importlib.util
import pathlib
import statistics
import time

import numpy as np
import pytest
import torch

from amps_tpu_torch.parallel.pipeline import MultichannelSpec
from amps_tpu_torch.runtime import streamer as S
from amps_tpu_torch.utils import profiling as P
from portbench.trace import Trace

REPO = pathlib.Path(__file__).resolve().parent.parent
STAGES = ("loop.phases", "loop.search", "loop.capture", "loop.decode")
# the closed loop at the width of tests/test_torch_closed_loop.py
M, T, FRAMES = 8, 4, 2


@pytest.fixture(autouse=True)
def clean():
    P.reset()
    yield
    P.reset()


class Stub:
    """A device stamp at ``ms`` that completes when ``done`` says so;
    a read before completion fails the test."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "read before completion"
        return end.ms - self.ms


def _forbidden(*args, **kwargs):
    raise AssertionError("called where nothing may sync or stamp")


def _spec():
    return MultichannelSpec(num_channels=M, taps_per_phase=T)


def _pairs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (M, FRAMES, 2, 28)).astype(np.uint8)


def test_trace_records_name_and_call():
    call = P.begin_call()
    with P.trace("outer"):
        with P.trace("inner"):
            pass
    P.begin_call()
    with P.trace("inner"):
        pass
    (outer,) = P.spans("outer")
    first, second = P.spans("inner")
    assert (outer.name, outer.call) == ("outer", call)
    assert (first.call, second.call) == (call, call + 1)
    assert outer.start_ns <= first.start_ns <= first.end_ns <= outer.end_ns
    assert first.ms >= 0
    assert not any(s.profiled for s in (outer, first, second))


def test_trace_span_sits_on_the_profilers_clock():
    """The span is a ``record_function`` event of the profile too, and
    its monotonic start lies within 200 µs of that event's start put on
    the monotonic clock (Kineto stamps the Unix clock)."""
    with P.trace("warm"):                 # the range's first-use cost
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with P.trace("amps_span"):
                torch.ones(4).sum()
    to_mono = time.monotonic_ns() - time.time_ns()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    starts = sorted(e.time_range.start for e in prof.events()
                    if e.name == "amps_span")
    assert len(starts) == 5
    gaps = [abs(s.start_ns - (t0 + round(us * 1e3) + to_mono)) / 1e3
            for s, us in zip(P.spans("amps_span"), starts)]
    assert statistics.median(gaps) < 200, gaps
    # a span taken while a profiler records says so
    assert [s.profiled for s in P.spans("warm")] == [False]
    assert all(s.profiled for s in P.spans("amps_span"))


def test_closed_loop_records_each_stage_once_a_call():
    run, _ = S.make_closed_loop_stream(_spec(), nblocks=2, frames=FRAMES,
                                       device="cpu")
    walls = []
    for seed in range(2):
        t0 = time.monotonic_ns()
        run(_pairs(seed))
        walls.append((time.monotonic_ns() - t0) / 1e6)
    P.collect()
    entries = P.spans("loop.entry")
    calls = [s.call for s in entries]
    assert len(set(calls)) == 2
    for label in STAGES:
        samples = P.stage_samples(label)
        assert [c for c, _ in samples] == calls, label
        assert all(ms > 0 for _, ms in samples), label
    for entry, wall in zip(entries, walls):
        four = sum(ms for label in STAGES
                   for c, ms in P.stage_samples(label) if c == entry.call)
        assert 0 < four <= wall - entry.ms
    assert P.COUNTERS == {"stage_pending": 0}


def test_stages_share_an_event_at_each_boundary(monkeypatch):
    """Five stamps a block: one at the start and one at the end of each
    of the four stages, the next stage starting at the last one's end."""
    made = []

    def stamp(device):
        made.append(P._HostStamp())
        return made[-1]

    monkeypatch.setattr(P, "_stamp", stamp)
    run, _ = S.make_closed_loop_stream(_spec(), nblocks=3, frames=FRAMES,
                                       device="cpu")
    run(_pairs())
    assert len(made) == 3 * 5


def test_collect_leaves_incomplete_stages_pending(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", _forbidden)
    call = P.begin_call()
    a, b, c = Stub(1.0), Stub(3.5, done=False), Stub(4.0, done=False)
    P.replayed([("loop.search", a, b), ("loop.capture", b, c)])
    P.collect()
    assert P.stage_samples("loop.search") == []
    assert P.COUNTERS["stage_pending"] == 2
    b.done = True
    P.collect()
    assert P.stage_samples("loop.search") == [(call, 2.5)]
    assert P.stage_samples("loop.capture") == []
    assert P.COUNTERS["stage_pending"] == 1
    # the graph replayed again in a new call before the old call's
    # stamps were read: the old call's sample is dropped, not misread
    P.begin_call()
    P.replayed([("loop.capture", b, c)])
    c.done = True
    P.collect()
    assert P.stage_samples("loop.capture") == [(call + 1, 0.5)]
    assert P.COUNTERS["stage_pending"] == 0


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name.replace('.', '_')}",
        REPO / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _window(n):
    """The trace of a timed window of ``n`` unprofiled calls."""
    return Trace(host={"call": [0.1] * n})


def _plant(monkeypatch, entry_ms, stage_ms, profiled=False):
    """One call of the loop: its ``loop.entry`` span of ``entry_ms``
    (taken while a profiler records, with ``profiled``) and a sample of
    ``stage_ms`` of each stage."""
    P.begin_call()
    with monkeypatch.context() as m:
        clock = iter([0, round(entry_ms * 1e6)])
        m.setattr(time, "monotonic_ns", lambda: next(clock))
        m.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                  profiled)
        with P.trace("loop.entry"):
            pass
    P.replayed([(label, Stub(10.0), Stub(10.0 + stage_ms))
                for label in STAGES])


READERS = [f"{name}.{family}" for family in ("duplex", "duplex_host")
           for name in ("phases_ms", "search_ms", "capture_ms",
                        "decode_ms", "entry_ms")]


@pytest.mark.parametrize("family", ["duplex", "duplex_host"])
@pytest.mark.parametrize("stage", ["phases", "search", "capture", "decode"])
def test_stage_reader_reads_the_median_of_its_samples(stage, family,
                                                      monkeypatch):
    read = _reader(f"{stage}_ms.{family}")
    assert read(None) is None and read(_window(3)) is None
    for ms in (3.0, 1.0, 2.5):
        _plant(monkeypatch, 1.0, 50.0)
        P.replayed([(f"loop.{stage}", Stub(10.0), Stub(10.0 + ms))])
    assert read(Trace()) is None          # no window recorded
    assert read(_window(3)) == 2.5


@pytest.mark.parametrize("family", ["duplex", "duplex_host"])
def test_entry_reader_reads_the_median_of_its_spans(family, monkeypatch):
    read = _reader(f"entry_ms.{family}")
    assert read(None) is None and read(_window(3)) is None
    for ms in (4.0, 1.0, 9.0):
        _plant(monkeypatch, ms, 1.0)
    with P.trace("loop.other"):
        pass
    assert read(Trace()) is None
    assert read(_window(3)) == 4.0


@pytest.mark.parametrize("name", READERS)
def test_reader_leaves_out_warm_up_and_profiled_calls(name, monkeypatch):
    """The warm-up calls before the window and the calls of its profiled
    sub-windows are not read: only the window's last unprofiled calls,
    as many as the trace's call walls."""
    read = _reader(name)
    _plant(monkeypatch, 500.0, 500.0)             # warm-up, capture too
    _plant(monkeypatch, 100.0, 100.0)             # warm-up
    _plant(monkeypatch, 2.0, 2.0)
    _plant(monkeypatch, 100.0, 100.0, profiled=True)
    _plant(monkeypatch, 3.0, 3.0)
    _plant(monkeypatch, 100.0, 100.0, profiled=True)
    _plant(monkeypatch, 1.0, 1.0)
    assert read(_window(3)) == 2.0
    assert read(_window(1)) == 1.0


def _no_stage(label, device=None, joined=False):
    return contextlib.nullcontext()


def test_loop_results_equal_with_stages_on_and_off(monkeypatch):
    spec, wp = _spec(), _pairs(3)
    out = {}
    for on in (True, False):
        if not on:
            monkeypatch.setattr(P, "stage", _no_stage)
        run, _ = S.make_closed_loop_stream(spec, nblocks=2, frames=FRAMES,
                                           device="cpu")
        sums = run(wp)
        st = S.closed_loop_state0(spec, FRAMES, "cpu")
        Y = torch.as_tensor(np.random.default_rng(4).normal(
            0, 0.3, (S.closed_loop_geometry(spec, FRAMES)[0], M, 2)),
            dtype=torch.float32)
        st2, planes = S.closed_loop_block(Y, st, spec)
        out[on] = (sums, st2, planes)
    (s1, st1, p1), (s0, st0, p0) = out[True], out[False]
    assert all(torch.equal(a, b) for a, b in zip(s1, s0))
    assert all(torch.equal(st1[k], st0[k]) for k in st1)
    assert all(torch.equal(p1[k], p0[k]) for k in p1)
    assert len(P.stage_samples("loop.phases")) == 1   # the run with them


def test_rate_meter_on_a_device_reads_completed_stamps(monkeypatch):
    """On a CUDA device the rate comes from the device time between
    completed stamps; an incomplete stamp is waited for by no one."""
    stamps = iter([Stub(0.0), Stub(2.0), Stub(3.0, done=False)])
    monkeypatch.setattr(P, "_stamp", lambda device: next(stamps))
    m = P.RateMeter("dev", device="cuda")
    m.update(1000)
    assert m.rate == 0.0
    m.update(4000)                       # 4000 samples in 2 ms
    assert m.rate == pytest.approx(2e6)
    m.update(1000)                       # its stamp is still running
    assert m.rate == pytest.approx(2e6) and m.total == 6000
