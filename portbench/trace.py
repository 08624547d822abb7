"""Profiled sub-windows of a run and what the per-layer metrics read
from them.

A sub-window synchronises the device, starts ``torch.profiler`` with
CUDA activity alone (recording every host op would slow the host's
dispatch and inflate the idle share), spends the first launch on a fill
(the first launch after the profiler starts may go unrecorded), then
runs a few units of the cell's work between two marker kernels
(``torch.cuda._sleep``): the window is the device's time from the start
of the first marker to the end of the second.  One further sub-window
records host activity as well; it only names what the host was in
during each idle gap.  The units' wrappers are entries of
``portbench.kernels``: the spans of each entry's pattern are counted
against the calls its wrapper's launch counter saw over the same units
times the kernels a call launches; a sub-window that falls short (CUPTI
has dropped records on this card before) is taken again, up to
``TRIES`` times, then left out; a traced run in which no sub-window
recorded every span fails.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import statistics
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from portbench.kernels import Kernel

TRIES = 3
WINDOW = "portbench.window"
MARK = "spin_kernel"                     # torch.cuda._sleep's kernel
MARK_CYCLES = 1000
# the port's bank kernels, K1-K4 on the FFT tile and on the device-memory
# route (amps_tpu_torch/csrc); K5, the trigger search, is not among them
BANK_KERNEL = re.compile(r"\b(analysis_kernel|rx_front_kernel|"
                         r"rx_phases_kernel|rx_phases_power_kernel|"
                         r"synth_kernel|synth_combine_kernel|route_\w+)")
GEMM = re.compile(r"gemm|xmma|cutlass|cublas", re.IGNORECASE)


@dataclasses.dataclass
class Trace:
    """What the profiled sub-windows of one run recorded."""
    units: int = 0                       # pushes or blocks profiled
    window_s: float = 0.0                # the sub-windows' length
    busy_s: float = 0.0                  # union of device activity
    ops: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    gaps: Dict[str, float] = dataclasses.field(default_factory=dict)
    tries: int = 0                       # sub-windows taken, retakes too
    # the units' wrappers (``portbench.kernels``) by name, and the calls
    # of each that the kept sub-windows recorded
    kernels: Dict[str, Kernel] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    # host-clock readings of the benchmark outside the sub-windows, in
    # seconds: push or call walls, report latencies
    host: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    def op_seconds(self, pattern) -> Tuple[float, int]:
        """Device seconds and calls of the ops whose name matches."""
        rx = re.compile(pattern) if isinstance(pattern, str) else pattern
        s = sum(v for k, v in self.ops.items() if rx.search(k))
        n = sum(v for k, v in self.calls.items() if rx.search(k))
        return s, n


def _label(t, spans, ops, starts) -> str:
    """What the host was in at time t: the benchmark's innermost range
    and the innermost host op."""
    span = max((s for s in spans if s[0] <= t <= s[1]), default=None)
    op = None
    for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if ops[j][1] >= t:
            op = ops[j]
            break
        if t - ops[j][0] > 1e5:          # nothing open 0.1 s back
            break
    name = span[2][len("portbench."):] if span else "harness"
    return f"{name}: {op[2] if op else 'python'}"


def _digest(prof, out: Trace, labels: bool) -> Dict[str, int]:
    """Fold one sub-window's profile into ``out``: with ``labels`` only
    the idle gaps by what the host was in, otherwise the window, the
    busy time and the ops.  Returns the device spans counted by op
    name."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events
                 if e.device_type == DeviceType.CUDA and not
                 e.is_user_annotation)
    marks = [d for d in dev if MARK in d[2]]
    if len(marks) < 2:
        return {}
    w0, w1 = marks[0][0], marks[-1][1]
    dev = [d for d in dev if w0 < d[0] and d[1] < w1 and MARK not in d[2]]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in host
             if e.is_user_annotation and e.name.startswith("portbench.")
             and e.name != WINDOW]
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in host if not e.is_user_annotation)
    starts = [o[0] for o in ops]
    counts: Dict[str, int] = {}
    busy, end = 0.0, marks[0][1]
    for a, b, name in dev + [(marks[-1][0], w1, MARK)]:
        if a > end and labels:
            lab = _label(end, spans, ops, starts)
            out.gaps[lab] = out.gaps.get(lab, 0.0) + (a - end) / 1e6
        if name == MARK:
            break
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        counts[name] = counts.get(name, 0) + 1
        if not labels:
            out.ops[name] = out.ops.get(name, 0.0) + (b - a) / 1e6
            out.calls[name] = out.calls.get(name, 0) + 1
    if not labels:
        out.busy_s += busy / 1e6
        out.window_s += (w1 - w0) / 1e6
    return counts


def missing(counts: Dict[str, int], kernels: Sequence[Kernel],
            calls: Dict[str, int]) -> Dict[str, Tuple[int, int]]:
    """The patterns whose spans in ``counts`` (op name -> spans) fall
    short of the kernels that ``calls`` (wrapper name -> calls) of
    ``kernels`` launched: pattern -> (spans seen, kernels launched)."""
    want: Dict[str, int] = {}
    for k in kernels:
        want[k.pattern] = want.get(k.pattern, 0) + calls[k.name] * k.launches
    short = {}
    for pat, n in want.items():
        seen = sum(v for name, v in counts.items() if re.search(pat, name))
        if seen < n:
            short[pat] = (seen, n)
    return short


def profile(units: Callable[[int], None], n: int, device,
            kernels: Sequence[Kernel], out: Trace,
            labels: bool = False) -> bool:
    """Profile ``units(n)`` into ``out`` (with ``labels``, host activity
    too, for the names of the idle gaps only), retaking a sub-window in
    which the spans of a pattern of ``kernels`` (the units' wrappers,
    ``portbench.kernels``) fall short of what their calls launched.
    Returns whether the last try recorded every launch."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if labels
                                      else [])
    for _ in range(TRIES):
        torch.cuda.synchronize(device)
        before = {k.name: k.calls() for k in kernels}
        with tprofile(activities=acts) as prof:
            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
            torch.cuda._sleep(MARK_CYCLES)
            with record_function(WINDOW):
                units(n)
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize(device)
        out.tries += 1
        trial = Trace()
        counts = _digest(prof, trial, labels)
        calls = {k.name: k.calls() - before[k.name] for k in kernels}
        if counts and not missing(counts, kernels, calls):
            if labels:
                for k, v in trial.gaps.items():
                    out.gaps[k] = out.gaps.get(k, 0.0) + v
                return True
            out.units += n
            out.window_s += trial.window_s
            out.busy_s += trial.busy_s
            for k, v in trial.ops.items():
                out.ops[k] = out.ops.get(k, 0.0) + v
            for k, v in trial.calls.items():
                out.calls[k] = out.calls.get(k, 0) + v
            for k in kernels:
                out.kernels[k.name] = k
                out.kernel_calls[k.name] = (out.kernel_calls.get(k.name, 0)
                                            + calls[k.name])
            return True
    return False


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device ops that took most time and the longest idle time by
    what the host was in, [name, seconds] each."""
    def best(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": best(tr.ops), "idle_gaps": best(tr.gaps)}


# The per-layer metrics' readers: each ``metrics/<name>.py`` binds one of
# these as its ``read``.  A reader that finds nothing to read returns
# None.

def push_ms_p50(tr: Trace):
    """Median host wall of one ``MultichannelReceiver.push`` call, ms,
    from the benchmark's span around it (pushes outside the profiled
    sub-windows)."""
    walls = tr.host.get("push")
    return statistics.median(walls) * 1e3 if walls else None


def report_p95_ms(tr: Trace):
    """95th percentile of the report latency, ms, over the bursts of the
    traced run that no profiled push completed or returned."""
    import numpy as np
    lat = tr.host.get("report")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None


def torch_ops_ms(tr: Trace):
    """Device time a unit (push or block) of every op but the bank
    kernels (``BANK_KERNEL``): the RX back end's torch ops, copies and
    fills, K5 (the trigger search) included, ms."""
    if not tr.units:
        return None
    bank, _ = tr.op_seconds(BANK_KERNEL)
    return (sum(tr.ops.values()) - bank) / tr.units * 1e3


def backend_gemm_ms(tr: Trace):
    """Device time a unit of the cuBLAS GEMMs (the back end's trigger
    search, energy and syndrome products), ms."""
    s, n = tr.op_seconds(GEMM)
    return s / tr.units * 1e3 if n and tr.units else None


def _share(tr: Trace, pick: Callable[[Kernel], bool]):
    """The share of their roofline, %, of the wrappers of the trace that
    ``pick`` takes: their calls' least time over the device time of
    every kernel of their patterns."""
    ks = [k for k in tr.kernels.values() if pick(k)]
    least = sum(tr.kernel_calls.get(k.name, 0) * k.bound_s for k in ks)
    s = sum(tr.op_seconds(p)[0] for p in {k.pattern for k in ks})
    return 100.0 * least / s if least > 0 and s > 0 else None


def k2_roofline(tr: Trace):
    """K2's share of its roofline on the FFT tile, %: the least time of
    its calls (the bank pass's FFT and fold flops against the FP32 peak,
    or its interface bytes against HBM, ``roofline.bank_bound_s``) over
    the profiled device time of its kernels; None on the route."""
    return _share(tr, lambda k: k.name == "k2" and k.path == "tile")


def k4_roofline(tr: Trace):
    """K4's share of its roofline on the FFT tile, %, as
    ``k2_roofline``'s: past 16 taps a call is several launches and the
    combine kernel, all of them counted."""
    return _share(tr, lambda k: k.name == "k4" and k.path == "tile")


def route_roofline(tr: Trace):
    """The device-memory route's share of its roofline, %: the least
    time of the K2 and K4 calls that took the route over the profiled
    device time of every ``route_*`` kernel (``route_pass_kernel`` serves
    both wrappers, so the trace cannot part them)."""
    return _share(tr, lambda k: k.path == "route")


def k5_roofline(tr: Trace):
    """K5's share of its roofline, %: the least time of its calls (the
    trigger search's adds at the FP32 instruction rate, or its bytes,
    ``roofline.search_bound_s``) over their profiled device time."""
    return _share(tr, lambda k: k.name == "k5")


def device_idle_pct(tr: Trace):
    """Share of the profiled sub-windows in which no operation ran on
    the device, %."""
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
