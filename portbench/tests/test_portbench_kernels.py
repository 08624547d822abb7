"""The table of the port's kernels (``portbench.kernels``): the path,
pattern and launches of each wrapper by width and taps, the span check
on synthetic profiles of a call, the shares by calls on synthetic
traces, and the build by path."""

import contextlib
import json
import types

import pytest
import torch

from portbench import kernels, roofline, run, trace
from portbench.drive.rx_stream import make_spec

# (M, the path K2 and K4 take there)
WIDTHS = [(1024, "tile"), (16384, "tile"), (16382, "tile"),
          (32766, "route")]
LOOP_HOPS = 5556                 # a loop block of 2 FOCC frames at sps 3
K5 = "void trigger_search_kernel<true, true>(Search)"


def spec_at(M, T=8):
    cfg = json.loads((run.HERE / "configs" / "wide16384.json").read_text())
    return make_spec(dict(cfg, num_channels=M, taps_per_phase=T))


@pytest.mark.parametrize("T", [8, 32])
@pytest.mark.parametrize("M,path", WIDTHS)
def test_bank_entries_by_width_and_taps(M, path, T):
    from amps_tpu_torch.kernels import route
    k2, k4 = kernels.bank(M, T, LOOP_HOPS)
    assert (k2.name, k4.name) == ("k2", "k4")
    assert k2.path == k4.path == path
    assert (k2.module, k4.module) == ("rx_front", "synth")
    assert k2.bound_s == roofline.bank_bound_s(
        M, T, LOOP_HOPS, roofline.rx_front_bytes(M, T, LOOP_HOPS))
    assert k4.bound_s == roofline.bank_bound_s(
        M, T, LOOP_HOPS, roofline.synth_bytes(M, T, LOOP_HOPS))
    if path == "route":
        assert k2.pattern == k4.pattern == kernels.ROUTE
        assert k2.launches == route.launches(M, LOOP_HOPS, 1) == 36
        assert k4.launches == route.launches(M, LOOP_HOPS, 0) == 36
        assert k2.step == k4.step == 1
    else:
        assert (k2.pattern, k2.launches, k2.step) == (kernels.TILE["k2"],
                                                      1, 1)
        # past 16 taps: two chunks and the combine kernel, counted two
        assert k4.pattern == kernels.TILE["k4"]
        assert (k4.launches, k4.step) == ((1, 1) if T == 8 else (3, 2))


@pytest.mark.parametrize("M,path", WIDTHS)
def test_loop_entries(M, path):
    k4, k2, k5 = kernels.loop(spec_at(M), 2, 2)
    assert (k4.name, k2.name, k5.name) == ("k4", "k2", "k5")
    assert k2.path == path and k4.path == path
    # the carried overlap (a whole block) and the block: 3703 symbols
    assert k5 == kernels.search(M, 3, 3703, 2)
    assert (k5.pattern, k5.launches, k5.module) == (
        kernels.SEARCH, 1, "trigger_search")
    assert k5.bound_s == roofline.search_bound_s(M, 3, 3703, 2)


def test_search_bound_is_the_loops():
    # 74 adds a lag and 4 a symbol at 33.5 T/s, as chip_smoke's phase 36
    # states it
    assert kernels.search(16384, 3, 3703, 2).bound_s == pytest.approx(
        0.4159e-3, abs=5e-8)
    assert kernels.search(1024, 3, 3703, 2).bound_s == pytest.approx(
        0.0260e-3, abs=5e-8)
    ops, nbytes = roofline.search_work(1024, 3, 8909, 4)
    assert ops == 1024 * 3 * ((8909 - 73) * 74 + 8909 * 4)
    assert nbytes == 1024 * 3 * 8909 * 2 + 1024 * 4 * 9


def test_receiver_entries():
    spec = spec_at(1024)
    k2, k5 = kernels.receiver(spec, 8192, 10344, 4)
    assert k2 == kernels.bank(1024, 8, 8192)[0]
    assert k5 == kernels.search(1024, 3, 6178, 4)


class Ev:
    """A stand-in for the profiler's FunctionEvent (times in us)."""

    def __init__(self, name, a, b, cuda=True):
        from torch.autograd import DeviceType
        self.name = name
        self.time_range = types.SimpleNamespace(start=a, end=b)
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.is_user_annotation = False


def route_call(drop=0):
    """The device spans of one loop block at M=32766 on the route: K4's
    6 chunks (load, 4 passes, out), K2's 6 (fold, 4 passes, out), K5,
    between the two markers; ``drop`` spans of K2's passes left out."""
    names = []
    for first, last in (("route_load_kernel", "route_synth_out"),
                        ("route_fold_kernel", "route_front_out")):
        for _ in range(6):
            names += [f"void {first}(float2 const*)"]
            names += ["void route_pass_kernel<256>(float2 const*)"] * 4
            names += [f"void {last}(float2 const*)"]
    names.append(K5)
    for _ in range(drop):
        names.remove("void route_pass_kernel<256>(float2 const*)")
    evs = [Ev("void at::cuda::spin_kernel(long)", 0, 1)]
    evs += [Ev(n, 10 + 10 * i, 15 + 10 * i) for i, n in enumerate(names)]
    end = 20 + 10 * len(names)
    evs.append(Ev("void at::cuda::spin_kernel(long)", end, end + 1))
    return types.SimpleNamespace(events=lambda: evs)


def loop_entries(M):
    return kernels.loop(spec_at(M), 2, 2)


def test_span_check_on_a_route_call():
    wrappers = loop_entries(32766)
    calls = {"k2": 1, "k4": 1, "k5": 1}
    counts = trace._digest(route_call(), trace.Trace(), False)
    assert trace.missing(counts, wrappers, calls) == {}
    counts = trace._digest(route_call(drop=1), trace.Trace(), False)
    assert trace.missing(counts, wrappers, calls) == {
        kernels.ROUTE: (71, 72)}
    # K5's spans are checked too
    counts.pop(K5)
    counts["void route_pass_kernel<256>(float2 const*)"] += 1
    assert trace.missing(counts, wrappers, calls) == {
        kernels.SEARCH: (0, 1)}


def test_span_check_counts_k4_chunks_and_combine():
    k2, k4 = kernels.bank(1024, 32, LOOP_HOPS)
    counts = {"void synth_kernel<1024, 16, false>(float2 const*)": 2,
              "void synth_combine_kernel(float2 const*)": 1,
              "void rx_front_kernel<1024, 32>(float const*)": 1}
    calls = {"k2": 1, "k4": 1}
    assert trace.missing(counts, [k2, k4], calls) == {}
    counts["void synth_combine_kernel(float2 const*)"] = 0
    assert trace.missing(counts, [k2, k4], calls) == {
        kernels.TILE["k4"]: (2, 3)}


def test_profile_retakes_a_short_sub_window(monkeypatch):
    # trace.profile on the CPU: the profiler, the markers and the
    # synchronisation stubbed; the first try drops one span and is taken
    # again, the second is kept with the calls the counters saw
    from amps_tpu_torch.kernels import rx_front, synth, trigger_search
    tries = iter([route_call(drop=1), route_call()])

    @contextlib.contextmanager
    def fake_profile(activities):
        yield next(tries)

    monkeypatch.setattr(torch.profiler, "profile", fake_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a: None)

    def units(n):
        for _ in range(n):
            rx_front.LAUNCHES += 1
            synth.LAUNCHES += 1
            trigger_search.LAUNCHES += 1

    for mod in (rx_front, synth, trigger_search):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    tr = trace.Trace()
    assert trace.profile(units, 1, torch.device("cpu"),
                         loop_entries(32766), tr)
    assert tr.tries == 2 and tr.units == 1
    assert tr.kernel_calls == {"k2": 1, "k4": 1, "k5": 1}
    assert set(tr.kernels) == {"k2", "k4", "k5"}
    # every try short: the sub-window is left out
    tries = iter([route_call(drop=1)] * trace.TRIES)
    tr = trace.Trace()
    assert not trace.profile(units, 1, torch.device("cpu"),
                             loop_entries(32766), tr)
    assert tr.tries == trace.TRIES and tr.units == 0
    assert tr.kernel_calls == {}


def synthetic(entries, calls, ops):
    """A trace of the kept sub-windows: the wrappers ``entries``, their
    calls, and op name -> (device seconds, spans)."""
    tr = trace.Trace(units=1)
    for k in entries:
        tr.kernels[k.name] = k
        tr.kernel_calls[k.name] = calls[k.name]
    for name, (s, n) in ops.items():
        tr.ops[name], tr.calls[name] = s, n
    return tr


def parent_roofline(tr, kernel, bound):
    """The readers before the table: each span of the kernel credited
    with one call's least time."""
    s, n = tr.op_seconds(rf"\b{kernel}")
    return 100.0 * n * bound / s if n and s > 0 and bound else None


@pytest.mark.parametrize("M", [1024, 16384])
def test_tile_shares_at_8_taps_read_as_before(M):
    k4, k2, k5 = loop_entries(M)
    tr = synthetic([k4, k2, k5], {"k2": 32, "k4": 32, "k5": 32}, {
        f"void rx_front_kernel<{M}, 8>(float const*)": (2.1e-3, 32),
        f"void synth_kernel<{M}, 8, true>(float2 const*)": (4.3e-3, 32),
        K5: (2.3e-3, 32),
        "aten::sum": (1e-3, 64)})
    assert trace.k2_roofline(tr) == parent_roofline(
        tr, "rx_front_kernel", k2.bound_s)
    assert trace.k4_roofline(tr) == parent_roofline(
        tr, "synth_kernel", k4.bound_s)
    assert trace.route_roofline(tr) is None


def test_k4_share_at_32_taps_counts_calls_and_the_combine():
    k2, k4 = kernels.bank(1024, 32, LOOP_HOPS)
    # 4 calls: 8 chunk launches of 25 us and 4 combines of 5 us
    tr = synthetic([k2, k4], {"k2": 4, "k4": 4}, {
        "void synth_kernel<1024, 16, false>(float2 const*)": (200e-6, 8),
        "void synth_combine_kernel(float2 const*)": (20e-6, 4)})
    assert trace.k4_roofline(tr) == pytest.approx(
        100 * 4 * k4.bound_s / 220e-6)
    # the reader before the table credited each chunk with a whole call
    # and left out the combine: more than twice as high
    assert parent_roofline(tr, "synth_kernel", k4.bound_s) == \
        pytest.approx(2.2 * trace.k4_roofline(tr))
    assert trace.k2_roofline(tr) is None          # no K2 span


def test_route_share_and_none_for_the_tile_readers():
    k4, k2, k5 = loop_entries(32766)
    tr = synthetic([k4, k2, k5], {"k2": 32, "k4": 32, "k5": 32}, {
        "void route_pass_kernel<256>(float2 const*)": (2.0, 32 * 48),
        "void route_fold_kernel(float const*)": (0.2, 32 * 6),
        "void route_load_kernel(float2 const*)": (0.2, 32 * 6),
        "void route_front_out(float2 const*)": (0.1, 32 * 6),
        "void route_synth_out(float2 const*)": (0.1, 32 * 6),
        K5: (0.08, 32)})
    assert trace.route_roofline(tr) == pytest.approx(
        100 * 32 * (k2.bound_s + k4.bound_s) / 2.6)
    assert trace.k2_roofline(tr) is None
    assert trace.k4_roofline(tr) is None
    assert trace.k5_roofline(tr) == pytest.approx(
        100 * 32 * k5.bound_s / 0.08)


@pytest.mark.parametrize("family", ["duplex", "duplex_host"])
def test_k5_readers(family):
    k4, k2, k5 = loop_entries(16384)
    tr = synthetic([k4, k2, k5], {"k2": 3, "k4": 3, "k5": 3},
                   {K5: (3 * 2.4e-3, 3)})
    assert run.read_metric(f"k5_roofline.{family}", tr) == pytest.approx(
        100 * k5.bound_s / 2.4e-3)
    # no K5 span, or no K5 call, reads nothing
    tr.ops.pop(K5)
    assert run.read_metric(f"k5_roofline.{family}", tr) is None
    tr = synthetic([k5], {"k5": 0}, {K5: (1e-3, 1)})
    assert run.read_metric(f"k5_roofline.{family}", tr) is None


def test_torch_ops_keeps_k5_and_leaves_the_bank_kernels_out():
    tr = synthetic([], {}, {
        "void rx_front_kernel<1024, 8>(float const*)": (1.0, 1),
        "void route_pass_kernel<256>(float2 const*)": (2.0, 1),
        "void synth_combine_kernel(float2 const*)": (4.0, 1),
        K5: (8.0, 1), "aten::sum": (16.0, 1)})
    assert trace.torch_ops_ms(tr) == pytest.approx(24e3)


@pytest.mark.parametrize("M,widths", [(1024, ()), (16384, (16384,)),
                                      (16382, (16382,)), (32766, ())])
def test_build_follows_the_path(M, widths, monkeypatch):
    from amps_tpu_torch.kernels import build
    asked = []
    monkeypatch.setattr(build, "build",
                        lambda widths=(): asked.append(tuple(widths)))
    run.build_kernels(M)
    assert asked == [widths]
