"""Each per-layer metric's arithmetic on a synthetic profiler table,
and the roofline's numbers."""

import math
import types

import pytest

from portbench import kernels, roofline, run, trace

K2 = "void rx_front_kernel<1024, 8>(float const*, int, long long)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8"
COPY = "Memcpy DtoH (Device -> Pageable)"


class Ev:
    """A stand-in for the profiler's FunctionEvent."""

    def __init__(self, name, a, b, cuda, user=False):
        from torch.autograd import DeviceType
        self.name = name
        self.time_range = types.SimpleNamespace(start=a, end=b)
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.is_user_annotation = user


def table():
    """One sub-window of 1000 us (times in us) between the markers at
    0-1 and 999-1000: K2 100-250, a GEMM 300-700, a copy 650-800
    (overlapping the GEMM), idle 1-100, 250-300 and 800-999; the host in
    a push with aten::cat open at 1, aten::mm at 250 and in the flush
    with aten::item from 800."""
    return types.SimpleNamespace(events=lambda: [
        Ev("void at::cuda::spin_kernel(long)", 0, 1, True),
        Ev("void at::cuda::spin_kernel(long)", 999, 1000, True),
        Ev(trace.WINDOW, 0, 1000, False, True),
        Ev("portbench.push", 0, 790, False, True),
        Ev("portbench.flush", 790, 1000, False, True),
        Ev("aten::cat", 0, 90, False),
        Ev("aten::mm", 240, 320, False),
        Ev("aten::item", 795, 1000, False),
        Ev(K2, 100, 250, True),
        Ev(GEMM, 300, 700, True),
        Ev(COPY, 650, 800, True),
    ])


def traced(units=2):
    tr = trace.Trace()
    trace._digest(table(), tr, False)
    trace._digest(table(), tr, True)
    tr.units = units
    tr.host["push"] = [0.004, 0.002, 0.003]
    tr.host["report"] = [0.001 * k for k in range(1, 101)]
    tr.kernels["k2"] = kernels.Kernel("k2", "tile", kernels.TILE["k2"], 1,
                                      30e-6, "rx_front")
    tr.kernel_calls["k2"] = 1
    return tr


def test_digest_busy_window_and_gaps():
    tr = traced()
    assert math.isclose(tr.window_s, 1e-3)
    assert math.isclose(tr.busy_s, (150 + 500) * 1e-6)
    assert math.isclose(tr.gaps["push: aten::cat"], 99e-6)
    assert math.isclose(tr.gaps["push: aten::mm"], 50e-6)
    assert math.isclose(tr.gaps["flush: aten::item"], 199e-6)
    assert sum(tr.calls.values()) == 3
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0][0] == GEMM[:120]
    assert bd["idle_gaps"][0] == ["flush: aten::item", pytest.approx(1.99e-4)]


@pytest.mark.parametrize("family", ["duplex", "duplex_host"])
@pytest.mark.parametrize("name,value", [
    ("torch_ops_ms", (400 + 150) * 1e-3 / 2),
    ("backend_gemm_ms", 400 * 1e-3 / 2),
    ("k2_roofline", 100 * 30 / 150),
    ("device_idle_pct", 100 * (1 - 650 / 1000)),
])
def test_reader(name, family, value):
    assert run.read_metric(f"{name}.{family}", traced()) == \
        pytest.approx(value)


@pytest.mark.parametrize("read,value", [(trace.push_ms_p50, 3.0),
                                        (trace.report_p95_ms, 95.05)])
def test_receiver_readers(read, value):
    # the receiver cells' host-clock readers (their cells are out, §7)
    assert read(traced()) == pytest.approx(value)


def test_k4_reads_its_own_kernel():
    tr = traced()
    assert run.read_metric("k4_roofline.duplex", tr) is None
    tr.kernels["k4"] = kernels.Kernel("k4", "tile", kernels.TILE["k4"], 1,
                                      15e-6, "synth")
    tr.kernel_calls["k4"] = 2
    tr.ops["void synth_kernel<1024, 8>(float const*)"] = 60e-6
    tr.calls["void synth_kernel<1024, 8>(float const*)"] = 2
    assert run.read_metric("k4_roofline.duplex_host", tr) == \
        pytest.approx(100 * 2 * 15 / 60)


def test_no_k2_span_reads_nothing():
    tr = traced()
    tr.ops.pop(K2)
    tr.calls.pop(K2)
    assert run.read_metric("k2_roofline.duplex", tr) is None
    # nor does a trace whose sub-windows recorded no call of K2
    tr = traced()
    tr.kernel_calls["k2"] = 0
    assert run.read_metric("k2_roofline.duplex", tr) is None


def test_bank_bound_at_1024():
    nbytes = roofline.rx_front_bytes(1024, 8, 8192)
    assert nbytes == 8 * 8207 * 512 + 8 * 1024 + 8 * 1024 * 8192 + 8 * 1024
    flops = 8192 * (5 * 1024 * 10 + 4 * 8 * 1024)
    assert roofline.bank_bound_s(1024, 8, 8192, nbytes) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))
    assert roofline.bank_bound_s(1024, 8, 8192, nbytes) == pytest.approx(
        30.07e-6, rel=1e-3)
