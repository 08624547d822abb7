"""The port's host utilities: the µs-UTC logger ``amps_tpu_torch`` (the
FOCC bit-file reader warns through it, as the JAX package's does through
its own), the samples/s RateMeter against the JAX one, and ``trace`` as
a torch.profiler range."""

import logging
import time

import numpy as np
import pytest
import torch

from amps_tpu.utils import profiling as jprof
from amps_tpu_torch.tx import focc as tfocc
from amps_tpu_torch.utils import logging as tlog
from amps_tpu_torch.utils import profiling as tprof


def test_logger_formats_microsecond_utc():
    logger = tlog.get_logger()
    assert logger.name == "amps_tpu_torch"
    assert tlog.get_logger() is logger and len(logger.handlers) == 1
    fmt = logger.handlers[0].formatter
    rec = logging.LogRecord("amps_tpu_torch", logging.WARNING, __file__, 1,
                            "x", (), None)
    rec.created = 86400.25
    assert fmt.formatTime(rec) == "1970-01-02 00:00:00.250000"


def test_focc_bitfile_warning_reaches_the_port_logger(tmp_path, caplog):
    p = tmp_path / "bits.txt"
    p.write_bytes(b"0110\n1x0")
    with caplog.at_level(logging.WARNING, logger="amps_tpu_torch"):
        syms = tfocc.symbols_from_bitfile(str(p), sps=1)
    assert syms.shape == (2 * 6,)
    recs = [r for r in caplog.records if r.name == "amps_tpu_torch"]
    assert len(recs) == 1
    assert recs[0].getMessage() == \
        "symbols_from_bitfile: 2 invalid bytes skipped"


@pytest.mark.parametrize("n", [100, 4096])
def test_rate_meter_matches_jax(monkeypatch, n):
    clock = iter(np.arange(1.0, 2.0, 0.125))
    now = {"t": 0.0}

    def tick():
        now["t"] = float(next(clock))
        return now["t"]

    meters = (tprof.RateMeter("a"), jprof.RateMeter("a"))
    monkeypatch.setattr(time, "perf_counter", lambda: now["t"])
    for _ in range(4):
        tick()
        for m in meters:
            m.update(n)
    assert meters[0].total == meters[1].total == 4 * n
    assert meters[0].rate == meters[1].rate == n / 0.125
    assert tprof.meter("tx_wideband") is tprof.meter("tx_wideband")


def test_trace_is_a_profiler_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.trace("amps_section"):
            torch.ones(4).sum()
    assert "amps_section" in {e.name for e in prof.events()}
