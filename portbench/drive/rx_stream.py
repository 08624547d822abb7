"""The ``rx_stream`` kind: the station's streaming receiver,
``MultichannelReceiver.push``, fed back to back from the traffic pool
(a radio ring that is never empty), and what it reports held against
the plain reference.

Set-up builds the pool on the device and warms every shape of the
window on a receiver of its own.  The window pushes ``push_hops`` hops a
call on a fresh receiver until ``seconds`` have passed, then flushes;
it ends when the last push's reports are on the host.

* ``rx_msps``: wideband samples pushed over the window's length.
* ``report_p95_ms``: over every planted burst due in the window, from
  the call of the push whose block completes its trigger and capture
  (the first push whose window holds the whole capture) to the return
  of the call that hands over its report.

What is compared, once the window has closed and the receiver is gone:

* every burst due in the window (each pool burst in each cycle whose
  capture completes by the last push), as the reference receives it
  from the pool, against the port's reports, matched by channel and
  absolute symbol: ``missed`` (due and not reported), ``wrong``
  (reported with another word_ok, DCC, or words where decoded),
  ``extra`` (reported and not due);
* the front end, on the demod and power overlap the receiver carries
  after the window (every channel, the last 10,344 hops):
  ``demod_err``, the power-weighted RMS of the wrapped demod error in
  rad over the samples whose branch of the stated arctangent no
  rounding decides (``bank.BRANCH_MARGIN``), and ``power_err``, the
  relative RMS error of the power series.
"""

from __future__ import annotations

import gc
import sys
import math
import time

import numpy as np
import torch

from portbench import gen, kernels, trace
from portbench.reference import bank, recc


NUMBERS = ("missed", "extra", "wrong", "demod_err", "power_err")


def make_spec(cfg: dict):
    from amps_tpu_torch.parallel.pipeline import MultichannelSpec
    spec = MultichannelSpec(num_channels=cfg["num_channels"],
                            taps_per_phase=cfg["taps_per_phase"],
                            fold=cfg["fold"], io_bf16=cfg["io_bf16"],
                            corr_bf16=cfg["corr_bf16"])
    sens = 2 * np.pi * cfg["deviation_hz"] / cfg["chan_rate"]
    if spec.chan_sps != cfg["chan_sps"] or \
            not math.isclose(spec.fm_sensitivity, sens, rel_tol=1e-12):
        raise ValueError("the port's channel rate or deviation differs "
                         "from the configuration's")
    return spec


def make_receiver(spec, cfg: dict, device):
    from amps_tpu_torch.runtime.streamer import MultichannelReceiver
    r = cfg["receiver"]
    return MultichannelReceiver(
        spec, pipeline_depth=r["pipeline_depth"], threshold=r["threshold"],
        min_rssi=r["min_rssi"], max_bursts=r["max_bursts"],
        policy=r["policy"], device=device)


def setup(cfg: dict, mix: dict, seed: int, device):
    """(spec, pool): the pool made and every shape of the window warmed
    up on a receiver of its own."""
    t0 = time.perf_counter()
    spec = make_spec(cfg)
    pool = gen.rx_stream(cfg, mix, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    rx = make_receiver(spec, cfg, device)
    for i in range(mix["warmup_pushes"]):
        rx.push(pool.block(i))
    rx.flush()
    del rx
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"setup: traffic pool {t1 - t0:.3f} s, warm-up "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    return spec, pool


def window(spec, pool, cfg, mix, seconds: float, device, traced: bool,
           pushes: int = 0):
    """Drive the receiver; returns the record of the window, the final
    carried demod and power planes and, when ``traced``, the trace of
    its profiled sub-windows."""
    from torch.profiler import record_function
    rx = make_receiver(spec, cfg, device)
    wrappers = kernels.receiver(spec, pool.push_hops, rx.ovr,
                                rx.max_bursts)
    calls, rets, got = [], [], []
    tr = trace.Trace() if traced else None
    profiled = set()

    def push(i):
        tc = time.perf_counter()
        if traced:
            with record_function("portbench.push"):
                out = rx.push(pool.block(i))
        else:
            out = rx.push(pool.block(i))
        rets.append(time.perf_counter())
        calls.append(tc)
        got.extend((i, r) for r in out)

    # three sub-windows for the numbers, one for the gaps' names
    marks = [(f * seconds, f == 0.4) for f in (0.2, 0.4, 0.6, 0.8)] \
        if traced else []
    t0 = time.perf_counter()
    i = 0
    while True:
        if marks and i >= 2 and time.perf_counter() - t0 >= marks[0][0]:
            labels = marks.pop(0)[1]
            first = i

            def units(n):
                nonlocal i
                for _ in range(n):
                    profiled.add(i)
                    push(i)
                    i += 1

            if not trace.profile(units, mix["profile_pushes"], device,
                                 wrappers, tr, labels):
                print(f"pushes {first}..{i - 1}: the profiler missed spans "
                      f"in {trace.TRIES} tries; sub-window left out",
                      file=sys.stderr)
        else:
            push(i)
            i += 1
        done = i >= pushes if pushes else \
            rets[-1] - t0 >= seconds and not marks
        if done:
            break
    if traced:
        with record_function("portbench.flush"):
            tail = rx.flush()
        if not tr.units:
            raise RuntimeError("no profiled sub-window recorded every span")
    else:
        tail = rx.flush()
    t1 = time.perf_counter()
    got.extend((i, r) for r in tail)
    rec = dict(n_push=i, t0=t0, t1=t1, calls=calls, rets=rets + [t1],
               got=got, ovr=rx.ovr, profiled=profiled)
    if traced:
        tr.host["push"] = [b - a for k, (a, b) in
                           enumerate(zip(calls, rets)) if k not in profiled]
    carry = (rx._carry.clone(), rx._pw_carry.clone())
    del rx
    return rec, carry, tr


def expected(pool: gen.RxPool, cfg: dict, device):
    """The reference's report of each pool burst: (burst, fields)."""
    r = cfg["receiver"]
    sps = pool.sps
    chans = sorted({b.channel for b in pool.bursts})
    row = {c: k for k, c in enumerate(chans)}
    y = bank.analyze(pool.stream_blocks(cyclic=True), pool.M, pool.T, 0,
                     pool.pool_hops, rows=chans, device=device)
    out = []
    zero = torch.zeros((), dtype=torch.complex128, device=device)
    for b in pool.bursts:
        d, pw = bank.discriminate(y[row[b.channel]], zero)
        out.append((b, recc.receive(
            d, pw, b.hop - 64, b.hop + 256, sps,
            r["threshold"], r["min_rssi"])))
    return out


def reference_carry(pool: gen.RxPool, n_push: int, ovr: int, device,
                    precision: str = "f64"):
    """The reference's demod, power and settled samples
    (``bank.discriminate``) over the last ``ovr`` hops of a stream of
    ``n_push`` pushes, every channel; ``precision="bf16"`` computes them
    in bfloat16 (the control of the float32 front end)."""
    E = n_push * pool.push_hops
    y = bank.analyze(pool.stream_blocks(cyclic=False), pool.M, pool.T,
                     E - ovr - 1, E, device=device, precision=precision)
    d, pw, keep = bank.discriminate(y[:, 1:], y[:, 0], settled=True)
    if precision == "bf16":
        d, pw = (t.to(torch.bfloat16).to(torch.float64) for t in (d, pw))
    return d, pw, keep


def plane_errors(d, pw, d_ref, pw_ref, keep):
    """(RMS of the wrapped demod error over the settled samples ``keep``,
    weighted by the reference's power, relative RMS error of the power)
    of planes against the reference's."""
    e = torch.remainder(d - d_ref + np.pi, 2 * np.pi) - np.pi
    # weighted by |z|², so that a sample near zero, whose angle any
    # rounding moves, weighs as little as its rounding error
    w = pw_ref * keep
    demod_err = float(torch.sqrt((w * e * e).sum() / w.sum()))
    power_err = float(torch.sqrt(((pw - pw_ref) ** 2).sum()
                                 / (pw_ref ** 2).sum()))
    return demod_err, power_err


def judge(pool: gen.RxPool, rec: dict, ref):
    """Match the window's reports against the reference's: (numbers,
    (latency in seconds, the push that completed the burst, the push
    that returned it) of each matched due burst, attempted, failed)."""
    H, sps = pool.push_hops, pool.sps
    span = recc.CAPTURE * sps
    port = {}
    for k, r in rec["got"]:
        port.setdefault((r.channel, r.abs_symbol), []).append((k, r))
    missed = wrong = attempted = 0
    lat = []
    seen = set()
    for b, f in ref:
        if not f["reported"]:
            continue
        c = 0
        while True:
            s = f["start"] + c * pool.pool_hops
            due = -(-(s + span) // H) - 1
            if due > rec["n_push"] - 1:
                break
            c += 1
            attempted += 1
            key = (b.channel, s // sps)
            if key not in port:
                missed += 1
                continue
            seen.add(key)
            k, r = port[key][0]
            ok = np.asarray(r.word_ok, bool)
            if (len(port[key]) > 1 or not np.array_equal(ok, f["word_ok"])
                    or r.dcc != f["dcc"]
                    or not np.array_equal(np.asarray(r.words)[ok],
                                          f["words"][ok])):
                wrong += 1
                continue
            lat.append((rec["rets"][k] - rec["calls"][due], due, k))
    extra = sum(len(v) for key, v in port.items() if key not in seen)
    nums = {"missed": missed, "extra": extra, "wrong": wrong}
    return nums, lat, attempted, missed + wrong


def run(cfg: dict, mix: dict, seed: int, seconds: float, device,
        traced: bool, t_start: float, pushes: int = 0,
        control: bool = False) -> dict:
    """One run of an ``rx_stream`` cell: the result's fields (metrics,
    numbers compared, attempted, failed, memory, trace); with
    ``control`` also the front end's readings of the control, the
    reference computed in bfloat16 put in the program's place."""
    spec, pool = setup(cfg, mix, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    rec, carry, tr = window(spec, pool, cfg, mix, seconds, device, traced,
                            pushes)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = expected(pool, cfg, device)
    nums, lat, attempted, failed = judge(pool, rec, ref)
    d, pw, keep = reference_carry(pool, rec["n_push"], rec["ovr"], device)
    nums["demod_err"], nums["power_err"] = plane_errors(
        carry[0].to(torch.float64), carry[1].to(torch.float64), d, pw, keep)
    del carry
    length = rec["t1"] - rec["t0"]
    samples = rec["n_push"] * pool.push_hops * pool.M // 2
    metrics = {"rx_msps": samples / length / 1e6,
               "report_p95_ms": (float(np.percentile([v[0] for v in lat],
                                                     95)) * 1e3
                                 if lat else None),
               "setup_s": setup_s}
    if traced:
        # the bursts that no profiled push completed or returned
        tr.host["report"] = [v[0] for v in lat
                             if not {v[1], v[2]} & rec["profiled"]]
    out = dict(metrics=metrics, numbers=nums, attempted=attempted,
               failed=failed, memory_peak_bytes=peak, trace=tr,
               units=rec["n_push"])
    if control:
        low = reference_carry(pool, rec["n_push"], rec["ovr"], device,
                              "bf16")
        out["control"] = dict(zip(("demod_err", "power_err"),
                                  plane_errors(low[0], low[1], d, pw, keep)))
    return out
