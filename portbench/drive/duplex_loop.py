"""The ``duplex_loop`` kind: the station's fused full-duplex loop,
``make_closed_loop_stream`` (on the card one block captured as a CUDA
graph and replayed), called back to back, each call ``nblocks`` blocks
of ``frames`` FOCC frames with a fresh set of word pairs from the pool.

The loop is built with the benchmark's own ``synthesize`` and
``front_end``: each calls the port's wrapper (K4, K2) and copies a tap of
its output into a buffer of the benchmark, in every run, traced or not,
so the graph that is timed is the graph that is checked.  The taps: the
wideband samples of ``tap_hops`` hops of each block from a hop drawn
from the seed, and the demod rows of ``tap_channels`` channels drawn from
the seed; after the window they hold the last block's.

* ``duplex_msps``: samples of forward band synthesized and received
  back, blocks × block samples, over the window's length (it ends when
  the last call's sums are on the host).

The loop's back end is tapped the same way: the benchmark wraps the
port's ``closed_loop_block`` (the body the graph captures) so that each
block also copies its input's carried demod rows and its output slots
(starts, quality, valid, word_ok, words of every channel) into buffers
of the benchmark.

What is compared, once the window has closed and the loop is gone, all
of the last block of the last call (a steady block: every block past
the second of a call repeats the one before it):

* ``synth_err``: the tapped band against the reference's synthesis of
  the call's frames, relative RMS;
* ``demod_err``: the tapped demod rows against the reference's
  analysis and discriminator of that band, power-weighted RMS in rad
  over the samples whose arctangent branch no rounding decides;
* ``carry_err``: the same of the carried demod overlap the block read
  (the block before's demod);
* ``pick_gap``, ``quality_err``, ``slot_diff``: every channel's slots
  against the reference back end on the steady window, at the slots'
  own starts (``backend.judge``): in a periodic band an offset and the
  same offset a block later tie, and which of them the loop takes
  follows the rounding of its blocked correlation.

With ``control`` the same numbers are also read of the control: the
reference put in the program's place, its front end in bfloat16 and
its back end in float8 (e4m3), the precisions below the configuration's.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import gen, kernels, trace
from portbench.drive.rx_stream import make_spec, plane_errors
from portbench.reference import backend, bank, focc

NUMBERS = ("synth_err", "demod_err", "carry_err", "pick_gap",
           "quality_err", "slot_diff")
SLOTS = ("starts", "quality", "valid", "word_ok", "words")


class Taps:
    """The benchmark's synthesize, front end and block: the port's, and
    a copy of part of each output into buffers of the benchmark."""

    def __init__(self, M: int, n_hops: int, carry_hops: int, hop0: int,
                 hops: int, rows, device):
        from amps_tpu_torch.kernels import rx_front, synth
        self._synth, self._front = synth.synthesize_block, \
            rx_front.analyze_demod
        P = M // 2
        self.a, self.b = hop0 * P, (hop0 + hops) * P
        self.rows = torch.as_tensor(rows, dtype=torch.int64, device=device)
        self.x = torch.zeros((self.b - self.a, 2), device=device)
        self.d = torch.zeros((len(rows), n_hops), device=device)
        self.c = torch.zeros((len(rows), carry_hops), device=device)
        self.slots = None
        self._block = None

    def synthesize(self, Y, M, T, parity, carry):
        x, tail = self._synth(Y, M, T, parity, carry)
        self.x.copy_(x[self.a:self.b])
        return x, tail

    def front_end(self, x_ext, M, T, parity, prev):
        d, last, pw = self._front(x_ext, M, T, parity, prev)
        torch.index_select(d, 0, self.rows, out=self.d)
        return d, last, pw

    def block(self, Y, st, *a, **k):
        torch.index_select(st["carry"], 0, self.rows, out=self.c)
        st2, pl = self._block(Y, st, *a, **k)
        if self.slots is None:          # the first block runs eagerly
            self.slots = {n: pl[n].clone() for n in SLOTS}
        else:
            for n in SLOTS:
                self.slots[n].copy_(pl[n])
        return st2, pl

    def install(self):
        from amps_tpu_torch.runtime import streamer
        self._block = streamer.closed_loop_block
        streamer.closed_loop_block = self.block

    def remove(self):
        from amps_tpu_torch.runtime import streamer
        streamer.closed_loop_block = self._block


def setup(cfg: dict, mix: dict, seed: int, device):
    """(spec, pairs, taps, run, block samples): the loop built on the
    taps (installed), its graph captured and replayed on the pool's
    pairs."""
    from amps_tpu_torch.runtime.streamer import (closed_loop_geometry,
                                                 make_closed_loop_stream)
    spec = make_spec(cfg)
    M = spec.num_channels
    pairs = gen.duplex_pairs(M, mix, seed)
    n_hops, _, carry_hops = closed_loop_geometry(spec, mix["frames"])
    rng = np.random.default_rng(seed)
    hop0 = int(rng.integers(0, n_hops - mix["tap_hops"] + 1))
    rows = np.sort(rng.choice(M, min(M, mix["tap_channels"]), replace=False))
    taps = Taps(M, n_hops, carry_hops, hop0, mix["tap_hops"], rows, device)
    taps.install()
    run, block_samples = make_closed_loop_stream(
        spec, mix["nblocks"], mix["frames"], cfg["loop"]["max_bursts"],
        cfg["loop"]["threshold"], device=device, graph=True,
        synthesize=taps.synthesize, front_end=taps.front_end)
    t0 = time.perf_counter()
    for k in range(mix["warmup_calls"]):
        [v.item() for v in run(pairs[k % len(pairs)])]
    print(f"setup: capture and warm-up {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    return spec, pairs, taps, run, block_samples


def window(run, pairs, mix, seconds: float, device, traced: bool,
           calls: int = 0, wrappers=()):
    """Call the loop until ``seconds`` have passed (or ``calls`` calls);
    returns the record and, when ``traced``, the trace, whose sub-windows
    are checked against ``wrappers`` (``portbench.kernels.loop``)."""
    from torch.profiler import record_function
    sums, tr = [], trace.Trace() if traced else None
    walls = []

    def call(c):
        t = time.perf_counter()
        if traced:
            with record_function("portbench.call"):
                s = run(pairs[c % len(pairs)])
        else:
            s = run(pairs[c % len(pairs)])
        sums.append((c % len(pairs), *(v.item() for v in s)))
        walls.append(time.perf_counter() - t)

    marks = [(f * seconds, f == 0.4) for f in (0.2, 0.4, 0.6, 0.8)] \
        if traced else []
    t0 = time.perf_counter()
    c = 0
    profiled = set()
    while True:
        if marks and c >= 1 and time.perf_counter() - t0 >= marks[0][0]:
            labels = marks.pop(0)[1]

            def units(n):
                nonlocal c
                for _ in range(n):
                    profiled.add(c)
                    call(c)
                    c += 1

            if not trace.profile(units, mix["profile_calls"], device,
                                 wrappers, tr, labels):
                print(f"call {c - 1}: the profiler missed spans in "
                      f"{trace.TRIES} tries; sub-window left out",
                      file=sys.stderr)
        else:
            call(c)
            c += 1
        if (c >= calls) if calls else \
                (time.perf_counter() - t0 >= seconds and not marks):
            break
    t1 = time.perf_counter()
    if traced:
        if not tr.units:
            raise RuntimeError("no profiled sub-window recorded every span")
        tr.host["call"] = [w for k, w in enumerate(walls)
                           if k not in profiled]
        tr.units *= mix["nblocks"]
    return dict(calls=c, t0=t0, t1=t1, sums=sums), tr


def band(spec, pairs_one, hops0: int, hops1: int, device,
         precision: str = "f64"):
    """The loop's steady band over block hops hops0 .. hops1-1
    (complex128 hop blocks, (n, P)), periodic in the block, synthesized
    by the reference from the call's pairs; ``precision`` as
    ``bank.synthesize``'s."""
    M, T, P = spec.num_channels, spec.taps_per_phase, spec.num_channels // 2
    Y = torch.as_tensor(focc.baseband(pairs_one, spec.chan_sps,
                                      spec.fm_sensitivity),
                        device=device).t()                   # (n_hops, M)
    n_hops = Y.shape[0]
    j = torch.arange(hops0 - (2 * T - 1), hops1, device=device)
    rows = Y[torch.remainder(j, n_hops)]
    x = P * bank.synthesize(rows, M, T, hops0 % 2, precision)
    return x.reshape(hops1 - hops0, P)


def demod(spec, pairs_one, device, precision: str = "f64"):
    """The reference's demod, power and settled samples
    (``bank.discriminate``) of a steady block, every channel;
    ``precision="bf16"`` synthesizes and analyzes in bfloat16."""
    M, T = spec.num_channels, spec.taps_per_phase
    n_hops = pairs_one.shape[-3] * 463 * 2 * spec.chan_sps
    lo = -2 * T
    x = band(spec, pairs_one, lo, n_hops, device, precision)

    def blocks(b0, b1):
        return x[b0 - lo: b1 - lo]

    y = bank.analyze(blocks, M, T, -1, n_hops, device=device,
                     precision=precision)
    d, pw, keep = bank.discriminate(y[:, 1:], y[:, 0], settled=True)
    if precision == "bf16":
        d = d.to(torch.bfloat16).to(torch.float64)
    return d, pw, keep


def judge(spec, cfg, last, got: dict, device, control: bool) -> dict:
    """The numbers compared, of the program's taps ``got`` (x, d, c,
    rows, a, b, slots) against the reference of the call's pairs
    ``last``; with ``control`` also the control's, and the words the
    reference's own picks decode, under ``"control"`` and ``"info"``."""
    P, sps = spec.num_channels // 2, spec.chan_sps
    loop = cfg["loop"]
    x_ref = band(spec, last, got["a"], got["b"], device).reshape(-1)
    d_all, pw_all, keep_all = demod(spec, last, device)
    rows = got["rows"]
    d_ref, pw_ref, keep = d_all[rows], pw_all[rows], keep_all[rows]
    del pw_all
    nc = got["c"].shape[-1]

    def window(d):
        return torch.cat([d[:, d.shape[-1] - nc:], d], -1)

    keep_win = window(keep_all)

    def readings(x, d, c, slots):
        return {"synth_err": float((x - x_ref).norm() / x_ref.norm()),
                "demod_err": plane_errors(d, pw_ref, d_ref, pw_ref,
                                          keep)[0],
                "carry_err": plane_errors(
                    c, pw_ref[:, -nc:], d_ref[:, -nc:], pw_ref[:, -nc:],
                    keep[:, -nc:])[0],
                **backend.judge(window(d_all), slots, sps, spec.io_bf16,
                                spec.corr_bf16, loop["threshold"],
                                keep_win)}

    xp = torch.complex(got["x"][:, 0].double(), got["x"][:, 1].double())
    nums = readings(xp, got["d"].to(torch.float64),
                    got["c"].to(torch.float64), got["slots"])
    info = {k: nums.pop(k) for k in ("words_at_picks",
                                     "slots_rounding_decides", "diff_at")}
    # the widest demod error of a settled tapped sample, against which
    # backend.DEMOD_TOL is set
    e = torch.remainder(got["d"].to(torch.float64) - d_ref + np.pi,
                        2 * np.pi) - np.pi
    info["demod_widest"] = float((e.abs() * keep).max())
    if not control:
        return dict(numbers=nums, info=info)
    own = backend.receive(window(d_all), sps, spec.io_bf16, spec.corr_bf16,
                          loop["max_bursts"], loop["threshold"])
    info["words_reference_picks"] = int(own["word_ok"].sum())
    del own
    x_low = band(spec, last, got["a"], got["b"], device, "bf16").reshape(-1)
    d_low = demod(spec, last, device, "bf16")[0]
    fp8 = torch.float8_e4m3fn
    slots_low = backend.receive(
        window(d_low), sps, fp8 if spec.io_bf16 else True,
        fp8 if spec.corr_bf16 else True, loop["max_bursts"],
        loop["threshold"])
    ctl = readings(x_low, d_low[rows], d_low[rows][:, -nc:], slots_low)
    ctl.pop("words_at_picks")
    ctl.pop("diff_at")
    info["control_slots_rounding_decides"] = ctl.pop(
        "slots_rounding_decides")
    return dict(numbers=nums, info=info, control=ctl)


def run(cfg: dict, mix: dict, seed: int, seconds: float, device,
        traced: bool, t_start: float, calls: int = 0,
        control: bool = False) -> dict:
    """One run of a ``duplex_loop`` cell; with ``control`` the control's
    readings of the same window beside the program's."""
    spec, pairs, taps, loop, block_samples = setup(cfg, mix, seed, device)
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        rec, tr = window(loop, pairs, mix, seconds, device, traced, calls,
                         kernels.loop(spec, mix["frames"],
                                      cfg["loop"]["max_bursts"]))
    finally:
        taps.remove()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    got = dict(x=taps.x.clone(), d=taps.d.clone(), c=taps.c.clone(),
               rows=taps.rows, slots={k: v.clone()
                                      for k, v in taps.slots.items()})
    P = spec.num_channels // 2
    got["a"], got["b"] = taps.a // P, taps.b // P
    del loop, taps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = judge(spec, cfg, pairs[rec["sums"][-1][0]], got, device,
                control)
    length = rec["t1"] - rec["t0"]
    metrics = {"duplex_msps": rec["calls"] * mix["nblocks"] * block_samples
               / length / 1e6, "setup_s": setup_s}
    return dict(metrics=metrics, attempted=rec["calls"],
                failed=int(out["numbers"]["slot_diff"] > 0),
                memory_peak_bytes=peak, trace=tr, units=rec["calls"], **out)
