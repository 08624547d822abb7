"""The station's certification soaks, the PyTorch counterparts of the JAX
package's ``tools/soak_*.py`` scripts, at their sizes by default.

Each family drives the ported main path at the size operators run and
returns its verdict dict; a family that misses its bar has
``ok: False``.  Families and their bars:

* ``clean`` / ``long``: random mobile accesses in a 1024-channel band
  through ``MultichannelReceiver`` (the ``rx_front`` kernel on the card),
  in 1<<22-sample pushes; every event found and bit-exact.
* ``impaired``: CFO within +-2.1 kHz, Rayleigh fading at 2-80 Hz and a
  random DCC on every burst; every event bit-exact with its DCC.
* ``chaos``: ``clean``'s band through ``ResilientReceiver`` with one
  injected receiver failure; every event bit-exact, one recovery.
* ``stream64``: 64 blocks of 2048 hops of impaired traffic, the receiver
  checkpointed to a file and resumed in a fresh receiver at block 32;
  every event exactly once, bit-exact, with its DCC.
* ``sharded``: ``ShardedReceiver`` on a 2x4 mesh (the analysis kernel on
  each worker), a block-length change mid-stream and bursts across row
  and block boundaries; exactly once, as ``stream64``.
* ``voice`` / ``sharded_voice``: a supervised call (ring, answer,
  conversation, handoff, fade, fade-timeout release) off the measured
  SAT/ST levels; the timeline exact, no other event.
* ``multicall16``: sixteen concurrent supervised calls with staggered
  lifecycles under per-channel call control; every timeline exact.

The band plane (hops, M, 2) is filled on the host from the event
basebands (impairments drawn from one ``np.random.default_rng(seed)`` in
the JAX scripts' order), uploaded once and synthesized by the plain
synthesis bank (``dsp.channelizer.synthesize``) on the band's device;
band noise comes from a ``torch.Generator`` there.

Progress and results are JSON lines (``start``, ``synthesized``,
``done``, ``verdict``) on standard output or appended to a named file.
``python -m amps_tpu_torch.eval.soak clean long ...`` runs families on
the card (``--device cpu`` on the CPU) and exits non-zero if one misses
its bar.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from amps_tpu_torch.config import SystemConfig
from amps_tpu_torch.control.station import BaseStation
from amps_tpu_torch.control.supervision import ALERTING, CONVERSATION
from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.dsp.fm import fm_modulate, fm_modulate_symbols
from amps_tpu_torch.eval import channel as chanimp
from amps_tpu_torch.eval.traffic import MobileEvent, random_events
from amps_tpu_torch.kernels import build
from amps_tpu_torch.kernels.rx_front import analyze_demod
from amps_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from amps_tpu_torch.parallel.pipeline import MultichannelSpec
from amps_tpu_torch.parallel.stream import ShardedReceiver
from amps_tpu_torch.runtime.resilient import ResilientReceiver
from amps_tpu_torch.runtime.state import (load_receiver, save_receiver,
                                          snapshot_receiver)
from amps_tpu_torch.runtime.streamer import MultichannelReceiver
from amps_tpu_torch.tx import recc_ms

BURST_HOPS = 10432            # one RECC burst at sps 3, in hops
PUSH = 1 << 22                # samples a push of the one-receiver soaks
SYNTH_CHUNK_HOPS = 16384      # hops synthesized a call (bounds the temporaries)
CFO_HZ = 2100.0               # +-2.5 ppm mobile tolerance at 835 MHz
FADE_HZ = (2.0, 80.0)         # Rayleigh Doppler: walking .. highway
SAT_AMP = ST_AMP = 0.05       # modulating units (the receiver divides by sens)
SAT_HZ, ST_HZ = 6000.0, 10000.0   # SCC 1, signalling tone
VOICE_BLOCK_HOPS = 8192       # hops a push of the voice soaks
VOICE_S, MULTICALL_S = 3.4, 4.4   # seconds of band of the call soaks
FAMILIES = ("clean", "long", "impaired", "chaos", "stream64", "sharded",
            "voice", "sharded_voice", "multicall16")


def production_spec(M: int = 1024) -> MultichannelSpec:
    """The JAX soaks' spec: the bench's production receive path."""
    return MultichannelSpec(num_channels=M, taps_per_phase=8, fold="bank",
                            io_bf16=True, corr_bf16=True)


def emitter(path: Optional[str] = None) -> Callable[..., None]:
    """``emit(**fields)``: one JSON line to standard output, or appended
    to ``path``."""
    def emit(**kw):
        line = json.dumps(kw, default=_jsonable)
        if path is None:
            print(line, flush=True)
        else:
            with open(path, "a") as f:
                f.write(line + "\n")
    return emit


def _jsonable(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))


# ---- the band ---------------------------------------------------------------

@dataclasses.dataclass
class Planted:
    """One event in the band, with the impairments it was given."""
    event: MobileEvent
    words: np.ndarray            # (n_words, 36) uint8
    dcc: int = 0
    cfo: float = 0.0
    fd: float = 0.0


def burst_basebands(events: Sequence[MobileEvent], spec: MultichannelSpec,
                    rng: Optional[np.random.Generator] = None):
    """[(Planted, riq baseband (n, 2) float32)] of each event at the
    channel rate.  With ``rng`` every burst gets, in this draw order, a
    random DCC, a CFO within +-2.1 kHz and Rayleigh fading at a random
    Doppler of 2-80 Hz (the JAX impaired soaks' order); without it DCC 0
    and no impairment."""
    fs = float(spec.pipe.chan_rate)
    out = []
    for ev in events:
        dcc = int(rng.integers(0, 4)) if rng is not None else 0
        syms = recc_ms.burst_symbols(ev.words(), dcc=dcc, sps=spec.chan_sps)
        bb, _ = fm_modulate_symbols(torch.as_tensor(syms),
                                    spec.fm_sensitivity)
        bb = bb.numpy()
        p = Planted(ev, np.stack(ev.words()), dcc)
        if rng is not None:
            p.cfo = float(rng.uniform(-CFO_HZ, CFO_HZ))
            ph = 2 * np.pi * p.cfo * np.arange(len(bb)) / fs
            c, s = np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)
            bb = np.stack([bb[:, 0] * c - bb[:, 1] * s,
                           bb[:, 0] * s + bb[:, 1] * c], -1)
            p.fd = float(rng.uniform(*FADE_HZ))
            bb = np.asarray(chanimp.apply_gain(
                bb, chanimp.rayleigh_gain(len(bb), fs, p.fd, rng)),
                np.float32)
        out.append((p, bb))
    return out


def band_plane(basebands, M: int, total_hops: int,
               add: bool = False) -> np.ndarray:
    """The (total_hops, M, 2) float32 channel plane with each baseband
    set (``add``: added) at its event's channel and start hop, cut at
    the end of the stream."""
    Y = np.zeros((total_hops, M, 2), np.float32)
    for p, bb in basebands:
        ev = p.event
        n = min(len(bb), total_hops - ev.start_hop)
        if add:
            Y[ev.start_hop: ev.start_hop + n, ev.channel] += bb[:n]
        else:
            Y[ev.start_hop: ev.start_hop + n, ev.channel] = bb[:n]
    return Y


def synthesize_band(Y: np.ndarray, spec: MultichannelSpec, device,
                    noise: float = 0.0, noise_seed: int = 0) -> torch.Tensor:
    """Wideband (hops * M/2, 2) float32 on ``device`` of the channel
    plane: each chunk of hops is uploaded once and synthesized by the
    plain synthesis bank with the carry; then white Gaussian noise of
    ``noise`` from a ``torch.Generator`` on the device seeded by
    ``noise_seed``."""
    dev = resolve_device(device)
    hops, P = Y.shape[0], spec.chz_spec.hop
    x = torch.empty((hops * P, 2), dtype=torch.float32, device=dev)
    st = chz.synthesizer_init(spec.chz_spec, device=dev)
    for h in range(0, hops, SYNTH_CHUNK_HOPS):
        yc = torch.as_tensor(Y[h: h + SYNTH_CHUNK_HOPS]).to(dev)
        xc, st = chz.synthesize(yc, spec.chz_spec, st)
        x[h * P: h * P + xc.shape[0]] = xc
        del yc, xc
    if noise > 0:
        g = torch.Generator(dev).manual_seed(noise_seed)
        x += noise * torch.randn(x.shape, generator=g, device=dev)
    return x


def band_noise(shape, sigma: float, seed: int) -> np.ndarray:
    """The noise ``synthesize_band`` adds to a band on the CPU, as a
    numpy array (the same draw: a CPU ``torch.Generator``)."""
    g = torch.Generator("cpu").manual_seed(seed)
    return (sigma * torch.randn(tuple(shape), generator=g)).numpy()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---- accounting ---------------------------------------------------------------

def _words_match(r, words: np.ndarray) -> bool:
    nw = words.shape[0]
    return bool(np.asarray(r.word_ok)[:nw].all()
                and np.array_equal(np.asarray(r.words)[:nw], words))


def nearest_exact(reports, planted: Sequence[Planted]) -> dict:
    """The one-receiver soaks' count: an event is found when its channel
    has a report, and exact when the report nearest its start decodes
    every word bit-exact (``dcc_ok``: with its DCC too)."""
    by_chan = {}
    for r in reports:
        by_chan.setdefault(r.channel, []).append(r)
    found = exact = dcc_ok = 0
    misses = []
    for p in planted:
        ev = p.event
        cands = by_chan.get(ev.channel, [])
        if not cands:
            if len(misses) < 6:
                misses.append({"kind": "NODET", "chan": int(ev.channel),
                               "cfo": round(p.cfo), "fd": round(p.fd, 1)})
            continue
        found += 1
        got = min(cands, key=lambda r: abs(r.abs_symbol - ev.start_hop // 3))
        if _words_match(got, p.words):
            exact += 1
            dcc_ok += int(got.dcc == p.dcc)
        elif len(misses) < 6:
            nw = p.words.shape[0]
            misses.append({
                "kind": ev.kind, "chan": int(ev.channel),
                "cfo": round(p.cfo), "fd": round(p.fd, 1),
                "ok": np.asarray(got.word_ok)[:nw].tolist(),
                "rows": [bool(np.array_equal(np.asarray(got.words)[i],
                                             p.words[i]))
                         for i in range(nw)],
                "q": round(float(got.quality), 3)})
    return {"found": found, "exact": exact, "dcc_ok": dcc_ok,
            "misses": misses}


def exactly_once(reports, planted: Sequence[Planted]) -> dict:
    """Exactly-once accounting by word identity (the JAX stream64 v2 and
    sharded soaks): each report is attributed to the event on its
    channel whose words it carries bit-exact, then position-checked
    within one burst length; a report that matches no event is a
    misdecode when an event of its channel is near, else a ghost."""
    burst_syms = BURST_HOPS // 3
    matched = {i: [] for i in range(len(planted))}
    ghosts, misdecodes = [], []
    for j, r in enumerate(reports):
        hit = next((i for i, p in enumerate(planted)
                    if p.event.channel == r.channel
                    and _words_match(r, p.words)
                    and abs(r.abs_symbol - p.event.start_hop // 3)
                    < burst_syms), None)
        if hit is not None:
            matched[hit].append(j)
            continue
        near = [i for i, p in enumerate(planted)
                if p.event.channel == r.channel
                and abs(r.abs_symbol - p.event.start_hop // 3) < burst_syms]
        rec = {"j": j, "chan": int(r.channel), "abs_sym": int(r.abs_symbol),
               "quality": round(float(r.quality), 3),
               "rssi": round(float(r.rssi), 3),
               "ok": np.asarray(r.word_ok).astype(int).tolist(),
               "near_event": near[0] if near else None}
        (misdecodes if near else ghosts).append(rec)
    lost = [i for i, js in matched.items() if not js]
    dups = {str(i): js for i, js in matched.items() if len(js) > 1}
    dcc_ok = sum(1 for i, js in matched.items()
                 if js and reports[js[0]].dcc == planted[i].dcc)
    return {
        "exact": sum(1 for js in matched.values() if js), "dcc_ok": dcc_ok,
        "lost": [{"i": i, "kind": planted[i].event.kind,
                  "chan": int(planted[i].event.channel),
                  "hop": int(planted[i].event.start_hop),
                  "cfo": round(planted[i].cfo), "fd": round(planted[i].fd, 1)}
                 for i in lost],
        "duplicates": dups, "misdecodes": misdecodes, "ghosts": ghosts,
        "exactly_once": not (lost or dups or misdecodes or ghosts)}


def recc_verdict(reports, planted: Sequence[Planted],
                 impaired: bool = False) -> dict:
    """The one-receiver soaks' verdict: the JAX scripts' counts, the
    exactly-once counts beside them, and ``ok``: every event found and
    bit-exact (``impaired``: with its DCC)."""
    acc = nearest_exact(reports, planted)
    once = exactly_once(reports, planted)
    n = len(planted)
    ok = acc["found"] == n and acc["exact"] == n
    if impaired:
        ok = ok and acc["dcc_ok"] == n
    return dict(n_events=n, n_reports=len(reports), found=acc["found"],
                exact=acc["exact"], dcc_ok=acc["dcc_ok"],
                exactly_once=once["exactly_once"],
                duplicates=len(once["duplicates"]), ghosts=len(once["ghosts"]),
                misdecodes=len(once["misdecodes"]), misses=acc["misses"],
                ok=ok)


def once_verdict(reports, planted: Sequence[Planted]) -> dict:
    """The exactly-once soaks' verdict: ``ok`` when every event is
    reported exactly once, bit-exact, with its DCC, and no report is a
    duplicate, ghost or misdecode."""
    once = exactly_once(reports, planted)
    return dict(n_events=len(planted), n_reports=len(reports), **once,
                ok=once["exactly_once"] and once["dcc_ok"] == len(planted))


def _stream(push, x: torch.Tensor, block: int, hop: int):
    """Push ``x`` in blocks of ``block`` samples (whole hops); returns
    (reports, samples pushed, wall s)."""
    dev = x.device
    _sync(dev)
    reports, off, n = [], 0, int(x.shape[0])
    t0 = time.perf_counter()
    while off < n:
        end = min(off + block, n)
        end -= (end - off) % hop
        if end <= off:
            break
        reports += push(x[off:end])
        off = end
    return reports, off, time.perf_counter() - t0


def _finish(emit, name: str, done: dict, ok: bool) -> dict:
    emit(event="done", family=name, **done)
    emit(event="verdict", family=name, ok=bool(ok))
    return dict(done, family=name, ok=bool(ok))


# ---- the one-receiver RECC soaks -------------------------------------------

def _recc(name: str, device, spec, total_hops, n_events, seed, noise,
          noise_seed, impaired: bool, threshold: float, min_rssi: float,
          block: int, front_end, reports, emit, resilient=None):
    dev = resolve_device(device)
    spec = spec or production_spec()
    emit = emit or emitter()
    M, P = spec.num_channels, spec.chz_spec.hop
    events = random_events(n_events, spec, total_hops, seed=seed)
    emit(event="start", family=name, device=str(dev), M=M,
         total_hops=total_hops, n_events=len(events), seed=seed,
         noise=noise, impaired=impaired, threshold=threshold,
         min_rssi=min_rssi, block=block)
    t0 = time.perf_counter()
    bbs = burst_basebands(events, spec,
                          np.random.default_rng(seed) if impaired else None)
    planted = [p for p, _ in bbs]
    x = synthesize_band(band_plane(bbs, M, total_hops), spec, dev, noise,
                        noise_seed)
    del bbs
    _sync(dev)
    emit(event="synthesized", family=name, samples=int(x.shape[0]),
         synth_s=round(time.perf_counter() - t0, 2))

    def make_rx():
        return MultichannelReceiver(spec, threshold=threshold, max_bursts=6,
                                    min_rssi=min_rssi, device=dev,
                                    front_end=front_end or analyze_demod)

    extra = {}
    if resilient is None:
        push = make_rx().push
    else:
        fail_at, checkpoint_blocks = resilient
        res = ResilientReceiver(_failing(make_rx, fail_at),
                                checkpoint_blocks=checkpoint_blocks)
        push = res.push
    got, off, dt = _stream(push, x, block, P)
    del x
    if resilient is not None:
        t1 = time.perf_counter()
        snapshot_receiver(res.rx)
        extra = {"recoveries": res.recoveries,
                 "snapshot_ms": round((time.perf_counter() - t1) * 1e3, 3)}
    if reports is not None:
        reports.extend(got)
    done = recc_verdict(got, planted, impaired)
    done.update(wall_s=round(dt, 3), samples=off,
                streaming_msps=round(off / dt / 1e6, 1), **extra)
    ok = done.pop("ok")
    if resilient is not None:
        ok = ok and extra["recoveries"] == 1
    return _finish(emit, name, done, ok)


def _failing(make_rx, fail_at: int):
    """A receiver factory whose receivers' pushes, counted across every
    receiver it builds, fail on the ``fail_at``-th: that push runs (its
    kernel is launched and the receiver's state advances) and then
    raises, as a device lost before the reports reach the host."""
    count = [0]

    def make():
        rx = make_rx()
        push = rx.push

        def flaky(block):
            count[0] += 1
            out = push(block)
            if count[0] == fail_at:
                raise RuntimeError(f"injected device loss at push {fail_at}")
            return out

        rx.push = flaky
        return rx

    return make


def clean(device=None, *, spec=None, total_hops: int = 32768,
          n_events: int = 112, seed: int = 11, noise: float = 0.02,
          block: int = PUSH, front_end=None,
          reports: Optional[list] = None, emit=None) -> dict:
    """``tools/soak_tpu.py``: 112 random accesses in 32768 hops of a
    1024-channel band, noise 0.02; threshold 0.6, max_bursts 6, min_rssi
    0.05.  Bar: every event found and bit-exact."""
    return _recc("clean", device, spec, total_hops, n_events, seed, noise,
                 1, False, 0.6, 0.05, block, front_end, reports,
                 emit)


def long(device=None, *, spec=None, total_hops: int = 131072,
         n_events: int = 420, seed: int = 13, noise: float = 0.02,
         block: int = PUSH, front_end=None,
         reports: Optional[list] = None, emit=None) -> dict:
    """``tools/soak_long_tpu.py``: ``clean`` at 420 events in 131072
    hops.  Bar: 420/420 bit-exact."""
    return _recc("long", device, spec, total_hops, n_events, seed, noise,
                 1, False, 0.6, 0.05, block, front_end, reports,
                 emit)


def impaired(device=None, *, spec=None, total_hops: int = 65536,
             n_events: int = 200, seed: int = 23, noise: float = 0.01,
             block: int = PUSH, front_end=None,
             reports: Optional[list] = None, emit=None) -> dict:
    """``tools/soak_impaired_tpu.py``: 200 accesses in 65536 hops, each
    with a CFO, Rayleigh fading and a random DCC; noise 0.01; threshold
    0.55, min_rssi 0.02.  Bar: 200/200 bit-exact with the right DCC."""
    return _recc("impaired", device, spec, total_hops, n_events, seed,
                 noise, 2, True, 0.55, 0.02, block, front_end,
                 reports, emit)


def chaos(device=None, *, spec=None, total_hops: int = 32768,
          n_events: int = 112, seed: int = 11, noise: float = 0.02,
          block: int = PUSH, fail_at: int = 3,
          checkpoint_blocks: int = 1, front_end=None,
          reports: Optional[list] = None, emit=None) -> dict:
    """``tools/soak_chaos_tpu.py``: ``clean``'s band through
    ``ResilientReceiver(checkpoint_blocks=1)``, the receiver failing on
    its 3rd push; ``snapshot_ms`` is one host snapshot of the carried
    state.  Bar: every event bit-exact, one recovery."""
    return _recc("chaos", device, spec, total_hops, n_events, seed, noise,
                 1, False, 0.6, 0.05, block, front_end, reports,
                 emit, resilient=(fail_at, checkpoint_blocks))


# ---- the checkpointed 64-block stream ---------------------------------------

STREAM64_GATES = dict(policy="majority", threshold=0.55, min_rssi=0.05,
                      require_word_a=True)


def stream64(device=None, *, spec=None, blocks: int = 64,
             block_hops: int = 2048, n_events: int = 150, seed: int = 41,
             noise: float = 0.01, restore_at: int = 32,
             reports: Optional[list] = None, emit=None) -> dict:
    """``tools/soak_stream64_v2_tpu.py``: impaired traffic in 64 blocks
    of 2048 hops; at block 32 the receiver is saved, a fresh one loads
    the file and goes on; ``flush(pad_tail=True)`` at the end.  The
    active gates are echoed.  Bar: every event exactly once, bit-exact,
    with its DCC; no duplicate, ghost or misdecode."""
    dev = resolve_device(device)
    spec = spec or production_spec()
    emit = emit or emitter()
    M, P = spec.num_channels, spec.chz_spec.hop
    total_hops = blocks * block_hops
    events = random_events(n_events, spec, total_hops, seed=seed)
    gates = dict(max_trigger_errors=spec.max_trigger_errors,
                 repeat_gate=spec.repeat_gate, io_bf16=spec.io_bf16,
                 corr_bf16=spec.corr_bf16,
                 transform_bf16=spec.transform_bf16, **STREAM64_GATES)
    emit(event="start", family="stream64", device=str(dev), M=M,
         blocks=blocks, block_hops=block_hops, n_events=len(events),
         gates=gates, restore_at=restore_at)
    t0 = time.perf_counter()
    bbs = burst_basebands(events, spec, np.random.default_rng(seed))
    planted = [p for p, _ in bbs]
    x = synthesize_band(band_plane(bbs, M, total_hops), spec, dev, noise, 2)
    del bbs
    _sync(dev)
    emit(event="synthesized", family="stream64", samples=int(x.shape[0]),
         synth_s=round(time.perf_counter() - t0, 2))

    def make_rx():
        return MultichannelReceiver(
            spec, threshold=STREAM64_GATES["threshold"], max_bursts=6,
            policy=STREAM64_GATES["policy"],
            min_rssi=STREAM64_GATES["min_rssi"],
            require_word_a=STREAM64_GATES["require_word_a"], device=dev)

    rx = make_rx()
    got = []
    n = block_hops * P
    _sync(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for b in range(blocks):
            if b == restore_at:
                path = os.path.join(tmp, "stream64.npz")
                save_receiver(path, rx)
                rx = make_rx()
                load_receiver(path, rx)
                emit(event="checkpoint_restore", family="stream64", block=b)
            got += rx.push(x[b * n:(b + 1) * n])
        got += rx.flush(pad_tail=True)
    dt = time.perf_counter() - t0
    del x
    if reports is not None:
        reports.extend(got)
    done = once_verdict(got, planted)
    done.update(gates=gates, wall_s=round(dt, 3), samples=total_hops * P,
                streaming_msps=round(total_hops * P / dt / 1e6, 1))
    return _finish(emit, "stream64", done, done.pop("ok"))


# ---- the sharded stream -------------------------------------------------------

def sharded_events(M: int, rows: Sequence[Tuple[int, int]], tsize: int,
                   n_random: int, seed: int) -> Tuple[list, int]:
    """(events, total hops) of the sharded soak: ``n_random`` random
    accesses on the inner channels, then six placed ones -- across a row
    boundary, a block boundary, the block-length change, in the
    flush-pending tail and a same-channel back-to-back pair.  The
    channel plan is the JAX soak's 64-channel one, or the bank's when it
    is smaller."""
    (blocks_a, row_a), (_, row_b) = rows
    bha = tsize * row_a
    total = sum(nb * tsize * nh for nb, nh in rows)
    C = min(M, 64)
    spec = MultichannelSpec(num_channels=M)
    events = random_events(n_random, spec, total - 40000, seed=seed,
                           channels=range(2, C - 4))
    events += [
        MobileEvent("origination", 0, min(3, blocks_a - 1) * bha + row_a
                    - 5000, "5551234567", "7025551000", esn=1),
        MobileEvent("page_response", 1, min(6, blocks_a - 1) * bha - 4000,
                    "4155559876"),
        MobileEvent("registration", C - 3, blocks_a * bha - 5200,
                    "9165554321", esn=2),
        MobileEvent("page_response", C - 2, total - 6000, "7075550123"),
        MobileEvent("origination", C - 1, 50000, "5305551000", "9" * 8,
                    esn=3),
        MobileEvent("registration", C - 1, 50000 + BURST_HOPS + 600,
                    "5305551000", esn=4),
    ]
    return events, total


SHARDED_MESH = (2, 4)          # (time, chan)
SHARDED_VOICE_MESH = (4, 2)
SHARDED_VOICE_ROW, SHARDED_VOICE_BLOCKS = 10352, 5


def sharded(device=None, *, spec=None,
            rows: Sequence[Tuple[int, int]] = ((16, 10560), (8, 13440)),
            n_random: int = 24, seed: int = 7, noise: float = 0.01,
            reports: Optional[list] = None, emit=None) -> dict:
    """``tools/soak_sharded_cpu.py``: ``ShardedReceiver`` on a 2x4 mesh
    (its workers share ``device``), M=64 f32 by default; 16 blocks of
    rows of 10560 hops, then 8 of 13440; 30 impaired events (24 random,
    six placed across boundaries) added into the plane; threshold 0.55,
    min_rssi 0.02; flush.  Bar: exactly once, as ``stream64``."""
    dev = resolve_device(device)
    spec = spec or MultichannelSpec(num_channels=64, taps_per_phase=8)
    emit = emit or emitter()
    M, P = spec.num_channels, spec.chz_spec.hop
    tsize, csize = SHARDED_MESH
    events, total_hops = sharded_events(M, rows, tsize, n_random, seed)
    emit(event="start", family="sharded", device=str(dev), M=M,
         mesh=[tsize, csize], blocks=[nb for nb, _ in rows],
         nh_rows=[nh for _, nh in rows], n_events=len(events),
         total_hops=total_hops)
    t0 = time.perf_counter()
    bbs = burst_basebands(events, spec, np.random.default_rng(seed))
    planted = [p for p, _ in bbs]
    x = synthesize_band(band_plane(bbs, M, total_hops, add=True), spec, dev,
                        noise, 7)
    del bbs
    _sync(dev)
    emit(event="synthesized", family="sharded", samples=int(x.shape[0]),
         synth_s=round(time.perf_counter() - t0, 2))
    rx = ShardedReceiver(make_mesh(MeshSpec(time=tsize, chan=csize), [dev]),
                         spec, threshold=0.55, max_bursts=6, min_rssi=0.02)
    got = []
    _sync(dev)
    t0 = time.perf_counter()
    off = 0
    for nb, nh in rows:
        n = tsize * nh * P
        for _ in range(nb):
            got += rx.push(x[off: off + n])
            off += n
    got += rx.flush()
    dt = time.perf_counter() - t0
    del x
    if reports is not None:
        reports.extend(got)
    done = once_verdict(got, planted)
    done.update(wall_s=round(dt, 3), samples=off,
                streaming_msps=round(off / dt / 1e6, 1))
    return _finish(emit, "sharded", done, done.pop("ok"))


# ---- supervised calls ---------------------------------------------------------

T_ANSWER, T_HANDOFF, T_RETUNE, T_FADE = 0.6, 1.4, 1.45, 2.2
VOICE_TIMERS = dict(fade_timeout_s=1.0, st_release_s=0.6)


def _voice_mod(t: np.ndarray, on_a_after_handoff: bool):
    """The one-call timeline's modulating signals of slots A and B and
    B's carrier: A rings (SAT + ST) until the answer, talks (SAT +
    voice) until the handoff; B talks from the retune to the fade."""
    sat = SAT_AMP * np.cos(2 * np.pi * SAT_HZ * t)
    st = ST_AMP * np.cos(2 * np.pi * ST_HZ * t)
    voice = 0.3 * np.cos(2 * np.pi * 1000.0 * t)
    m_a = np.where(t < T_ANSWER, sat + st,
                   np.where(t < T_HANDOFF, sat + voice, 0.0))
    m_b = np.where((t >= T_RETUNE) & (t < T_FADE), sat + voice, 0.0)
    act_b = ((t >= T_RETUNE) & (t < T_FADE)).astype(np.float32)[:, None]
    act_a = (np.ones_like(t) if on_a_after_handoff
             else (t < T_HANDOFF)).astype(np.float32)[:, None]
    return m_a, m_b, act_a, act_b


def _fm(m: np.ndarray, sens: float) -> np.ndarray:
    return fm_modulate(torch.as_tensor(m, dtype=torch.float32), sens)[0] \
        .numpy()


def _voice_station(timers: dict, system=None, per_channel_fvc=False):
    station = BaseStation(system, sps=3, per_channel_fvc=per_channel_fvc)
    station.supervision_config = dataclasses.replace(
        station.supervision_config, **timers)
    events = []
    station._on_event = lambda ev: events.append((ev.kind, ev.payload))
    return station, events


def timeline_of(events):
    """(kind, channel, t) of each supervision event a station emitted,
    t rounded to 10 ms."""
    return [(e.kind, e.channel, round(e.t, 2))
            for k, e in events if k == "supervision_event"]


def one_call_verdict(events, station, slots, t_cmd: float):
    """(timeline, checks, problems) of the one-call soaks: in order, the
    answer on A, A's SAT lost when the mobile leaves, B's SAT lost at the
    fade and B's fade-timeout release, each within 0.15 s (B's times
    from its supervisor's start, the handoff command at ``t_cmd``), and
    no other supervision event."""
    a, b = slots
    tf = T_FADE - t_cmd
    expected = [("answer", a, T_ANSWER, 0.15),
                ("sat_lost", a, T_HANDOFF, 0.15),
                ("sat_lost", b, tf, 0.15),
                ("release", b, tf + VOICE_TIMERS["fade_timeout_s"], 0.15)]
    timeline = timeline_of(events)
    problems = []
    if len(timeline) != len(expected):
        problems.append(f"expected {len(expected)} events, got "
                        f"{len(timeline)}")
    for got, exp in zip(timeline, expected):
        kind, chan, t_exp, tol = exp
        if got[0] != kind or got[1] != chan or abs(got[2] - t_exp) > tol:
            problems.append(f"expected {exp}, got {got}")
    checks = {
        "timeline_exact_zero_unexpected": not problems,
        "handoff_event": any(k == "handoff" and tuple(p) == (a, b)
                             for k, p in events),
        "no_release_on_A_before_handoff": not any(
            k == "release" and c == a for k, c, _ in timeline),
        "call_torn_down": a not in station.supervisors
                          and b not in station.supervisors,
    }
    return timeline, checks, problems


def sat_measured(levels) -> float:
    """Median SAT level of slot A's conversation frames (~0.7-1.3 s)."""
    return float(np.median(np.concatenate(levels, axis=0)[70:130, 1]))


def _push_voice(rx, x, P, block_hops, fs, station, slots, emit, name):
    """Stream the band in blocks, commanding the handoff at the first
    block boundary at or past T_HANDOFF; returns (wall s, t of the
    handoff command)."""
    dev = x.device
    n = int(x.shape[0])
    blk = block_hops * P
    _sync(dev)
    t0 = time.perf_counter()
    t_cmd = None
    for off in range(0, n, blk):
        rx.push(x[off: off + blk])
        t_now = (off + blk) / P / fs
        if t_cmd is None and t_now >= T_HANDOFF:
            ok = station.handoff(*slots)
            emit(event="handoff_cmd", family=name, t=round(t_now, 2),
                 accepted=bool(ok))
            t_cmd = t_now
    rx.flush()
    return time.perf_counter() - t0, t_cmd


def voice(device=None, *, spec=None, slots: Tuple[int, int] = (400, 500),
          noise: float = 0.005, timeline: Optional[list] = None,
          emit=None) -> dict:
    """``tools/soak_voice_tpu.py``: one supervised call over the
    1024-channel bank, slots 400 and 500 as the receiver's
    ``supervision_slots``: ringing, answer at 0.6 s, conversation,
    handoff A -> B at 1.4 s (A's carrier stays up, unmodulated), deep
    fade at 2.2 s, fade-timeout release; timers 1.0 s / 0.6 s.  Bar: the
    timeline exact, no other event, SAT measured within 10%."""
    dev = resolve_device(device)
    spec = spec or production_spec()
    emit = emit or emitter()
    M, P = spec.num_channels, spec.chz_spec.hop
    fs = float(spec.pipe.chan_rate)
    a, b = slots
    dur = VOICE_S
    n = int(dur * fs)
    n -= n % P
    t = np.arange(n) / fs
    emit(event="start", family="voice", device=str(dev), M=M, dur_s=dur,
         slots=[a, b], gates=dict(VOICE_TIMERS, io_bf16=spec.io_bf16,
                                  corr_bf16=spec.corr_bf16),
         timeline={"answer": T_ANSWER, "handoff": T_HANDOFF,
                   "retune": T_RETUNE, "fade": T_FADE})
    t0 = time.perf_counter()
    m_a, m_b, act_a, act_b = _voice_mod(t, on_a_after_handoff=True)
    Y = np.zeros((n, M, 2), np.float32)
    Y[:, a] = _fm(m_a, spec.fm_sensitivity) * act_a
    Y[:, b] = _fm(m_b, spec.fm_sensitivity) * act_b
    x = synthesize_band(Y, spec, dev, noise, 7)
    del Y
    _sync(dev)
    emit(event="synthesized", family="voice", samples=int(x.shape[0]),
         synth_s=round(time.perf_counter() - t0, 2))

    station, events = _voice_station(VOICE_TIMERS)
    station._start_supervision(a, ALERTING)
    levels = []

    def on_sup(slot, lv, pw):
        levels.append((slot, np.asarray(lv)))
        station.push_supervision(slot, lv, pw)

    rx = MultichannelReceiver(spec, max_bursts=2, threshold=0.55,
                              supervision_slots=(a, b), on_supervision=on_sup,
                              device=dev)
    dt, t_cmd = _push_voice(rx, x, P, VOICE_BLOCK_HOPS, fs, station, slots,
                            emit, "voice")
    del x
    tl, checks, problems = one_call_verdict(events, station, slots, t_cmd)
    if timeline is not None:
        timeline.extend(tl)
    sat_meas = sat_measured([lv for s, lv in levels if s == a])
    checks["sat_level_within_10pct"] = abs(sat_meas - SAT_AMP) / SAT_AMP \
        < 0.10
    done = dict(timeline=tl, checks=checks, problems=problems,
                sat_measured=round(sat_meas, 4),
                wall_s=round(dt, 3), samples=n * P,
                streaming_msps=round(n * P / dt / 1e6, 1))
    return _finish(emit, "voice", done, all(checks.values()))


def sharded_voice(device=None, *, spec=None, noise: float = 0.005,
                  timeline: Optional[list] = None, emit=None) -> dict:
    """``tools/soak_sharded_voice_cpu.py``: the one-call timeline through
    ``ShardedReceiver``'s supervision tap on a 4x2 mesh, M=64 f32 by
    default, slots 20 and 40 (scaled to the bank), 5 blocks of rows of
    10352 hops; A's carrier goes off at the handoff.  Bar: the timeline
    exact, no other event."""
    dev = resolve_device(device)
    spec = spec or MultichannelSpec(num_channels=64, taps_per_phase=8)
    emit = emit or emitter()
    M, P = spec.num_channels, spec.chz_spec.hop
    fs = float(spec.pipe.chan_rate)
    a, b = 20 * M // 64, 40 * M // 64
    tsize, csize = SHARDED_VOICE_MESH
    block_hops = tsize * SHARDED_VOICE_ROW
    blocks = SHARDED_VOICE_BLOCKS
    n = blocks * block_hops
    t = np.arange(n) / fs
    emit(event="start", family="sharded_voice", device=str(dev), M=M,
         mesh=[tsize, csize], blocks=blocks, block_hops=block_hops,
         slots=[a, b], gates=VOICE_TIMERS,
         timeline={"answer": T_ANSWER, "handoff": T_HANDOFF,
                   "retune": T_RETUNE, "fade": T_FADE})
    t0 = time.perf_counter()
    m_a, m_b, act_a, act_b = _voice_mod(t, on_a_after_handoff=False)
    Y = np.zeros((n, M, 2), np.float32)
    Y[:, a] = _fm(m_a, spec.fm_sensitivity) * act_a
    Y[:, b] = _fm(m_b, spec.fm_sensitivity) * act_b
    x = synthesize_band(Y, spec, dev, noise, 7)
    del Y
    _sync(dev)
    emit(event="synthesized", family="sharded_voice",
         samples=int(x.shape[0]), synth_s=round(time.perf_counter() - t0, 2))
    station, events = _voice_station(VOICE_TIMERS)
    station._start_supervision(a, ALERTING)
    rx = ShardedReceiver(
        make_mesh(MeshSpec(time=tsize, chan=csize), [dev]), spec,
        max_bursts=2, threshold=0.55, supervision_slots=(a, b),
        on_supervision=station.push_supervision)
    dt, t_cmd = _push_voice(rx, x, P, block_hops, fs, station, (a, b),
                            emit, "sharded_voice")
    del x
    tl, checks, problems = one_call_verdict(events, station, (a, b), t_cmd)
    if timeline is not None:
        timeline.extend(tl)
    done = dict(timeline=tl, checks=checks, problems=problems,
                wall_s=round(dt, 3), samples=n * P,
                streaming_msps=round(n * P / dt / 1e6, 1))
    return _finish(emit, "sharded_voice", done, all(checks.values()))


MULTICALL_TIMERS = dict(fade_timeout_s=0.6, st_release_s=0.5)


def multicall_plan(M: int = 1024):
    """The sixteen calls: (channel, slot, start state, t_answer, t_hang,
    t_fade).  355-358 ring, answer and hang up; 359-365 talk from the
    start and hang up; 366 rings, answers and fades; 367-370 talk past
    every other call's teardown.  Slots 60 + 64 i at M=1024, scaled to
    the bank."""
    calls = (
        [(355 + i, 60 + 64 * i, ALERTING, 0.6 + 0.2 * i, 1.8 + 0.2 * i, None)
         for i in range(4)]
        + [(359 + i, 316 + 64 * i, CONVERSATION, None, 1.9 + 0.2 * i, None)
           for i in range(7)]
        + [(366, 764, ALERTING, 0.9, None, 2.8)]
        + [(367 + i, 828 + 64 * i, CONVERSATION, None, None, None)
           for i in range(4)])
    return [(c, s * M // 1024, st, ta, th, tf)
            for c, s, st, ta, th, tf in calls]


def multicall_mod(t: np.ndarray, t_ans, t_hang, t_fade, seed: int):
    """One call's modulating signal and carrier: the mobile's own SAT,
    ST and voice phases and a detuned voice tone, from
    ``default_rng(seed)``."""
    st_rel = MULTICALL_TIMERS["st_release_s"]
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 3)
    f_voice = 1000.0 + rng.uniform(-150.0, 150.0)
    sat = SAT_AMP * np.cos(2 * np.pi * SAT_HZ * t + ph[0])
    st_tone = ST_AMP * np.cos(2 * np.pi * ST_HZ * t + ph[1])
    voice_ = 0.3 * np.cos(2 * np.pi * f_voice * t + ph[2])
    ringing = (t < t_ans) if t_ans is not None else np.zeros_like(t, bool)
    m = sat + np.where(ringing, st_tone, voice_)
    active = np.ones_like(t, bool)
    if t_hang is not None:
        st_run = (t >= t_hang) & (t < t_hang + st_rel + 0.2)
        m = np.where(st_run, sat + st_tone, m)
        active &= t < t_hang + st_rel + 0.2
    if t_fade is not None:
        active &= t < t_fade
    return m.astype(np.float32), active.astype(np.float32)


def multicall_verdict(events, station, calls, dur: float):
    """(timeline, checks, problems) of the 16-call soak: each call's
    answer, ST release (and the SAT loss after it) or fade and fade
    release, the long calls alive in conversation at the end (then
    released by the operator); every other supervision event is a
    problem."""
    st_rel, fade_to = (MULTICALL_TIMERS["st_release_s"],
                       MULTICALL_TIMERS["fade_timeout_s"])
    long_calls = [c for c, _, _, ta, th, tf in calls
                  if th is None and tf is None]
    timeline = timeline_of(events)
    checks = {"long_calls_survived": all(
        c in station.supervisors
        and station.supervisors[c].state == CONVERSATION
        for c in long_calls)}
    for c in long_calls:
        station.release_call(c, "operator")
    expected = []
    for chan, _, _, t_ans, t_hang, t_fade in calls:
        if t_ans is not None and (t_fade is None or t_ans < t_fade):
            expected.append(("answer", chan, t_ans, 0.15))
        if t_hang is not None:
            expected.append(("release", chan, t_hang + st_rel, 0.15))
            expected.append(("sat_lost", chan, t_hang + st_rel + 0.2, 0.25))
        if t_fade is not None:
            expected.append(("sat_lost", chan, t_fade, 0.15))
            expected.append(("release", chan, t_fade + fade_to, 0.15))
    for c in long_calls:
        # end of stream: the flush block is trailing silence
        expected.append(("sat_lost", c, dur, 0.5))
    problems = []
    left = list(timeline)
    for kind, chan, t_exp, tol in expected:
        hit = next((g for g in left if g[0] == kind and g[1] == chan
                    and abs(g[2] - t_exp) <= tol), None)
        if hit is None:
            if kind != "sat_lost":   # optional: the supervisor is gone
                problems.append(f"missing {kind} on {chan} @ ~{t_exp}")
        else:
            left.remove(hit)
    problems += [f"unexpected event {g}" for g in left]
    reasons = {e.channel: e.reason for k, e in events
               if k == "supervision_event" and e.kind == "release"}
    checks.update({
        "timeline_exact_zero_unexpected": not problems,
        "st_releases": all("ST" in reasons.get(c, "")
                           for c, _, _, _, th, _ in calls if th is not None),
        "fade_release_366": "fade" in reasons.get(366, ""),
        "all_torn_down": not station.supervisors,
    })
    return timeline, checks, problems


def multicall16(device=None, *, spec=None, noise: float = 0.005,
                timeline: Optional[list] = None, emit=None) -> dict:
    """``tools/soak_multicall16_tpu.py``: sixteen concurrent supervised
    calls on the 1024-channel bank under ``BaseStation(per_channel_fvc=
    True)``, channels 355-370, staggered lifecycles, timers 0.6 s / 0.5
    s; ``host_us_per_call_block`` is the station's supervision work per
    call and block.  Bar: every call's timeline exact, no other event,
    ST releases on the hang-ups, a fade release on 366, the four long
    calls alive at the end."""
    dev = resolve_device(device)
    spec = spec or production_spec()
    emit = emit or emitter()
    M, P = spec.num_channels, spec.chz_spec.hop
    fs = float(spec.pipe.chan_rate)
    calls = multicall_plan(M)
    dur = MULTICALL_S
    n = int(dur * fs)
    n -= n % 2
    t = np.arange(n) / fs
    emit(event="start", family="multicall16", device=str(dev), M=M,
         dur_s=dur, calls=calls, gates=dict(MULTICALL_TIMERS,
                                            per_channel_fvc=True))
    t0 = time.perf_counter()
    Y = np.zeros((n, M, 2), np.float32)
    for chan, slot, _, t_ans, t_hang, t_fade in calls:
        m, act = multicall_mod(t, t_ans, t_hang, t_fade, seed=chan)
        Y[:, slot] = _fm(m, spec.fm_sensitivity) * act[:, None]
    x = synthesize_band(Y, spec, dev, noise, 7)
    del Y
    _sync(dev)
    emit(event="synthesized", family="multicall16", samples=int(x.shape[0]),
         synth_s=round(time.perf_counter() - t0, 2))

    system = SystemConfig(voice_channels=tuple(c for c, *_ in calls))
    station, events = _voice_station(MULTICALL_TIMERS, system,
                                     per_channel_fvc=True)
    slot_map = {slot: chan for chan, slot, *_ in calls}
    for chan, _, st0, *_ in calls:
        station._start_supervision(chan, st0)
        if st0 == ALERTING:
            station.supervisors[chan].begin_alert()
    concurrent = len(station.supervisors)
    cost = {"s": 0.0, "calls": 0, "max": 0.0}

    def on_sup(slot, lv, pw):
        t1 = time.perf_counter()
        station.push_supervision(slot_map[slot], lv, pw)
        d = time.perf_counter() - t1
        cost["s"] += d
        cost["calls"] += 1
        cost["max"] = max(cost["max"], d)

    rx = MultichannelReceiver(spec, max_bursts=2, threshold=0.55,
                              min_rssi=0.05,
                              supervision_slots=tuple(sorted(slot_map)),
                              on_supervision=on_sup, device=dev)
    blk = VOICE_BLOCK_HOPS * P
    _sync(dev)
    t0 = time.perf_counter()
    for off in range(0, n * P, blk):
        rx.push(x[off: off + blk])
    rx.flush()
    dt = time.perf_counter() - t0
    del x
    tl, checks, problems = multicall_verdict(events, station, calls, dur)
    checks["sixteen_concurrent"] = concurrent == 16
    if timeline is not None:
        timeline.extend(tl)
    done = dict(timeline=tl, checks=checks, problems=problems,
                wall_s=round(dt, 3), samples=n * P,
                streaming_msps=round(n * P / dt / 1e6, 1),
                realtime_factor=round(dur / dt, 2),
                host_us_per_call_block=round(
                    cost["s"] / max(cost["calls"], 1) * 1e6, 1),
                host_max_ms=round(cost["max"] * 1e3, 3))
    return _finish(emit, "multicall16", done, all(checks.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m amps_tpu_torch.eval.soak",
        description="Run the station's certification soaks at full size.")
    ap.add_argument("families", nargs="*", choices=FAMILIES,
                    help="default: every family")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--out", default=None,
                    help="append the JSON lines to this file")
    args = ap.parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        build.build()     # the kernels' one-time nvcc build is set-up
    emit = emitter(args.out)
    failed = []
    for name in args.families or FAMILIES:
        v = globals()[name](args.device, emit=emit)
        if not v["ok"]:
            failed.append(name)
    if failed:
        print(f"soak: {', '.join(failed)} missed the bar", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
