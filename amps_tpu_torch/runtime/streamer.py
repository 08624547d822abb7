"""The base station's streaming duplex, the PyTorch port of
``amps_tpu.runtime.streamer`` (``MultichannelReceiver``,
``MultichannelTransmitter``, ``BurstReport``, ``decode_dcc``, the
receive block ``_rx_stream_block``, ``deliver_supervision_frames`` and
the fused closed loop ``make_closed_loop_stream``).

* ``MultichannelTransmitter.next_block`` produces one FOCC superframe of
  the forward band: every control channel's frame bits and FSK baseband
  in one batch, scattered into the (hops, M, 2) channel plane, then the
  synthesis channelizer (``kernels.synth``), with its overlap-add carry,
  hop parity and phase accumulators carried across blocks.
* ``MultichannelReceiver.push`` streams wideband blocks of the reverse
  band through the receive block with all state carried: analyzer
  history, hop parity, the previous channel sample, a demod overlap
  long enough that a burst straddling a block is caught whole in the
  next window, the power-series overlap of the per-burst rssi, and
  absolute-position dedup of bursts found twice.  The front end is
  ``kernels.rx_front``.

* ``make_closed_loop_stream`` runs many consecutive blocks of the whole
  TX -> RF -> RX chain (``kernels.synth`` -> ``kernels.rx_front`` ->
  trigger search -> capture -> decode) with all state on the device; on
  a CUDA device the block body is captured once as a CUDA graph and
  replayed, the counterpart of the JAX package's jitted ``lax.scan``.

Reports are selected on the device (top ``max_reports`` deliverable
slots, as the JAX package does) and fetched when the block is drained;
a block with more deliverable slots than that fetches the full report
planes instead, so no report is ever dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from amps_tpu_torch.config import SystemConfig
from amps_tpu_torch.device import as_tensor, resolve_device
from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.dsp.fm import fsk_manchester_baseband
from amps_tpu_torch.kernels import rx_front as _k_rx_front
from amps_tpu_torch.kernels import synth as _k_synth
from amps_tpu_torch.kernels import trigger_search as _k_search
from amps_tpu_torch.kernels.rx_front import analyze_demod
from amps_tpu_torch.kernels.synth import synthesize_block
from amps_tpu_torch.parallel.pipeline import MultichannelSpec
from amps_tpu_torch.rx import correlator, decoder
from amps_tpu_torch.rx.voice import supervision_levels
from amps_tpu_torch.tx.focc import FoccStream, focc_frame_bits
from amps_tpu_torch.tx.recc_ms import CODED_DCC
from amps_tpu_torch.utils import profiling

# the kernel wrappers a closed-loop block launches through, whose
# ``LAUNCHES`` a replay of the captured block adds to
_LOOP_KERNELS = (_k_synth, _k_rx_front, _k_search)

# minimum-Hamming-distance decode of the 7-bit coded DCC (553 2.6.1.2)
_DCC_CODES = np.array([CODED_DCC[d] for d in range(4)], np.int32)


def decode_dcc(bits7) -> int:
    b = np.asarray(bits7, np.int32).reshape(1, 7)
    return int(np.argmin(np.abs(_DCC_CODES - b).sum(axis=1)))


def _rx_stream_block(x, hist, demod_carry, prev_iq, pw_carry,
                     spec: MultichannelSpec, hop_parity: int,
                     max_bursts: int, threshold: float, search,
                     front_end):
    """One streaming receive step with carried state.

    x: (N, 2) new wideband samples, N a multiple of M/2.  hist: (L-P, 2)
    analyzer history.  demod_carry, pw_carry: (M, OVR) demod and
    power-series overlap of the previous window.  prev_iq: (M, 2) last
    channel sample.  ``search`` is ``correlator.find_bursts_phases`` and
    ``front_end`` ``kernels.rx_front.analyze_demod``, or their plain
    versions.  Returns a dict of the candidate planes
    (starts, valid, quality, hard, rssi), chan_power, demod_new and the
    new state (hist, carry, prev, pw_carry)."""
    M, T, sps = spec.num_channels, spec.taps_per_phase, spec.chan_sps
    x_ext = torch.cat([hist, x], dim=0).contiguous()
    demod_new, last, pw_new = front_end(x_ext, M, T, hop_parity, prev_iq)
    # each (M, Nh) plane goes once it is used (gigabytes at a wide bank):
    # the new history, the power carry and the new demod (a view of the
    # window) are taken first
    new_hist = x_ext[x_ext.shape[0] - (M * T - M // 2):].clone()
    del x_ext
    Nh = demod_new.shape[-1]
    ovr = demod_carry.shape[-1]
    chan_power = torch.sqrt(torch.mean(pw_new, dim=-1))
    demod = torch.cat([demod_carry, demod_new], dim=-1)
    demod_new = demod[:, ovr:]
    pw_blk = correlator.window_power_blocks([pw_carry, pw_new])
    if Nh >= ovr:
        new_pw_carry = pw_new[:, Nh - ovr:].clone()
    else:
        new_pw_carry = torch.cat([pw_carry[:, Nh:], pw_new], dim=-1)
    del pw_new
    # io_bf16: bf16 phase-stream plane; the carried demod stays f32
    dsp = demod.to(torch.bfloat16) if spec.io_bf16 else demod
    phases = correlator.symbol_phase_streams(dsp, sps)
    del dsp
    starts, valid, quality = search(phases, sps, max_bursts, threshold,
                                    out_bf16=spec.corr_bf16)
    # only bursts whose whole capture fits this window; one cut off by
    # the block edge is found complete in the next window's overlap
    valid = valid & (starts + correlator.CAPTURE_SYMBOLS * sps
                     <= demod.shape[-1])
    rssi = correlator.burst_rssi_blocks(pw_blk, starts, sps)
    lead = correlator.TRIGGER_SYMBOLS if spec.max_trigger_errors >= 0 else 0
    ext = correlator.extract_from_phases(
        phases, starts, sps,
        hard_dtype=torch.bfloat16 if spec.io_bf16 else torch.uint8,
        lead=lead)
    if spec.max_trigger_errors >= 0:
        valid = correlator.apply_trigger_gate_soft(
            valid, ext[2], spec.max_trigger_errors, starts, sps)
    return {
        "starts": starts, "valid": valid, "quality": quality,
        "hard": ext[0], "rssi": rssi, "chan_power": chan_power,
        "demod_new": demod_new, "hist": new_hist,
        "carry": demod[:, demod.shape[-1] - ovr:].clone(),
        "prev": last, "pw_carry": new_pw_carry,
    }


def deliver_supervision_frames(dem, carry, spec: MultichannelSpec, slots,
                               callback):
    """The supervision frame discipline of a receiver: prepend the
    previous block's sub-frame leftover, measure the whole 10 ms frames
    (``rx.voice.supervision_levels`` on the demod divided by the FSK
    sensitivity, so the tone amplitudes come out in the TX units that
    SupervisionConfig's nominals are stated in) and call
    ``callback(slot, levels (F, 5), power (F,))`` (numpy) per slot.
    ``dem``: (S, n) float32 demod rows of the watched slots, new samples
    only, a tensor or numpy; the measurement runs on a tensor's device.
    ``carry``: (S, < frame) numpy.  Returns the new sub-frame carry
    (numpy)."""
    fs = float(spec.pipe.chan_rate)
    frame = int(fs * 0.01)                                # 10 ms frames
    dem = torch.as_tensor(dem)
    dem = torch.cat([torch.as_tensor(np.asarray(carry, np.float32),
                                     device=dem.device),
                     dem.to(torch.float32)], dim=-1)
    nf = dem.shape[-1] // frame
    new_carry = dem[:, nf * frame:].cpu().numpy().copy()
    if nf >= 1:
        sens = 2.0 * np.pi * spec.pipe.deviation_hz / fs
        lv, pw = supervision_levels(dem[:, : nf * frame] / sens, frame, fs)
        lv, pw = lv.cpu().numpy(), pw.cpu().numpy()
        if callback:
            for i, slot in enumerate(slots):
                callback(slot, lv[i], pw[i])
    return new_carry


def _compact_reports(planes, min_rssi: float, R: int, require_word_a: bool):
    """Device-side selection of the top-R candidate slots (deliverable
    first, then by trigger quality) and their report fields.
    'Deliverable' applies the host gates (min_rssi, require_word_a) to
    the same f32 values, so a ghost the host would discard cannot evict
    a genuine burst from the R slots; n_valid counts deliverable slots."""
    starts, valid, quality, words, ok, bad, dccs, rssi = planes
    M, K = valid.shape
    deliverable = valid & (rssi.to(torch.float32)
                           >= float(np.float32(min_rssi)))
    if require_word_a:
        deliverable = deliverable & ok[..., 0].to(torch.bool)
    prio = torch.where(deliverable, 1.0 + quality.to(torch.float32),
                       torch.zeros((), device=valid.device))
    vals, idx = torch.topk(prio.reshape(-1), R)

    def sel(a):
        return a.reshape((M * K,) + a.shape[2:])[idx]

    return {"idx": idx, "cvalid": vals > 0.0, "starts": sel(starts),
            "quality": sel(quality).to(torch.float32),
            "rssi": sel(rssi).to(torch.float32), "words": sel(words),
            "ok": sel(ok), "bad": sel(bad), "dccs": sel(dccs),
            "n_valid": torch.sum(deliverable)}


def _compact_reports_rows(planes, min_rssi: float, R: int,
                          require_word_a: bool):
    """``_compact_reports`` of each time row of (rows, M, K, ...) report
    planes, the sharded receiver's selection: a list of one field dict
    a row."""
    return [_compact_reports(tuple(p[r] for p in planes), min_rssi, R,
                             require_word_a)
            for r in range(planes[0].shape[0])]


def _flatten_full(planes):
    """The full (M, K, ...) report planes as the fields of
    ``_compact_reports`` with every slot selected, in ascending flat
    c*K+k order: the lossless overflow path."""
    names = ("starts", "cvalid", "quality", "words", "ok", "bad", "dccs",
             "rssi")
    full = {n: a.reshape((-1,) + a.shape[2:]) for n, a in zip(names, planes)}
    full["idx"] = torch.arange(full["cvalid"].shape[0])
    return full


def _candidates(fields):
    """Host arrays (idx, cvalid, starts, quality, rssi, words, ok, bad,
    dccs) of fetched report fields."""
    f = {k: v.cpu().numpy() for k, v in fields.items()}
    return (f["idx"].astype(np.int64), f["cvalid"].astype(bool),
            f["starts"].astype(np.int64), f["quality"].astype(np.float32),
            f["rssi"].astype(np.float32), f["words"], f["ok"].astype(bool),
            f["bad"], f["dccs"])


def closed_loop_geometry(spec: MultichannelSpec, frames: int):
    """(n_hops, block_samples, carry_hops) of a closed-loop block of
    ``frames`` FOCC frames: 463 bits x 2 Manchester symbols x sps hops a
    frame; the carried demod overlap is a whole burst (trigger + capture)
    or, when the block is shorter, the block."""
    n_hops = frames * 463 * 2 * spec.chan_sps
    ovr = (correlator.TRIGGER_SYMBOLS
           + correlator.CAPTURE_SYMBOLS) * spec.chan_sps
    return n_hops, n_hops * (spec.num_channels // 2), min(ovr, n_hops)


def closed_loop_state0(spec: MultichannelSpec, frames: int, device) -> dict:
    """The closed loop's zero state on ``device``: the synthesis carry
    and the analyzer history (L-P, 2), the demod overlap (M, carry_hops)
    and the discriminator's previous sample (M, 2)."""
    M, T = spec.num_channels, spec.taps_per_phase
    keep = M * T - M // 2
    carry_hops = closed_loop_geometry(spec, frames)[2]
    dev = resolve_device(device)
    return {"syn_carry": torch.zeros((keep, 2), device=dev),
            "hist": torch.zeros((keep, 2), device=dev),
            "carry": torch.zeros((M, carry_hops), device=dev),
            "prev": torch.zeros((M, 2), device=dev)}


def closed_loop_block(Y, st: dict, spec: MultichannelSpec,
                      max_bursts: int = 2, threshold: float = 0.55,
                      synthesize: Callable = synthesize_block,
                      front_end: Callable = analyze_demod,
                      search: Callable = correlator.find_bursts_phases):
    """One block of the closed loop: Y (n_hops, M, 2) channel basebands
    and the state ``st`` (``closed_loop_state0``) -> (new state, planes).
    The forward band is synthesized, analyzed and demodulated again with
    the previous sample carried, searched over the carried overlap plus
    the new hops, captured, gated and decoded.  planes: starts, valid,
    quality (M, K), words (M, K, 7, 36), word_ok (M, K, 7).  The hop
    parity is 0 at every block, which needs an even hop count.  Nothing
    here reads a tensor on the host, so the body can be captured as a
    CUDA graph.  The back end after the front end runs as four
    contiguous ``utils.profiling`` stages: ``loop.phases`` (the carried
    demod's concatenation, the bf16 cast, the phase streams),
    ``loop.search`` (the trigger search and the fit mask),
    ``loop.capture`` (capture and trigger gate), ``loop.decode``."""
    M, T, sps = spec.num_channels, spec.taps_per_phase, spec.chan_sps
    if Y.shape[0] % 2:
        raise ValueError(f"closed-loop blocks need an even hop count, got "
                         f"{Y.shape[0]}")
    x, syn_tail = synthesize(Y, M, T, 0, st["syn_carry"])
    x_ext = torch.cat([st["hist"], x], dim=0)
    demod_new, last, _ = front_end(x_ext, M, T, 0, st["prev"])
    with profiling.stage("loop.phases", Y.device):
        demod = torch.cat([st["carry"], demod_new], dim=-1)
        dsp = demod.to(torch.bfloat16) if spec.io_bf16 else demod
        phases = correlator.symbol_phase_streams(dsp, sps)
    with profiling.stage("loop.search", Y.device, joined=True):
        starts, valid, quality = search(phases, sps, max_bursts, threshold,
                                        out_bf16=spec.corr_bf16)
        valid = valid & (starts + correlator.CAPTURE_SYMBOLS * sps
                         <= demod.shape[-1])
    with profiling.stage("loop.capture", Y.device, joined=True):
        lead = (correlator.TRIGGER_SYMBOLS if spec.max_trigger_errors >= 0
                else 0)
        ext = correlator.extract_from_phases(
            phases, starts, sps,
            hard_dtype=torch.bfloat16 if spec.io_bf16 else torch.uint8,
            lead=lead)
        if spec.max_trigger_errors >= 0:
            valid = correlator.apply_trigger_gate_soft(
                valid, ext[2], spec.max_trigger_errors, starts, sps)
    with profiling.stage("loop.decode", Y.device, joined=True):
        dec = decoder.decode_bursts(ext[0],
                                    repeat_gate=spec.decode_repeat_gate)
    nc = st["carry"].shape[-1]
    keep = M * T - M // 2
    st2 = {"syn_carry": syn_tail,
           "hist": x_ext[x_ext.shape[0] - keep:],
           "carry": demod[:, demod.shape[-1] - nc:],
           "prev": last}
    return st2, {"starts": starts, "valid": valid, "quality": quality,
                 "words": dec.words, "word_ok": dec.word_ok}


def make_closed_loop_stream(spec: MultichannelSpec, nblocks: int,
                            frames: int = 2, max_bursts: int = 2,
                            threshold: float = 0.55, device=None,
                            graph: bool = True,
                            synthesize: Callable = synthesize_block,
                            front_end: Callable = analyze_demod,
                            search: Callable = correlator.find_bursts_phases):
    """The fused full-duplex closed loop: ``nblocks`` consecutive blocks
    of ``frames`` FOCC frames through the whole TX -> RF -> RX chain
    (``closed_loop_block``) with all carried state on the device and no
    host work between blocks.

    Returns (run, block_samples): ``run(word_pairs (M, frames, 2, 28))``
    -> (n_valid, quality_max, n_word_ok), 0-d tensors on the loop's
    device (the sum of ``valid``, the maximum of ``quality`` as float32
    and the sum of ``word_ok`` over all blocks), which the caller
    fetches.  Framing and FSK run once a call; every block synthesizes,
    analyzes and decodes anew on the carried state.

    ``device``: the current CUDA device unless named (without CUDA the
    default raises; ``"cpu"`` runs the kernels' plain versions).  On a
    CUDA device with ``graph=True`` the body of one block is captured
    once per ``run`` closure as a CUDA graph, after a warm-up on a side
    stream, and replayed ``nblocks`` times: state, Y and the three sums
    live in static buffers and the new state is copied in place.
    ``graph=False`` runs the same body eagerly, as the CPU always does.
    A failed capture or replay raises; ``run`` never falls back to the
    eager loop.  A replay launches the kernels without passing
    through their wrappers, so ``run`` adds each replay's kernel
    launches, as counted at capture, to the wrappers' ``LAUNCHES``.
    ``synthesize``, ``front_end`` and ``search`` are the three kernel
    wrappers; their plain versions run the plain path on any device (to
    compare).

    Each ``run`` opens a call of ``utils.profiling`` with the host span
    ``loop.entry`` (up to the first replay or step).  The block's four
    back-end stages are captured in a second graph of the same body,
    sharing the first one's memory pool and replayed as each call's
    last block, so only that block carries their event nodes; after a
    call's replays the events hold that block's device times."""
    M = spec.num_channels
    dev = resolve_device(device)
    chz.check_fold(spec.fold)
    n_hops, block_samples, _ = closed_loop_geometry(spec, frames)
    # whole frames: the hop count of a block is even, so every block
    # starts at hop parity 0
    assert n_hops % 2 == 0
    use_graph = graph and dev.type == "cuda"

    def prep(word_pairs) -> torch.Tensor:
        pairs = torch.as_tensor(np.asarray(word_pairs), device=dev)
        if tuple(pairs.shape) != (M, frames, 2, 28):
            raise ValueError(f"word_pairs must be ({M}, {frames}, 2, 28), "
                             f"got {tuple(pairs.shape)}")
        bb, _ = fsk_manchester_baseband(focc_frame_bits(pairs),
                                        spec.chan_sps, spec.fm_sensitivity)
        return bb.transpose(0, 1).contiguous()             # (n_hops, M, 2)

    def sums0():
        return (torch.zeros((), dtype=torch.int64, device=dev),
                torch.full((), float("-inf"), device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))

    def step(Y, st, sums, in_place: bool):
        """One block; the state and the sums are updated in place (the
        graph's static buffers) or returned anew."""
        st2, pl = closed_loop_block(Y, st, spec, max_bursts, threshold,
                                    synthesize, front_end, search)
        nv = torch.sum(pl["valid"])
        q = torch.max(pl["quality"].to(torch.float32))
        wok = torch.sum(pl["word_ok"])
        if not in_place:
            return st2, (sums[0] + nv, torch.maximum(sums[1], q),
                         sums[2] + wok)
        for k, v in st2.items():
            st[k].copy_(v)
        sums[0].add_(nv)
        sums[1].copy_(torch.maximum(sums[1], q))
        sums[2].add_(wok)
        return st, sums

    static = {}

    def capture():
        """Static buffers, a warm-up on a side stream (the kernels'
        build, the cached tables and cuBLAS's workspace then exist), and
        the capture of one block."""
        static["Y"] = torch.zeros((n_hops, M, 2), device=dev)
        static["st"] = closed_loop_state0(spec, frames, dev)
        static["sums"] = sums0()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(static["Y"], static["st"], static["sums"], True)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [k.LAUNCHES for k in _LOOP_KERNELS]
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            step(static["Y"], static["st"], static["sums"], True)
        # capture launched nothing: what it counted is one replay's share
        static["per_replay"] = [k.LAUNCHES - b
                                for k, b in zip(_LOOP_KERNELS, before)]
        # the same body with the back end's stage events, in the first
        # graph's pool, replayed as a call's last block (the one read):
        # event nodes slow every replay that has them
        last = torch.cuda.CUDAGraph()
        with profiling.capturing() as stages, \
                torch.cuda.graph(last, pool=g.pool()):
            step(static["Y"], static["st"], static["sums"], True)
        static["graph"], static["last"], static["stages"] = g, last, stages
        for k, b in zip(_LOOP_KERNELS, before):
            k.LAUNCHES = b

    def run(word_pairs):
        profiling.begin_call()
        if not use_graph:
            with profiling.trace("loop.entry"):
                Y = prep(word_pairs)
                st, sums = closed_loop_state0(spec, frames, dev), sums0()
            for _ in range(nblocks):
                st, sums = step(Y, st, sums, False)
            return sums
        with torch.cuda.device(dev):
            with profiling.trace("loop.entry"):
                Y = prep(word_pairs)
                if not static:
                    try:
                        capture()
                    except BaseException:
                        static.clear()
                        raise
                static["Y"].copy_(Y)
                for v in static["st"].values():
                    v.zero_()
                for v, v0 in zip(static["sums"], sums0()):
                    v.copy_(v0)
            for b in range(nblocks):
                static["last" if b == nblocks - 1 else "graph"].replay()
                for k, n in zip(_LOOP_KERNELS, static["per_replay"]):
                    k.LAUNCHES += n
            profiling.replayed(static["stages"])
        return tuple(v.clone() for v in static["sums"])

    return run, block_samples


@dataclasses.dataclass
class BurstReport:
    channel: int
    abs_symbol: int          # absolute Manchester-symbol index of capture
    quality: float
    words: np.ndarray        # (7, 36)
    word_ok: np.ndarray      # (7,)
    bad_symbols: np.ndarray  # (8,)
    rssi: float = 0.0        # band power over the burst's own capture
    dcc: int = -1            # decoded digital color code


class MultichannelReceiver:
    """Streaming wideband receiver over the channelizer bank.

    ``device``: where the carried state lives and the blocks are
    processed, the current CUDA device unless another is named (without
    CUDA the default raises; the CPU is used only as ``device="cpu"``).
    A CUDA device runs the ``rx_front`` kernel; on the CPU the front end
    is the kernel's plain version.  Host data (numpy, CPU tensors) is
    copied to the receiver's device; a block on any other device than
    the receiver's raises, so work handed over on the card is never
    moved to the host.

    ``front_end``: the receive front end, ``kernels.rx_front.
    analyze_demod``; ``analyze_demod_reference`` runs its plain version
    on any device (to compare the two on one stream).  ``search``: the
    trigger search, ``rx.correlator.find_bursts_phases``, or its plain
    version ``find_bursts_phases_reference`` in the same way.

    ``pipeline_depth``: blocks kept in flight.  At depth K > 1,
    ``push(block_i)`` only waits for block i-K, so the device computes
    block i while the host delivers reports of earlier blocks; call
    ``flush()`` to drain the tail.  Reports are then late by up to K-1
    blocks.

    ``policy``: 5-repeat word combining, "majority" (bit-wise vote
    before BCH) or "first_ok" (first decodable repeat).

    ``min_rssi``: drop reports whose band power over the burst's own
    capture is below this level (FM capture ghosts decode cleanly at
    20+ dB below any real transmission).  ``require_word_a``: drop
    reports whose Word A failed BCH decode.

    ``tap_demod_path``: append each block's raw (M, Nh) float32 demod
    to this file.  ``max_reports``: report slots fetched per block
    before the full planes are (``report_overflows`` counts those
    blocks).

    ``supervision_slots`` + ``on_supervision``: SAT/ST supervision of
    the given bank slots on every block.  Their rows of the new demod
    are gathered on the device; when the block is drained, after its
    report fetch and before its burst callbacks, the whole 10 ms frames
    are measured (``deliver_supervision_frames``) and the callback gets
    (slot, levels (F, 5), power (F,)) per slot, ready for
    ``BaseStation.push_supervision``.  The sub-frame leftover is carried,
    so the frames are continuous across blocks."""

    def __init__(self, spec: MultichannelSpec,
                 on_burst: Optional[Callable[[BurstReport], None]] = None,
                 max_bursts: int = 4, threshold: float = 0.55,
                 policy: str = "majority",
                 tap_demod_path: Optional[str] = None,
                 pipeline_depth: int = 1,
                 min_rssi: float = 0.0,
                 require_word_a: bool = True,
                 supervision_slots: tuple = (),
                 on_supervision: Optional[Callable] = None,
                 max_reports: int = 64,
                 device=None,
                 front_end: Callable = analyze_demod,
                 search: Callable = correlator.find_bursts_phases):
        chz.check_fold(spec.fold)
        self.spec = spec
        M, T = spec.num_channels, spec.taps_per_phase
        self.M, self.T = M, T
        self.sps = spec.chan_sps
        self.device = resolve_device(device)
        self._front_end = front_end
        self._search = search
        self.max_bursts = max_bursts
        self.threshold = threshold
        self.min_rssi = min_rssi
        self.require_word_a = require_word_a
        self.max_reports = min(max_reports, M * max_bursts)
        self.report_overflows = 0
        self.policy = policy
        self.on_burst = on_burst
        # overlap: a burst (trigger + capture) must fit in the carry so
        # one spanning a block boundary is wholly inside the next window
        self.ovr = (correlator.TRIGGER_SYMBOLS
                    + correlator.CAPTURE_SYMBOLS) * self.sps
        dev = self.device
        self._hist = torch.zeros((M * T - M // 2, 2), device=dev)
        self._parity = 0
        self._carry = torch.zeros((M, self.ovr), device=dev)
        self._pw_carry = torch.zeros((M, self.ovr), device=dev)
        self._prev = torch.zeros((M, 2), device=dev)
        self._abs_base = -self.ovr  # demod[0]'s absolute channel-sample idx
        self._last_seen = np.full(M, -10**12, np.int64)
        self.reports: List[BurstReport] = []
        self._tap = open(tap_demod_path, "ab") if tap_demod_path else None
        self.supervision_slots = tuple(int(k) for k in supervision_slots)
        if any(not 0 <= k < M for k in self.supervision_slots):
            raise ValueError(f"supervision_slots {self.supervision_slots} "
                             f"outside the bank's {M} slots")
        self.on_supervision = on_supervision
        self._sup_idx = torch.as_tensor(self.supervision_slots,
                                        dtype=torch.int64, device=dev)
        # demod samples short of a 10 ms frame, left from the previous
        # block's measurement
        self._sup_carry = (np.zeros((len(self.supervision_slots), 0),
                                    np.float32)
                           if self.supervision_slots else None)
        self.depth = max(1, pipeline_depth)
        self._inflight: List[dict] = []
        self._last_block_len = 0
        # non-hop-multiple tail buffered between pushes
        self._residue = None

    def push(self, x_block) -> List[BurstReport]:
        """Process one wideband block ((N, 2), any N); returns the new
        deduplicated burst reports -- of this block at depth 1, of
        blocks up to ``pipeline_depth``-1 behind otherwise.  The
        analyzer consumes whole hops (M/2 samples): a sub-hop tail is
        buffered and prepended to the next push."""
        P = self.M // 2
        if isinstance(x_block, torch.Tensor) and \
                x_block.device.type != "cpu" and x_block.device != self.device:
            raise ValueError(
                f"block on {x_block.device}, receiver on {self.device}: "
                "build the receiver with the device of its blocks")
        x = as_tensor(x_block, device=self.device)
        if self._residue is not None and self._residue.shape[0]:
            x = torch.cat([self._residue, x], dim=0)
        self._residue = None
        rem = x.shape[0] % P
        if rem:
            self._residue = x[x.shape[0] - rem:].clone()
            x = x[: x.shape[0] - rem]
        if x.shape[0] == 0:
            return []
        self._last_block_len = int(x.shape[0])
        blk = _rx_stream_block(x, self._hist, self._carry, self._prev,
                               self._pw_carry, self.spec, self._parity,
                               self.max_bursts, self.threshold,
                               self._search, self._front_end)
        self._hist, self._carry = blk["hist"], blk["carry"]
        self._prev, self._pw_carry = blk["prev"], blk["pw_carry"]
        dec = decoder.decode_bursts(blk["hard"], policy=self.policy,
                                    repeat_gate=self.spec.decode_repeat_gate)
        planes = (blk["starts"], blk["valid"], blk["quality"], dec.words,
                  dec.word_ok, dec.bad_symbols, dec.dcc_bits, blk["rssi"])
        # device tensors only: the host waits when the entry is drained;
        # the full planes stay referenced for the overflow fetch
        self._inflight.append(dict(
            comp=_compact_reports(planes, self.min_rssi, self.max_reports,
                                  self.require_word_a),
            full=planes,
            demod=blk["demod_new"] if self._tap is not None else None,
            sup_dem=(blk["demod_new"][self._sup_idx]
                     if self.supervision_slots else None),
            abs_base=self._abs_base))
        nh = x.shape[0] // P
        self._parity = (self._parity + nh) % 2
        self._abs_base += nh
        out: List[BurstReport] = []
        while len(self._inflight) >= self.depth:
            out.extend(self._drain_one(self._inflight.pop(0)))
        return out

    def flush(self, pad_tail: bool = False) -> List[BurstReport]:
        """Drain every in-flight block (end of stream).  ``pad_tail``:
        first push one zero block, so a burst pending in the carried
        overlap is completed against trailing silence and reported."""
        out: List[BurstReport] = []
        if pad_tail and self._last_block_len:
            out.extend(self.push(torch.zeros((self._last_block_len, 2),
                                             device=self.device)))
        elif self._residue is not None and self._residue.shape[0]:
            # a buffered sub-hop tail, against just enough zeros to
            # complete one hop
            pad = self.M // 2 - self._residue.shape[0] % (self.M // 2)
            out.extend(self.push(torch.zeros((pad, 2), device=self.device)))
        while self._inflight:
            out.extend(self._drain_one(self._inflight.pop(0)))
        if self._tap is not None:
            self._tap.flush()
        return out

    def close(self) -> None:
        """Close the demod tap file.  Idempotent."""
        if self._tap is not None:
            self._tap.close()
            self._tap = None

    def _drain_one(self, e: dict) -> List[BurstReport]:
        # the report fetch comes first: it is where a device failure
        # surfaces, before anything of the block is delivered
        cand = _candidates(e["comp"])
        if int(e["comp"]["n_valid"]) > len(cand[0]):
            # more deliverable slots than max_reports: fetch the full
            # planes (ascending flat c*K+k index, as below) so that no
            # report is dropped; counted after the fallible fetch
            cand = _candidates(_flatten_full(e["full"]))
            self.report_overflows += 1
        idx, cvalid, starts, quality, rssi_pb, words, ok, bad, dccs = cand
        if self._tap is not None and e["demod"] is not None:
            e["demod"].cpu().numpy().astype(np.float32).tofile(self._tap)
        if e["sup_dem"] is not None:
            self._sup_carry = deliver_supervision_frames(
                e["sup_dem"], self._sup_carry, self.spec,
                self.supervision_slots, self.on_supervision)
        out = []
        # ascending flat (c*K+k) index: the (c, k) order of the full planes
        for r in np.argsort(idx, kind="stable"):
            if not cvalid[r]:
                continue
            c = int(idx[r]) // self.max_bursts
            rssi = float(rssi_pb[r])
            if rssi < self.min_rssi:
                continue
            if self.require_word_a and not ok[r, 0]:
                continue
            abs_sample = e["abs_base"] + int(starts[r])
            # dedup: the same burst found again in the overlap
            if abs(abs_sample - self._last_seen[c]) < \
                    correlator.CAPTURE_SYMBOLS * self.sps // 2:
                continue
            self._last_seen[c] = abs_sample
            rep = BurstReport(c, abs_sample // self.sps, float(quality[r]),
                              words[r], ok[r], bad[r], rssi=rssi,
                              dcc=decode_dcc(dccs[r]))
            out.append(rep)
            if self.on_burst:
                self.on_burst(rep)
        self.reports.extend(out)
        return out


class MultichannelTransmitter:
    """Streaming wideband transmitter: one FOCC stream per control
    channel; the other bank slots are silent unless a baseband source is
    installed with ``set_channel_source``.  ``device``: where the band
    is synthesized, the current CUDA device unless another is named
    (without CUDA the default raises): a CUDA device runs the ``synth``
    kernel, ``device="cpu"`` its plain version.
    ``synthesize``: the synthesis, ``kernels.synth.synthesize_block``;
    ``synthesize_block_reference`` runs its plain version on any device
    (to compare the two)."""

    def __init__(self, spec: MultichannelSpec,
                 system: Optional[SystemConfig] = None,
                 control_channels: Optional[List[int]] = None,
                 device=None,
                 synthesize: Callable = synthesize_block):
        self.spec = spec
        self.system = system or SystemConfig()
        M = spec.num_channels
        self.M = M
        self.sps = spec.chan_sps
        self.device = resolve_device(device)
        ctrl = (control_channels if control_channels is not None
                else list(range(M)))
        self.focc: Dict[int, FoccStream] = {
            k: FoccStream(self.system, sps=self.sps) for k in ctrl}
        self._sources: Dict[int, Callable[[int], np.ndarray]] = {}
        self._state = chz.synthesizer_init(spec.chz_spec, device=self.device)
        self._accum = {k: 0 for k in ctrl}
        self._synthesize = synthesize

    def set_channel_source(self, k: int,
                           source: Callable[[int], np.ndarray]) -> None:
        """Install a baseband source for slot k: source(n) -> (n, 2)
        riq (e.g. a voice+SAT generator or an FVC burst stream)."""
        self._sources[k] = source

    def _baseband(self) -> torch.Tensor:
        """(hops, M, 2) channel plane of the next superframe: all control
        channels framed and modulated as one batch, then the sources."""
        if not self.focc:
            raise ValueError("no control channels configured")
        dev = self.device
        ks = sorted(self.focc)
        pairs = np.stack([self.focc[k].next_word_pairs() for k in ks])
        bits = focc_frame_bits(torch.as_tensor(pairs, device=dev))
        acc0 = torch.as_tensor([self._accum[k] for k in ks],
                               dtype=torch.int32, device=dev)
        # Manchester bits are DC-balanced, so the accumulator is a fixed
        # point; carried anyway
        bb, acc = fsk_manchester_baseband(bits, self.sps,
                                          self.spec.fm_sensitivity, acc0)
        self._accum.update(zip(ks, acc.cpu().tolist()))
        n_hops = bb.shape[1]
        # copied in place from the transposed view: no hop-major copy of
        # the basebands beside the plane (13 GB each at M = 32766)
        Y = torch.zeros((n_hops, self.M, 2), device=dev)
        Y.index_copy_(1, torch.as_tensor(ks, device=dev), bb.transpose(0, 1))
        if self._sources:
            sk = sorted(self._sources)
            src = np.stack([np.asarray(self._sources[k](n_hops), np.float32)
                            for k in sk], axis=1)
            Y[:, torch.as_tensor(sk, device=dev)] = torch.as_tensor(
                src, device=dev)
        return Y

    def next_block(self) -> torch.Tensor:
        """One superframe of wideband samples, (hops * M/2, 2) float32."""
        Y = self._baseband()
        x, carry = self._synthesize(Y, self.M, self.spec.taps_per_phase,
                                    self._state.hop_idx % 2,
                                    self._state.carry)
        self._state = chz.SynthesizerState(carry,
                                           self._state.hop_idx + Y.shape[0])
        return x
