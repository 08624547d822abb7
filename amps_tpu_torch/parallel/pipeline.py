"""The multichannel transmit and receive blocks, single device and
sharded over a ``(time, chan)`` worker mesh — the PyTorch port of
``amps_tpu.parallel.pipeline`` (``MultichannelSpec``,
``tx_multichannel_block``, ``rx_multichannel_block`` and its batched
small-bank form ``rx_multichannel_block_batched``; the sharded streaming
steps below).

  TX: word pairs (C, F, 2, 28)
    -> FOCC frame bits (C, F*463)                          [tx.focc]
    -> FSK baseband at the channel rate (C, n, 2)          [dsp.fm]
    -> synthesis channelizer -> wideband (n*M/2, 2)        [kernels.synth]

  RX: wideband (N, 2) or planar (2, N)
    -> analysis + discriminator + integrate-and-dump      [kernels.rx_phases]
       -> phase streams (C, sps, nsym), 384-hop power partials
    -> trigger correlation + greedy NMS                    [rx.correlator]
    -> capture with trigger gate, per-burst rssi           [rx.correlator]
    -> 5-repeat BCH word decode                            [rx.decoder]

The synthesis and RX stages 1-3 each run as a hand-written CUDA kernel
for a CUDA input and as its plain PyTorch version for a CPU input;
nothing else chooses.

Sharded: the wideband stages (synthesis, analysis) mix all channels, so
both mesh axes act as one flattened time ring of time*chan workers
(worker w = t*chan + c takes the w-th contiguous sub-block, with its
analysis halo and synthesis overlap-add along the ring); an all_to_all
inside each time row then reshards hops into channels, so row r holds
the r-th span of the block's channel samples with the channels split
over the chan ranks.  Each worker's analysis is the analysis kernel
(``kernels.analysis.analyze_block``, planar) and its synthesis the
synthesis kernel (``kernels.synth.synthesize_block``).  The front-end
kernels that fuse the discriminator cannot serve here: the sharded
discriminator needs the time-row halo, which exists only after the
all_to_all.  Every step carries its state explicitly (analyzer history
and synthesis carry at the ring level, the per-channel IQ overlap at the
row level, the RX and TX hop parities), so successive calls form one
continuous stream.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from amps_tpu_torch.config import PipelineConfig
from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.dsp.fm import (fsk_manchester_baseband,
                                   quadrature_demod_planar)
from amps_tpu_torch.kernels.analysis import analyze_block
from amps_tpu_torch.kernels.rx_phases import analyze_phases
from amps_tpu_torch.kernels.synth import synthesize_block
from amps_tpu_torch.parallel.halo import (RING, all_gather, all_to_all,
                                          from_last,
                                          halo_exchange_left_carry,
                                          overlap_add_with_carry)
from amps_tpu_torch.parallel.mesh import Mesh
from amps_tpu_torch.rx import correlator, decoder
from amps_tpu_torch.tx.focc import focc_frame_bits


@dataclasses.dataclass(frozen=True)
class MultichannelSpec:
    num_channels: int = 64        # C = M, channels of the bank
    taps_per_phase: int = 8
    pipe: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    # channel-transform tuning of the JAX package.  The port's front-end
    # kernel and its plain version compute the transform in f32 for
    # every spec: transform_bf16 and transform_split are accepted and
    # not used (bf16 wgmma / the two-stage split are later work).
    transform_bf16: bool = False
    transform_split: int = -1
    # any fold name of the JAX package (dsp.channelizer.FOLDS); the port
    # computes the bank fold for all of them
    fold: str = "conv"
    # io_bf16: phase streams and hard symbols in bfloat16
    io_bf16: bool = False
    # corr_bf16: trigger-correlation outputs and quality plane in bfloat16
    corr_bf16: bool = False
    # post-capture trigger gate: candidates whose sliced 74-symbol
    # trigger mismatches in more than this many places are invalid;
    # <0 disables
    max_trigger_errors: int = correlator.MAX_TRIGGER_ERRORS
    # erasure gate of the 5-repeat combining (rx/decoder.py); <0 disables
    repeat_gate: int = 6

    @property
    def decode_repeat_gate(self) -> Optional[int]:
        return None if self.repeat_gate < 0 else int(self.repeat_gate)

    @property
    def chz_spec(self) -> chz.ChannelizerSpec:
        return chz.ChannelizerSpec(self.num_channels, self.taps_per_phase,
                                   self.pipe.channel_spacing_hz)

    @property
    def chan_sps(self) -> int:
        return self.pipe.chan_sps  # 3 samples/Manchester symbol @ 60k

    @property
    def fm_sensitivity(self) -> float:
        """FSK phase step per ±1 symbol sample at the channel rate."""
        return 2.0 * np.pi * self.pipe.deviation_hz / self.pipe.chan_rate


def tx_multichannel_block(word_pairs, spec: MultichannelSpec):
    """(M, F, 2, 28) word pairs, one FOCC superframe per channel ->
    wideband float32 ((F*463*2*sps) * M/2, 2), on the input's device (a
    numpy input runs on the CPU).  The synthesis is the ``kernels.synth``
    wrapper, from a zero carry at hop 0."""
    bits = focc_frame_bits(word_pairs)
    dev = bits.device
    bb, _ = fsk_manchester_baseband(bits, spec.chan_sps,
                                    spec.fm_sensitivity)   # (M, n, 2)
    state = chz.synthesizer_init(spec.chz_spec, device=dev)
    x, _ = synthesize_block(bb.transpose(0, 1).contiguous(),
                            spec.num_channels, spec.taps_per_phase, 0,
                            state.carry)
    return x


def rx_multichannel_block(x, spec: MultichannelSpec, max_bursts: int = 2,
                          threshold: float = 0.55,
                          policy: str = "first_ok"):
    """Wideband (N, 2) — or planar (2, N) planes — float32 tensor ->
    per-channel decoded RECC bursts, on the input's device.

    Returns a dict with starts/valid/quality (C, K), words (C, K, 7, 36),
    word_ok (C, K, 7), dcc_bits (C, K, 7), bad_symbols (C, K, 8),
    chan_power (C,) and the per-burst rssi (C, K) over each capture's
    own 384-hop power blocks."""
    return _rx_block(x, spec, max_bursts, threshold, policy, analyze_phases)


def rx_multichannel_block_batched(xs, spec: MultichannelSpec,
                                  max_bursts: int = 2,
                                  threshold: float = 0.55,
                                  policy: str = "first_ok"):
    """Batched small-bank receive: xs (G, N, 2), G independent wideband
    streams through G copies of the M-channel bank in one call.  Returns
    the dict of ``rx_multichannel_block`` with a leading G axis.  A small
    bank alone leaves the card idle; several narrow bands a card is the
    deployment.  On a CUDA device the front end is one launch of the
    ``rx_phases`` kernel with the band as its grid's second axis; every
    later stage is batch-polymorphic."""
    if not isinstance(xs, torch.Tensor):
        raise TypeError("xs must be a torch.Tensor")
    if xs.ndim != 3 or xs.shape[-1] != 2:
        raise ValueError(f"xs must be (G, N, 2), got {tuple(xs.shape)}")
    return _rx_block(xs, spec, max_bursts, threshold, policy, analyze_phases)


def _rx_block(x, spec: MultichannelSpec, max_bursts: int, threshold: float,
              policy: str, front_end,
              search: Callable = correlator.find_bursts_phases):
    """rx_multichannel_block with stages 1-3 given as ``front_end`` and
    the trigger search as ``search`` (the kernel wrappers, or their plain
    versions for a same-device comparison); x (N, 2), planar (2, N), or G
    bands (G, N, 2)."""
    chz.check_fold(spec.fold)
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch.Tensor")
    M = spec.num_channels
    T = spec.taps_per_phase
    sps = spec.chan_sps
    planar_in = x.ndim == 2 and x.shape[0] == 2 and x.shape[1] != 2
    x = x.to(torch.float32)
    hist = chz.analyzer_init(spec.chz_spec, batch=tuple(x.shape[:-2]),
                             planar_in=planar_in, device=x.device).history
    x_ext = torch.cat([hist, x], dim=-1 if planar_in else -2).contiguous()
    phases, chan_power, pw_blk = front_end(
        x_ext, M, T, sps, hop0_parity=0,
        out_dtype=torch.bfloat16 if spec.io_bf16 else torch.float32)
    starts, valid, quality = search(phases, sps, max_bursts, threshold,
                                    out_bf16=spec.corr_bf16)
    lead = correlator.TRIGGER_SYMBOLS if spec.max_trigger_errors >= 0 else 0
    ext = correlator.extract_from_phases(
        phases, starts, sps,
        hard_dtype=torch.bfloat16 if spec.io_bf16 else torch.uint8,
        lead=lead)
    hard = ext[0]
    if spec.max_trigger_errors >= 0:
        valid = correlator.apply_trigger_gate_soft(
            valid, ext[2], spec.max_trigger_errors, starts, sps)
    dec = decoder.decode_bursts(hard, policy, spec.decode_repeat_gate)
    return {
        "starts": starts, "valid": valid, "quality": quality,
        "words": dec.words, "word_ok": dec.word_ok,
        "dcc_bits": dec.dcc_bits, "bad_symbols": dec.bad_symbols,
        "chan_power": chan_power,
        "rssi": correlator.burst_rssi_blocks(pw_blk, starts, sps),
    }


# ---------------------------------------------------------------------------
# sharded pipeline over a (time, chan) worker mesh
# ---------------------------------------------------------------------------

TX_SILENT, TX_FOCC, TX_SOURCE = 0, 1, 2   # per-channel TX slot modes


def full_demod_halo(spec: MultichannelSpec) -> int:
    """Demod-sample halo that keeps a burst spanning a time-row (or
    block) boundary whole inside the right-hand window: the trigger +
    capture extent, the single-device receiver's carried overlap."""
    return (correlator.TRIGGER_SYMBOLS
            + correlator.CAPTURE_SYMBOLS) * spec.chan_sps


def sharded_stream_state(spec: MultichannelSpec, demod_halo: int,
                         device=None) -> dict:
    """Zero carried state of the sharded steps on ``device`` (default the
    current CUDA device; the CPU only when named; a mesh's state lives
    on ``Mesh.device``):

    hist:      (L-P, 2) analyzer history, the previous block's tail
    iq_carry:  (2, M, demod_halo+1) per-channel IQ tail of the previous
               block (one extra sample seeds the discriminator)
    syn_carry: (L-P, 2) synthesis overlap-add tail
    parity:    RX hop parity at the block start (a host int: it follows
               from the block lengths)
    tx_parity: TX synthesis hop parity, apart from the RX one because
               with an external RX stream the two advance by different
               hop counts"""
    M, T = spec.num_channels, spec.taps_per_phase
    keep = M * T - M // 2
    dev = resolve_device(device)
    return {"hist": torch.zeros((keep, 2), device=dev),
            "iq_carry": torch.zeros((2, M, demod_halo + 1), device=dev),
            "syn_carry": torch.zeros((keep, 2), device=dev),
            "parity": 0, "tx_parity": 0}


def sharded_state_from_arrays(arrays, device=None) -> dict:
    """A ``sharded_stream_state`` given as numpy arrays (the JAX
    package's state, or a checkpoint's) as tensors on ``device``."""
    dev = resolve_device(device)
    st = {k: torch.tensor(np.asarray(arrays[k], np.float32), device=dev)
          for k in ("hist", "iq_carry", "syn_carry")}
    st["parity"] = int(arrays["parity"]) % 2
    st["tx_parity"] = int(arrays["tx_parity"] if "tx_parity" in arrays
                          else arrays["parity"]) % 2
    return st


def _mesh_consts(mesh: Mesh, spec: MultichannelSpec):
    M, T = spec.num_channels, spec.taps_per_phase
    tsize, csize = mesh.spec.time, mesh.spec.chan
    if M % csize:
        raise ValueError(f"{M} channels do not split over {csize} chan ranks")
    chz.check_fold(spec.fold)
    return M, T, M * T, M // 2, tsize, csize, M // csize


def _worker_blocks(mesh: Mesh, x, hop: int):
    """One wideband block as the workers' contiguous sub-blocks, each
    float32 on its worker's device: ``x`` is the whole (N, 2) block (of
    which each process takes its workers' share) or already a list of one
    sub-block a worker."""
    if isinstance(x, (list, tuple)):
        return list(x)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, np.float32))
    n = x.shape[0] // mesh.size
    if x.ndim != 2 or x.shape[1] != 2 or n * mesh.size != x.shape[0] \
            or n % hop:
        raise ValueError(f"block of shape {tuple(x.shape)}: the length must "
                         f"be a multiple of workers ({mesh.size}) * hop "
                         f"({hop})")
    w0 = mesh.worker(0)[0]
    return [x[(w0 + i) * n:(w0 + i + 1) * n].to(device=d, dtype=torch.float32)
            for i, d in enumerate(mesh.devices)]


def _assemble(mesh: Mesh, parts) -> torch.Tensor:
    """(rows, M, ...) on ``mesh.device`` from the workers' (c_loc, ...)
    pieces: the channel ranks joined within each of this process's time
    rows."""
    C, dev = mesh.spec.chan, mesh.device
    return torch.stack([torch.cat([parts[r * C + c].to(dev)
                                   for c in range(C)])
                        for r in range(mesh.rows)])


def make_sharded_rx_stream_step(mesh: Mesh, spec: MultichannelSpec,
                                demod_halo: Optional[int] = None,
                                max_bursts: int = 2,
                                threshold: float = 0.55,
                                policy: str = "first_ok",
                                supervision_slots: tuple = ()):
    """Sharded streaming receive step: (x, state) -> (out, new_state).

    x: (N, 2) wideband, N a multiple of workers * hop (or one sub-block a
    worker, as the transmit side hands it over); state from
    ``sharded_stream_state`` on ``mesh.device``.  out: tensors on
    ``mesh.device`` with a leading axis of this process's time rows:
    starts/valid/quality (rows, M, K), with starts local to each row's
    extended demod window (absolute channel sample = row*Nh_row -
    demod_halo + start), words (rows, M, K, 7, 36), word_ok, dcc_bits,
    bad_symbols, rssi and chan_power (rows, M).

    Each worker analyzes its sub-block with the analysis kernel at its own
    hop parity, (parity + w*n_sub) % 2; the all_to_all hands rank c the
    channels [c*c_loc, (c+1)*c_loc) over its row's whole span; the
    time-row halo of ``demod_halo`` + 1 channel samples (the previous
    row's, or the carried block tail for row 0) lets a burst that spans a
    row or block boundary decode whole; one cut off by its window is
    invalid there and found whole by the next window.

    ``supervision_slots``: bank slots whose fresh demod samples are also
    returned, out["sup_demod"] (rows, n_slots, Nh_row) float32, gathered
    from the chan rank that owns each slot."""
    M, T, L, P, tsize, csize, c_loc = _mesh_consts(mesh, spec)
    sps = spec.chan_sps
    if demod_halo is None:
        demod_halo = full_demod_halo(spec)
    halo_n = demod_halo + 1
    slots = tuple(int(s) for s in supervision_slots)
    if any(not 0 <= s < M for s in slots):
        raise ValueError(f"supervision_slots {slots} outside the bank's "
                         f"{M} slots")
    lead = correlator.TRIGGER_SYMBOLS if spec.max_trigger_errors >= 0 else 0
    hard_dtype = torch.bfloat16 if spec.io_bf16 else torch.uint8

    def channels(ymine, yext):
        """One worker's per-channel stages on its rows of the time row:
        discriminator, power blocks, trigger search, completeness guard,
        capture, trigger gate, decode.  Returns (planes, demod)."""
        if spec.io_bf16:
            yext = yext.to(torch.bfloat16)
        demod, _, pw = quadrature_demod_planar(yext[0], yext[1],
                                               return_power="series")
        demod = demod[:, 1:]                             # drop the seed
        pw_blk = correlator.window_power_blocks([pw[:, 1:]])
        # band power of the fresh samples: the discriminator's conjugate
        # product, as the single-device receiver reports it
        fr, fi = ymine[0], ymine[1]
        sr = yext[0][:, halo_n - 1:-1].to(torch.float32)
        si = yext[1][:, halo_n - 1:-1].to(torch.float32)
        re, im = fr * sr + fi * si, fi * sr - fr * si
        chan_power = torch.sqrt(torch.mean(re * re + im * im, dim=-1))
        dsp = demod.to(torch.bfloat16) if spec.io_bf16 else demod
        phases = correlator.symbol_phase_streams(dsp, sps)
        starts, valid, quality = correlator.find_bursts_phases(
            phases, sps, max_bursts, threshold, out_bf16=spec.corr_bf16)
        # completeness guard: a capture cut off by this window is found
        # whole by the next row (through its halo) or the next block
        valid = valid & (starts + correlator.CAPTURE_SYMBOLS * sps
                         <= demod.shape[-1])
        rssi = correlator.burst_rssi_blocks(pw_blk, starts, sps)
        ext = correlator.extract_from_phases(phases, starts, sps,
                                             hard_dtype=hard_dtype, lead=lead)
        if spec.max_trigger_errors >= 0:
            valid = correlator.apply_trigger_gate_soft(
                valid, ext[2], spec.max_trigger_errors, starts, sps)
        dec = decoder.decode_bursts(ext[0], policy, spec.decode_repeat_gate)
        return {"starts": starts, "valid": valid, "quality": quality,
                "words": dec.words, "word_ok": dec.word_ok,
                "chan_power": chan_power, "dcc_bits": dec.dcc_bits,
                "bad_symbols": dec.bad_symbols, "rssi": rssi}, demod

    def step(x, state):
        parts = _worker_blocks(mesh, x, P)
        n_sub = parts[0].shape[0] // P
        if any(p.shape != parts[0].shape for p in parts) \
                or n_sub * P != parts[0].shape[0]:
            raise ValueError("block length must be a multiple of workers * "
                             "hop")
        if parts[0].shape[0] < L - P:
            raise ValueError(f"worker sub-block {parts[0].shape[0]} < "
                             f"analyzer history {L - P}")
        if n_sub * csize < halo_n:
            raise ValueError(f"time-row demod span {n_sub * csize} < demod "
                             f"halo {halo_n}: use bigger blocks or a smaller "
                             f"mesh time axis")
        parity, w0 = int(state["parity"]), mesh.worker(0)[0]
        x_ext = halo_exchange_left_carry(mesh, parts, L - P, RING,
                                         state["hist"])
        ypl = [analyze_block(xe, M, T, (parity + (w0 + i) * n_sub) % 2,
                             planar=True)                # (2, M, n_sub)
               for i, xe in enumerate(x_ext)]
        ymine = all_to_all(mesh, ypl, "chan", split_axis=1,
                           concat_axis=2)                # (2, c_loc, Nh_row)
        # local worker i is chan rank i % csize (whole rows a process)
        carry = state["iq_carry"]
        yext = halo_exchange_left_carry(
            mesh, ymine, halo_n, "time",
            [carry[:, (i % csize) * c_loc:(i % csize + 1) * c_loc]
             for i in range(len(ymine))], sample_axis=2)
        res = [channels(a, b) for a, b in zip(ymine, yext)]
        out = {k: _assemble(mesh, [r[0][k] for r in res]) for k in res[0][0]}
        if slots:
            fresh = n_sub * csize
            out["sup_demod"] = torch.stack([torch.stack([
                res[r * csize + s // c_loc][1][s % c_loc,
                                               -fresh:].to(mesh.device)
                for s in slots]) for r in range(mesh.rows)])
        # only the last worker's wideband tail and the last row's IQ tails
        # carry into the next block
        new_state = dict(state)
        new_state.update(
            hist=from_last(mesh, [xe[xe.shape[0] - (L - P):] for xe in x_ext]),
            iq_carry=from_last(mesh, [y[:, :, -halo_n:] for y in ymine],
                               dim=1),
            parity=(parity + n_sub * mesh.size) % 2)
        return out, new_state

    return step


def make_sharded_bs_stream_step(mesh: Mesh, spec: MultichannelSpec,
                                demod_halo: Optional[int] = None,
                                max_bursts: int = 2,
                                threshold: float = 0.55,
                                policy: str = "first_ok",
                                rx_external: bool = False,
                                tx_sources: bool = False,
                                supervision_slots: tuple = ()):
    """Sharded streaming full step: TX words -> wideband -> decode.

    (word_pairs, state [, src_mode, src_bb] [, x_rx]) -> (out, new_state),
    the argument list of the JAX package's step.  word_pairs: (M, F, 2,
    28); each chan rank frames and FSK-modulates its own channels, an
    all_gather hands every worker all M, and worker w synthesizes hops
    [w*n_sub, (w+1)*n_sub) with the synthesis kernel from a zero carry,
    at hop parity (tx_parity + w*n_sub) % 2; its tail is added onto the
    next worker's head (the first worker's gets the carried block tail).
    out["tx_wideband"] is the block on ``mesh.device`` (this process's
    workers' share).  The RX side consumes that wideband (loopback) or,
    with ``rx_external``, the ``x_rx`` argument (reverse-band traffic)
    while TX still synthesizes and carries its stream: the full-duplex
    base station.

    With ``tx_sources`` the step takes two more arguments: src_mode (M,)
    TX_SILENT | TX_FOCC | TX_SOURCE per slot, and src_bb (n_hops, M, 2)
    source baseband (voice + SAT or FVC burst FM, e.g.
    ``runtime.sources.VoiceFvcSlot``) for the TX_SOURCE slots.  Without
    it every channel transmits FOCC.

    The TX hop count (frames * 463 * 2 * sps) must divide by the worker
    ring: zero padding would put silence gaps in the continuous
    wideband."""
    M, T, L, P, tsize, csize, c_loc = _mesh_consts(mesh, spec)
    sps = spec.chan_sps
    if demod_halo is None:
        demod_halo = full_demod_halo(spec)
    rx_step = make_sharded_rx_stream_step(mesh, spec, demod_halo,
                                          max_bursts, threshold, policy,
                                          supervision_slots)
    Wk = mesh.size

    def baseband(word_pairs, mode, src):
        """Each chan rank's (c_loc, n_hops, 2) TX baseband, made on the
        device of its worker in this process's first row."""
        wp = torch.as_tensor(word_pairs)
        out = []
        for c in range(csize):
            dev, lo, hi = mesh.devices[c], c * c_loc, (c + 1) * c_loc
            bb, _ = fsk_manchester_baseband(focc_frame_bits(wp[lo:hi].to(dev)),
                                            sps, spec.fm_sensitivity)
            if mode is not None:
                sel = torch.as_tensor(mode)[lo:hi].to(dev)[:, None, None]
                s = torch.as_tensor(src)[:, lo:hi].to(
                    device=dev, dtype=torch.float32).transpose(0, 1)
                bb = (torch.where(sel == TX_FOCC, bb, 0.0)
                      + torch.where(sel == TX_SOURCE, s, 0.0))
            out.append(bb)
        return out

    def tx(word_pairs, syn_carry, parity, mode=None, src=None):
        bbs = baseband(word_pairs, mode, src)
        bb_all = all_gather(mesh, [bbs[i % csize].to(d)
                                   for i, d in enumerate(mesh.devices)],
                            "chan", dim=0)               # (M, n_hops, 2)
        n = bb_all[0].shape[1]
        if n % Wk:
            raise ValueError(
                f"TX hop stream ({n} = frames*463*2*sps) must divide by the "
                f"worker ring ({Wk}): pick a frame count with "
                f"frames*{463 * 2 * sps} % {Wk} == 0 -- zero padding would "
                f"insert silence gaps in the continuous TX wideband")
        n_sub, w0 = n // Wk, mesh.worker(0)[0]
        xs, tails = [], []
        for i, b in enumerate(bb_all):
            w = w0 + i
            Yl = b[:, w * n_sub:(w + 1) * n_sub].transpose(0, 1).contiguous()
            x, tail = synthesize_block(
                Yl, M, T, (parity + w * n_sub) % 2,
                torch.zeros((L - P, 2), device=mesh.devices[i]))
            xs.append(x)
            tails.append(tail)
        return overlap_add_with_carry(mesh, xs, tails, RING, syn_carry), \
            tails, n

    def step(word_pairs, state, tx_extra=(), x_rx=None):
        tx_parity = int(state.get("tx_parity", state["parity"]))
        xs, tails, n = tx(word_pairs, state["syn_carry"], tx_parity,
                          *tx_extra)
        out, new_state = rx_step(x_rx if rx_external else xs, state)
        new_state["syn_carry"] = from_last(mesh, tails)
        new_state["tx_parity"] = (tx_parity + n) % 2
        out["tx_wideband"] = torch.cat([x.to(mesh.device) for x in xs])
        return out, new_state

    if tx_sources and rx_external:
        return lambda wp, st, mode, src, x_rx: step(wp, st, (mode, src), x_rx)
    if tx_sources:
        return lambda wp, st, mode, src: step(wp, st, (mode, src))
    if rx_external:
        return lambda wp, st, x_rx: step(wp, st, (), x_rx)
    return lambda wp, st: step(wp, st)


def make_sharded_closed_loop_stream(mesh: Mesh, spec: MultichannelSpec,
                                    nblocks: int, frames: int = 2,
                                    max_bursts: int = 2,
                                    threshold: float = 0.55,
                                    demod_halo: Optional[int] = None,
                                    rx_external: bool = False):
    """The sharded closed loop: ``nblocks`` consecutive full-duplex steps
    (``make_sharded_bs_stream_step``: framing, FSK, synthesis kernel,
    analysis kernel, all_to_all, demod, trigger search, decode) with all
    carried state on the device and no host read between blocks.

    Returns (run, block_samples): ``run(word_pairs[, x_rx])`` with
    word_pairs (M, frames, 2, 28) -> (n_valid, quality_max, n_word_ok),
    tensors of length nblocks on ``mesh.device`` that the caller fetches
    once.  Block k equals the k-th manual step call on the same state.
    With ``rx_external`` run takes x_rx (nblocks, N_rx, 2): each block
    transmits one TX block and decodes one reverse-band block."""
    if demod_halo is None:
        demod_halo = full_demod_halo(spec)
    step = make_sharded_bs_stream_step(mesh, spec, demod_halo, max_bursts,
                                       threshold, rx_external=rx_external)
    M, dev = spec.num_channels, mesh.device
    n_hops = frames * 463 * 2 * spec.chan_sps
    if n_hops % mesh.size:
        raise ValueError(f"{n_hops} hops a block do not divide by "
                         f"{mesh.size} workers")
    block_samples = n_hops * (M // 2)

    def run(word_pairs, x_rx=None):
        # the inputs cross to the device once, before the loop
        wp = torch.as_tensor(np.asarray(word_pairs) if not isinstance(
            word_pairs, torch.Tensor) else word_pairs).to(dev)
        if tuple(wp.shape) != (M, frames, 2, 28):
            raise ValueError(f"word_pairs must be ({M}, {frames}, 2, 28), "
                             f"got {tuple(wp.shape)}")
        if rx_external:
            xr = torch.as_tensor(np.asarray(x_rx, np.float32) if not
                                 isinstance(x_rx, torch.Tensor) else x_rx
                                 ).to(device=dev, dtype=torch.float32)
            if xr.shape[0] != nblocks:
                raise ValueError(f"x_rx holds {xr.shape[0]} blocks, the "
                                 f"loop runs {nblocks}")
        st = sharded_stream_state(spec, demod_halo, dev)
        sums = []
        for b in range(nblocks):
            out, st = step(wp, st, xr[b]) if rx_external else step(wp, st)
            sums.append((out["valid"].sum(),
                         out["quality"].to(torch.float32).max(),
                         out["word_ok"].sum()))
        return tuple(torch.stack(v) for v in zip(*sums))

    return run, block_samples


def make_sharded_bs_step(mesh: Mesh, spec: MultichannelSpec,
                         demod_halo: Optional[int] = None,
                         max_bursts: int = 2, threshold: float = 0.55):
    """One-shot sharded full step (the stream step from zero state), for
    mesh checks: (word_pairs) -> (starts, valid, quality, words,
    word_ok).  Streaming callers use ``make_sharded_bs_stream_step``."""
    if demod_halo is None:
        demod_halo = full_demod_halo(spec)
    stream = make_sharded_bs_stream_step(mesh, spec, demod_halo, max_bursts,
                                         threshold)

    def step(word_pairs):
        out, _ = stream(word_pairs, sharded_stream_state(spec, demod_halo,
                                                         mesh.device))
        return (out["starts"], out["valid"], out["quality"], out["words"],
                out["word_ok"])

    return step
