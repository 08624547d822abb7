"""The sharded streaming receiver and transceiver, the PyTorch port of
``amps_tpu.parallel.stream``.

``ShardedReceiver`` pushes whole wideband blocks through the sharded
receive step (``parallel.pipeline.make_sharded_rx_stream_step``) and
keeps the single-device receiver's report discipline: rows in time
order, the completeness guard (on the device), dedup by absolute burst
position and the rssi gate on each burst's own capture.  N pushed blocks
give the reports of a ``runtime.streamer.MultichannelReceiver`` fed the
same continuous stream in row-sized blocks.

``ShardedTransceiver`` adds the transmit side of the full-duplex step:
FOCC superframes from host word queues on the control channels, source
basebands (voice + SAT or FVC bursts) on the slots given one, silence
elsewhere.

Reports are selected on the device (the top ``max_reports`` deliverable
slots of each time row) and fetched first, with the full planes when a
row has more deliverable slots than that, so no report is ever dropped;
only then are the supervision frames measured and delivered.  A device
failure in any fetch therefore delivers nothing of the block (the
order of the single-device receiver; the JAX package fetches the full
planes after the supervision frames went out).
"""

from __future__ import annotations

from math import gcd
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from amps_tpu_torch.config import SystemConfig
from amps_tpu_torch.device import as_tensor
from amps_tpu_torch.parallel.mesh import Mesh
from amps_tpu_torch.parallel.pipeline import (TX_FOCC, TX_SOURCE,
                                              MultichannelSpec,
                                              full_demod_halo,
                                              make_sharded_bs_stream_step,
                                              make_sharded_rx_stream_step,
                                              sharded_stream_state)
from amps_tpu_torch.runtime import streamer
from amps_tpu_torch.runtime.streamer import (BurstReport, decode_dcc,
                                             deliver_supervision_frames)
from amps_tpu_torch.rx import correlator
from amps_tpu_torch.tx.focc import FoccStream

_PLANES = ("starts", "valid", "quality", "words", "word_ok", "bad_symbols",
           "dcc_bits", "rssi")


class ShardedReceiver:
    """Streaming wideband receiver over a ``(time, chan)`` worker mesh.

    Push (N, 2) wideband blocks with N a multiple of workers * hop; each
    block is processed as ``time`` consecutive row windows, each with a
    carried left halo of ``demod_halo`` channel samples (default the
    whole trigger + capture overlap), so bursts spanning row or block
    boundaries decode whole.  Block lengths may change between pushes.
    The carried state and the assembled outputs live on ``mesh.device``;
    host data is copied there, and a block on another card raises.
    Across processes each process reports the bursts of its own rows.

    ``supervision_slots`` + ``on_supervision``: SAT/ST supervision of
    those bank slots on every block.  The step gathers their fresh demod
    rows; they are joined in time order, the sub-frame leftover is carried
    across blocks as the single-device receiver does, and the callback
    gets (slot, levels (F, 5), power (F,)) per slot, ready for
    ``BaseStation.push_supervision``."""

    def __init__(self, mesh: Mesh, spec: MultichannelSpec,
                 on_burst: Optional[Callable[[BurstReport], None]] = None,
                 max_bursts: int = 4, threshold: float = 0.55,
                 policy: str = "majority",
                 demod_halo: Optional[int] = None,
                 min_rssi: float = 0.0,
                 require_word_a: bool = True,
                 supervision_slots: tuple = (),
                 on_supervision: Optional[Callable] = None,
                 max_reports: int = 64):
        self.spec = spec
        self.M = spec.num_channels
        self.sps = spec.chan_sps
        self.ovr = (full_demod_halo(spec) if demod_halo is None
                    else demod_halo)
        self.min_rssi = min_rssi
        self.require_word_a = require_word_a
        self.on_burst = on_burst
        self.mesh = mesh
        self.device = mesh.device
        self.max_bursts = max_bursts
        self.threshold = threshold
        self.policy = policy
        self.supervision_slots = tuple(int(k) for k in supervision_slots)
        self.on_supervision = on_supervision
        self._sup_carry = (np.zeros((len(self.supervision_slots), 0),
                                    np.float32)
                           if self.supervision_slots else None)
        self.tsize = mesh.spec.time
        # report slots fetched per time row before the full planes are
        self.max_reports = min(max_reports, self.M * max_bursts)
        self.report_overflows = 0
        self._hop = self.M // 2
        self._step = self._make_step()
        self._state = sharded_stream_state(spec, self.ovr, self.device)
        # channel samples consumed so far (block lengths may vary)
        self._nh_done = 0
        self._last_seen = np.full(self.M, -10**12, np.int64)
        self._last_block_len = 0
        self._flushed = False
        self.reports: List[BurstReport] = []

    def _make_step(self):
        return make_sharded_rx_stream_step(
            self.mesh, self.spec, self.ovr, self.max_bursts,
            self.threshold, self.policy, self.supervision_slots)

    def _block(self, x_block) -> torch.Tensor:
        if self._flushed:
            raise RuntimeError("push after flush()")
        if isinstance(x_block, torch.Tensor) and \
                x_block.device.type != "cpu" and x_block.device != self.device:
            raise ValueError(
                f"block on {x_block.device}, mesh on {self.device}: build "
                "the mesh with the device of its blocks")
        x = as_tensor(x_block, device=self.device)
        self._last_block_len = int(x.shape[0])
        return x

    def push(self, x_block) -> List[BurstReport]:
        """Process one wideband block; returns its new (deduplicated)
        burst reports in time order."""
        x = self._block(x_block)
        out, self._state = self._step(x, self._state)
        return self._deliver(out, int(x.shape[0]))

    def _deliver(self, out: dict, n_samples: int) -> List[BurstReport]:
        cand = self._fetch(out)
        self._push_supervision(out)
        return self._extract_reports(cand, n_samples)

    def _fetch(self, out: dict):
        """The host candidates of each time row: the compacted reports,
        or, when a row has more deliverable slots than ``max_reports``,
        the full planes of every row (counted in ``report_overflows``
        after the fetch, so a replayed block cannot count twice)."""
        planes = tuple(out[k] for k in _PLANES)
        comp = streamer._compact_reports_rows(planes, self.min_rssi,
                                              self.max_reports,
                                              self.require_word_a)
        cand = [streamer._candidates(c) for c in comp]
        if any(int(c["n_valid"]) > self.max_reports for c in comp):
            cand = [streamer._candidates(streamer._flatten_full(
                tuple(p[r] for p in planes))) for r in range(len(comp))]
            self.report_overflows += 1
        return cand

    def _push_supervision(self, out: dict) -> None:
        """The watched slots' rows in time order through the framed tone
        measurement, with the sub-frame leftover carried."""
        if not self.supervision_slots:
            return
        sup = out["sup_demod"]                           # (rows, S, nh_row)
        dem = torch.cat(list(sup), dim=-1)
        self._sup_carry = deliver_supervision_frames(
            dem, self._sup_carry, self.spec, self.supervision_slots,
            self.on_supervision)

    def _extract_reports(self, cand, n_samples: int) -> List[BurstReport]:
        """Rows in time order, the rssi and word-A gates, dedup by absolute
        position against everything reported before."""
        nh_row = (n_samples // self._hop) // self.tsize
        K = self.max_bursts
        new: List[BurstReport] = []
        for r, row in enumerate(cand):
            # absolute channel-sample index of this row's window[0]
            base = (self._nh_done + (self.mesh.row0 + r) * nh_row
                    - self.ovr)
            idx, cvalid, starts, quality, rssi_pb, words, ok, bad, dccs = row
            # ascending flat c*K+k index: the single-device receiver's
            # delivery order and dedup retention
            for j in np.argsort(idx, kind="stable"):
                if not cvalid[j]:
                    continue
                c = int(idx[j]) // K
                rssi = float(rssi_pb[j])
                if rssi < self.min_rssi:
                    continue
                if self.require_word_a and not ok[j, 0]:
                    continue
                abs_sample = base + int(starts[j])
                if abs(abs_sample - self._last_seen[c]) < \
                        correlator.CAPTURE_SYMBOLS * self.sps // 2:
                    continue
                self._last_seen[c] = abs_sample
                rep = BurstReport(c, abs_sample // self.sps,
                                  float(quality[j]), words[j], ok[j], bad[j],
                                  rssi=rssi, dcc=decode_dcc(dccs[j]))
                new.append(rep)
                if self.on_burst:
                    self.on_burst(rep)
        self._nh_done += self.tsize * nh_row
        self.reports.extend(new)
        return new

    def _drain_zeros(self):
        """One zero block of the last pushed block's length through
        ``push``, for flush(); None when nothing was pushed."""
        if self._flushed:
            return None
        self._flushed = True
        if self._last_block_len == 0:
            return None
        zeros = torch.zeros((self._last_block_len, 2), device=self.device)
        self._flushed = False
        try:
            return self.push(zeros)
        finally:
            self._flushed = True

    def flush(self) -> List[BurstReport]:
        """End of stream: a burst pending in the carried overlap (its
        capture past the last pushed block) is completed against trailing
        silence and reported.  After flush() the receiver is closed."""
        return self._drain_zeros() or []


class ShardedTransceiver(ShardedReceiver):
    """The full-duplex sharded base station: the mesh counterpart of
    ``MultichannelTransmitter`` + ``MultichannelReceiver`` in one step.

    ``push(x_rx)`` -> (tx_wideband, reports): one block of the continuous
    TX stream (``superframes_per_block`` superframes, by default the
    fewest whose hop count divides by the worker ring, so the wideband is
    gapless), on ``mesh.device``, and the reverse-band bursts decoded
    from ``x_rx``."""

    def __init__(self, mesh: Mesh, spec: MultichannelSpec,
                 system: Optional[SystemConfig] = None,
                 control_channels=None,
                 superframes_per_block: Optional[int] = None,
                 **rx_kwargs):
        self.system = system or SystemConfig()
        super().__init__(mesh, spec, **rx_kwargs)
        M, Wk = spec.num_channels, mesh.size
        ctrl = (list(control_channels) if control_channels is not None
                else list(range(M)))
        self.focc: Dict[int, FoccStream] = {
            k: FoccStream(self.system, sps=self.sps) for k in ctrl}
        F = next(iter(self.focc.values())).frames_per_superframe
        hops_per_sf = F * 463 * 2 * self.sps
        if superframes_per_block is None:
            superframes_per_block = Wk // gcd(hops_per_sf, Wk)
        if superframes_per_block * hops_per_sf % Wk:
            raise ValueError(f"{superframes_per_block} superframes of "
                             f"{hops_per_sf} hops do not divide by {Wk} "
                             f"workers")
        self.superframes_per_block = superframes_per_block
        self.frames_per_block = F * superframes_per_block
        self.n_hops_block = hops_per_sf * superframes_per_block
        self._sources: Dict[int, Callable[[int], np.ndarray]] = {}
        self._mode = torch.zeros(M, dtype=torch.int32)   # TX_SILENT
        self._mode[ctrl] = TX_FOCC

    def _make_step(self):
        return make_sharded_bs_stream_step(
            self.mesh, self.spec, self.ovr, self.max_bursts,
            self.threshold, self.policy, rx_external=True,
            tx_sources=True, supervision_slots=self.supervision_slots)

    def set_channel_source(self, k: int,
                           source: Callable[[int], np.ndarray]) -> None:
        """Install a baseband source for slot k: source(n_hops) ->
        (n_hops, 2) riq (e.g. ``runtime.sources.VoiceFvcSlot``)."""
        if k in self.focc:
            raise ValueError(f"slot {k} already carries FOCC")
        self._sources[k] = source
        self._mode[k] = TX_SOURCE

    def push(self, x_rx):
        """One full-duplex block: the next ``superframes_per_block``
        superframes of the TX mix and one decoded reverse-band block.
        Returns (tx_wideband, reports)."""
        x = self._block(x_rx)
        M, dev = self.M, self.device
        wp = np.zeros((M, self.frames_per_block, 2, 28), np.uint8)
        for k, st in self.focc.items():
            wp[k] = np.concatenate(
                [st.next_word_pairs()
                 for _ in range(self.superframes_per_block)], axis=0)
        # the source plane is made on the device: only the source slots
        # cross from the host
        src = torch.zeros((self.n_hops_block, M, 2), device=dev)
        for k, source in self._sources.items():
            src[:, k] = torch.as_tensor(
                np.asarray(source(self.n_hops_block), np.float32), device=dev)
        out, self._state = self._step(torch.as_tensor(wp, device=dev),
                                      self._state, self._mode.to(dev), src, x)
        return out["tx_wideband"], self._deliver(out, int(x.shape[0]))

    def flush(self) -> List[BurstReport]:
        """RX end of stream (see ShardedReceiver.flush).  The TX side
        synthesizes one more block while draining, as an always-on
        transmitter does; that block is discarded."""
        res = self._drain_zeros()
        return res[1] if res else []
