"""The multichannel transmit and receive blocks, single device — the
PyTorch port of ``amps_tpu.parallel.pipeline`` (``MultichannelSpec``,
``tx_multichannel_block``, ``rx_multichannel_block`` and its batched
small-bank form ``rx_multichannel_block_batched``).

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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from amps_tpu_torch.config import PipelineConfig
from amps_tpu_torch.dsp import channelizer as chz
from amps_tpu_torch.dsp.fm import fsk_manchester_baseband
from amps_tpu_torch.kernels.rx_phases import analyze_phases
from amps_tpu_torch.kernels.synth import synthesize_block
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
              policy: str, front_end):
    """rx_multichannel_block with stages 1-3 given as ``front_end`` (the
    kernel wrapper, or its plain version for a same-device comparison);
    x (N, 2), planar (2, N), or G bands (G, N, 2)."""
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
    starts, valid, quality = correlator.find_bursts_phases(
        phases, sps, max_bursts, threshold, out_bf16=spec.corr_bf16)
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
