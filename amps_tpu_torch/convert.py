"""Carry the JAX side's state across to the port.

The system has no learned weights.  Its constant tables (prototype
taps, DFT matrices, trigger template and detection operators, syndrome
matrix and decode LUT) are rebuilt in numpy by the port itself and held
bit-equal to the JAX package's by the tests; what crosses over is the
carried streaming state: a JAX receiver's or transmitter's block k
continues as the port's block k+1.
"""

from __future__ import annotations

import numpy as np
import torch

from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.dsp.channelizer import AnalyzerState
from amps_tpu_torch.parallel.pipeline import sharded_state_from_arrays
from amps_tpu_torch.runtime.state import restore_receiver, restore_transmitter


def analyzer_state_from_numpy(history, hop_idx: int,
                              device=None) -> AnalyzerState:
    """A JAX ``AnalyzerState`` (history as numpy, hop index) as the port's,
    so a JAX receiver's block k continues as the port's block k+1; on
    ``device`` (default the current CUDA device, the CPU when named)."""
    hist = torch.tensor(np.asarray(history, dtype=np.float32),
                        device=resolve_device(device))
    return AnalyzerState(hist, int(hop_idx))


def receiver_state_from_jax(snapshot, rx) -> None:
    """Restore the numpy dict of ``amps_tpu.runtime.state.
    snapshot_receiver`` (hist, parity, carry, prev, pw_carry, abs_base,
    last_seen, sup_carry; the JAX package snapshots no sub-hop residue)
    into the port's MultichannelReceiver ``rx`` of the same spec."""
    snap = {k: snapshot[k] for k in ("kind", "hist", "parity", "carry",
                                     "prev", "pw_carry", "abs_base",
                                     "last_seen")}
    if "sup_carry" in snapshot:
        snap["sup_carry"] = snapshot["sup_carry"]
    snap["residue"] = np.zeros((0, 2), np.float32)
    snap["last_block_len"] = np.int64(0)
    restore_receiver(snap, rx)


def transmitter_state_from_jax(arrays, tx) -> None:
    """Restore the arrays of ``amps_tpu.runtime.state.save_transmitter``
    (synthesis carry, hop index, phase accumulators, FOCC queues; pass
    ``np.load(path)``) into the port's MultichannelTransmitter ``tx``
    with the same control channels."""
    restore_transmitter(arrays, tx)


def closed_loop_state_from_numpy(syn_carry, hist, carry, prev,
                                 device=None) -> dict:
    """The carried state of the JAX closed loop's scan (synthesis carry
    and analyzer history (L-P, 2), demod overlap (M, carry_hops),
    previous channel sample (M, 2), as numpy) as the state dict of the
    port's ``runtime.streamer.closed_loop_block``, so the port's block
    k+1 continues a JAX block k; on ``device`` (default the current CUDA
    device, the CPU when named)."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=dev)
            for k, v in (("syn_carry", syn_carry), ("hist", hist),
                         ("carry", carry), ("prev", prev))}


def sharded_state_from_jax(state, device=None) -> dict:
    """A JAX ``sharded_stream_state`` (hist, iq_carry, syn_carry, parity,
    tx_parity; numpy arrays, e.g. ``jax.device_get`` of the state a JAX
    step returned) as the port's, so the port's sharded step continues
    the JAX stream at the next block; on ``device`` (default the current
    CUDA device, the CPU when named: a mesh's ``Mesh.device``)."""
    return sharded_state_from_arrays(state, device)
