"""Checkpoint/resume of the streaming receiver and transmitter, the
PyTorch port of the single-device part of ``amps_tpu.runtime.state``.

A snapshot is a dict of numpy arrays (``np.savez`` persists it): the
receiver's carried DSP state, hop parity, dedup positions, buffered
sub-hop residue and sub-frame supervision leftover; the transmitter's synthesis carry, hop index, phase
accumulators and FOCC word queues.  The transmitter's file has the JAX
package's layout, so either package can resume the other's.  A resumed
stream is identical to an uninterrupted one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from amps_tpu_torch.dsp.channelizer import SynthesizerState


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def snapshot_receiver(rx) -> Dict[str, np.ndarray]:
    """MultichannelReceiver carried state as host arrays.  Refuses a
    receiver with undrained in-flight blocks (its DSP state is already
    past them while its dedup state is not): flush() first, or run at
    pipeline_depth=1.  A buffered sub-hop residue is part of the
    snapshot (the JAX package refuses one)."""
    if rx._inflight:
        raise ValueError(f"receiver has {len(rx._inflight)} undrained "
                         "in-flight block(s); flush() before snapshotting")
    residue = (_host(rx._residue) if rx._residue is not None
               else np.zeros((0, 2), np.float32))
    return {
        "kind": np.asarray("receiver"),
        "hist": _host(rx._hist),
        "parity": np.asarray(rx._parity),
        "carry": _host(rx._carry),
        "prev": _host(rx._prev),
        "abs_base": np.int64(rx._abs_base),
        "last_seen": rx._last_seen.copy(),
        "pw_carry": _host(rx._pw_carry),
        "residue": residue,
        "last_block_len": np.int64(rx._last_block_len),
        # sub-frame supervision leftover: without it a resume drops up
        # to one 10 ms frame
        "sup_carry": (rx._sup_carry.copy() if rx._sup_carry is not None
                      else np.zeros((0, 0), np.float32)),
    }


def restore_receiver(snap, rx) -> None:
    """Restore a snapshot_receiver dict (or its .npz) into a receiver of
    the same spec."""
    if str(snap["kind"]) != "receiver":
        raise ValueError(f"not a receiver snapshot: {snap['kind']}")

    def dev(a):
        return torch.tensor(np.asarray(a, np.float32), device=rx.device)

    rx._hist = dev(snap["hist"])
    rx._parity = int(snap["parity"])
    rx._carry = dev(snap["carry"])
    rx._prev = dev(snap["prev"])
    rx._abs_base = int(snap["abs_base"])
    rx._last_seen = np.asarray(snap["last_seen"], np.int64).copy()
    rx._pw_carry = dev(snap["pw_carry"])
    residue = np.asarray(snap["residue"], np.float32)
    rx._residue = dev(residue) if residue.shape[0] else None
    rx._last_block_len = int(snap["last_block_len"])
    keys = snap.files if hasattr(snap, "files") else snap.keys()
    if "sup_carry" in keys and rx._sup_carry is not None:
        sc = np.asarray(snap["sup_carry"], np.float32)
        if sc.shape[0] == rx._sup_carry.shape[0]:
            rx._sup_carry = sc.copy()


def save_receiver(path: str, rx) -> None:
    """MultichannelReceiver -> .npz"""
    np.savez(path, **snapshot_receiver(rx))


def load_receiver(path: str, rx) -> None:
    with np.load(path, allow_pickle=False) as z:
        restore_receiver(z, rx)


def save_transmitter(path: str, tx) -> None:
    """MultichannelTransmitter -> .npz (incl. per-channel FOCC queues)."""
    payload: Dict[str, np.ndarray] = {
        "kind": np.asarray("transmitter"),
        "carry": _host(tx._state.carry),
        "hop_idx": np.int64(tx._state.hop_idx),
        "channels": np.asarray(sorted(tx.focc.keys()), np.int64),
    }
    for k, st in tx.focc.items():
        payload[f"accum_{k}"] = np.int64(tx._accum[k])
        with st._lock:
            q = list(st._queue)
            deferred = list(st._deferred)
            busy = st._busy_superframes
        payload[f"queue_{k}"] = (np.stack(q) if q
                                 else np.zeros((0, 2, 28), np.uint8))
        payload[f"busy_{k}"] = np.int64(busy)
        payload[f"deferred_n_{k}"] = np.asarray([n for n, _ in deferred],
                                                np.int64)
        payload[f"deferred_{k}"] = (np.stack([p for _, p in deferred])
                                    .astype(np.uint8) if deferred
                                    else np.zeros((0, 2, 28), np.uint8))
    np.savez(path, **payload)


def restore_transmitter(z, tx) -> None:
    """Restore the arrays of a save_transmitter file (of either package)
    into a transmitter with the same control channels."""
    if str(z["kind"]) != "transmitter":
        raise ValueError(f"not a transmitter checkpoint: {z['kind']}")
    tx._state = SynthesizerState(
        torch.tensor(np.asarray(z["carry"], np.float32), device=tx.device),
        int(z["hop_idx"]))
    for k in z["channels"]:
        k = int(k)
        tx._accum[k] = int(z[f"accum_{k}"])
        st = tx.focc[k]
        with st._lock:
            st._queue.clear()
            for pair in z[f"queue_{k}"]:
                st._queue.append(np.asarray(pair, np.uint8).copy())
            st._busy_superframes = int(z[f"busy_{k}"])
            st._deferred = [(int(n), np.asarray(p, np.uint8).copy())
                            for n, p in zip(z[f"deferred_n_{k}"],
                                            z[f"deferred_{k}"])]


def load_transmitter(path: str, tx) -> None:
    with np.load(path, allow_pickle=False) as z:
        restore_transmitter(z, tx)
