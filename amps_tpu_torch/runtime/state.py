"""Checkpoint/resume of the streaming receiver, the transmitter and the
base station, the PyTorch port of the single-device part of
``amps_tpu.runtime.state``.

A snapshot is a dict of numpy arrays (``np.savez`` persists it): the
receiver's carried DSP state, hop parity, dedup positions, buffered
sub-hop residue and sub-frame supervision leftover; the transmitter's
synthesis carry, hop index, phase accumulators and FOCC word queues; the
station's FOCC queue, FVC bursts, mutes, supervision timers and the
voice slots' modulator continuity.  The transmitter's and the station's
files have the JAX package's layout, so either package can resume the
other's.  A resumed stream is identical to an uninterrupted one.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from amps_tpu_torch.control.supervision import ChannelSupervisor
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


_SUP_STATES = ("idle", "alerting", "conversation", "released")


def save_station(path: str, bs, sources: Optional[dict] = None) -> None:
    """BaseStation -> .npz: FOCC word queue, FVC burst/timer/offset,
    mutes, per-channel FVC streams and per-voice-channel supervision
    timers.  Together with save_receiver/save_transmitter this
    checkpoints the whole base station; a loaded station continues the
    exact symbol streams and supervision timeline.  The event log is
    history, not operational state, and is not persisted.

    ``sources``: optional {slot_or_chan: VoiceFvcSlot} map -- the voice
    slots' modulator continuity state (FVC FM accumulator, voice FM
    phase, SAT tone clock, and a looping WavAudioSource offset) joins
    the checkpoint so the resumed TX waveform has no FM phase step or
    SAT phase discontinuity (pass the same map to load_station)."""
    payload: Dict[str, np.ndarray] = {
        "kind": np.asarray("station"),
        "fvc_mute": np.int64(bs.fvc_mute),
        "audio_mute": np.int64(bs.audio_mute),
    }
    if sources:
        keys = sorted(sources)
        payload["src_keys"] = np.asarray(keys, np.int64)
        for k in keys:
            s = sources[k]
            wav_off = getattr(getattr(s, "audio_source", None), "_off", -1)
            payload[f"src_{k}"] = np.asarray(
                [s._fvc_accum, s._voice_phase, s._t, wav_off], np.float64)
    with bs.focc._lock:
        q = list(bs.focc._queue)
        busy = bs.focc._busy_superframes
        deferred = list(bs.focc._deferred)
    payload["focc_queue"] = (np.stack(q).astype(np.uint8) if q
                             else np.zeros((0, 2, 28), np.uint8))
    payload["focc_busy"] = np.int64(busy)
    payload["focc_deferred_n"] = np.asarray([n for n, _ in deferred],
                                            np.int64)
    payload["focc_deferred"] = (np.stack([p for _, p in deferred])
                                .astype(np.uint8) if deferred
                                else np.zeros((0, 2, 28), np.uint8))
    with bs.fvc._lock:
        burst = bs.fvc._burst
        payload["fvc_burst"] = (np.asarray(burst, np.int8)
                                if burst is not None
                                else np.zeros(0, np.int8))
        payload["fvc_has_burst"] = np.int64(burst is not None)
        payload["fvc_timer"] = np.int64(bs.fvc._timer)
        payload["fvc_off"] = np.int64(bs.fvc._off)
    chans = sorted(bs.supervisors)
    payload["sup_channels"] = np.asarray(chans, np.int64)
    for c in chans:
        s = bs.supervisors[c]
        payload[f"sup_{c}"] = np.asarray(
            [_SUP_STATES.index(s.state), s.t, s._sat_loss_t, s._st_run_t,
             s._alert_t, float(s._st_seen_in_alert),
             s._st_quiet_t, s._conv_run_snap], np.float64)
    # per-channel FVC streams + mute pairs (per_channel_fvc stations)
    fchans = sorted(bs.fvc_streams)
    payload["fvc_channels"] = np.asarray(fchans, np.int64)
    for c in fchans:
        st = bs.fvc_streams[c]
        with st._lock:
            burst = st._burst
            payload[f"fvcch_{c}"] = (np.asarray(burst, np.int8)
                                     if burst is not None
                                     else np.zeros(0, np.int8))
            payload[f"fvcch_meta_{c}"] = np.asarray(
                [int(burst is not None), st._timer, st._off,
                 int(bs.fvc_mutes.get(c, True)),
                 int(bs.audio_mutes.get(c, False))], np.int64)
    np.savez(path, **payload)


def load_station(path: str, bs, sources: Optional[dict] = None) -> None:
    """Restore a save_station file (of either package) into a freshly
    constructed BaseStation with the same configs.  ``sources``: the
    same slot map given to save_station, to restore voice-slot
    modulator continuity."""
    with np.load(path, allow_pickle=False) as f:
        z = dict(f)
    if str(z["kind"]) != "station":
        raise ValueError(f"not a station checkpoint: {z['kind']}")
    if sources and "src_keys" in z:
        for k in z["src_keys"]:
            k = int(k)
            if k not in sources:
                continue
            accum, phase, t, wav_off = np.asarray(z[f"src_{k}"],
                                                  np.float64)
            s = sources[k]
            s._fvc_accum = int(accum)
            s._voice_phase = float(phase)
            s._t = float(t)
            if wav_off >= 0 and hasattr(getattr(s, "audio_source", None),
                                        "_off"):
                s.audio_source._off = int(wav_off)
    bs.fvc_mute = bool(z["fvc_mute"])
    bs.audio_mute = bool(z["audio_mute"])
    with bs.focc._lock:
        bs.focc._queue.clear()
        for pair in z["focc_queue"]:
            bs.focc._queue.append(np.asarray(pair, np.uint8).copy())
        bs.focc._busy_superframes = int(z["focc_busy"])
        bs.focc._deferred = [(int(n), np.asarray(p, np.uint8).copy())
                             for n, p in zip(z["focc_deferred_n"],
                                             z["focc_deferred"])]
    with bs.fvc._lock:
        bs.fvc._burst = (z["fvc_burst"].copy() if bool(z["fvc_has_burst"])
                         else None)
        bs.fvc._timer = int(z["fvc_timer"])
        bs.fvc._off = int(z["fvc_off"])
    if bs.per_channel_fvc:
        for c in z["fvc_channels"]:
            c = int(c)
            has, timer, off, fmute, amute = (
                int(v) for v in z[f"fvcch_meta_{c}"])
            st = bs.fvc_for(c)
            with st._lock:
                st._burst = z[f"fvcch_{c}"].copy() if has else None
                st._timer = timer
                st._off = off
            bs.fvc_mutes[c] = bool(fmute)
            bs.audio_mutes[c] = bool(amute)
    bs.supervisors.clear()
    for c in z["sup_channels"]:
        c = int(c)
        vec = np.asarray(z[f"sup_{c}"], np.float64)
        sup = ChannelSupervisor(c, bs.system.scc, bs.supervision_config,
                                on_event=bs._on_supervision_event,
                                state=_SUP_STATES[int(vec[0])])
        (sup.t, sup._sat_loss_t, sup._st_run_t, sup._alert_t) = (
            float(v) for v in vec[1:5])
        sup._st_seen_in_alert = bool(vec[5])
        sup._st_quiet_t = float(vec[6])
        sup._conv_run_snap = float(vec[7])
        bs.supervisors[c] = sup
