"""RECC burst detection, capture and gates, the PyTorch port of
``amps_tpu.rx.correlator``: the fused symbol-domain forms on
integrate-and-dump phase streams that the receive block uses, and the
sample-domain forms of the single-channel chain (``find_bursts``,
``extract_burst_symbols``, ``find_and_extract``).

Trigger search correlates the 74-symbol seizure trigger (26 dotting +
11 word-sync bits, Manchester) against the sps symbol-rate phase
streams, normalizes by the window energy, and picks up to K peaks with
greedy non-maximum suppression over the full capture extent: on the
CPU as the JAX package's banded Toeplitz matmul, on the card in one
hand-written kernel (``kernels.trigger_search``) that writes no plane.
Capture reads 3374 symbols per candidate (plus 74 lead symbols for the
trigger gate) with a direct index instead of the JAX package's one-hot
matmul; the values are identical copies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

TRIGGER_BITS = np.concatenate(
    [np.tile(np.array([1, 0], np.uint8), 13),
     np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], np.uint8)]
)  # 26 dotting + 11 word-sync bits
TRIGGER_SYMBOLS = 2 * len(TRIGGER_BITS)  # 74 Manchester symbols
CAPTURE_SYMBOLS = 3374                   # DCC(7)+7x240 bits, x2
# Per-burst DC estimate window: DCC (14 symbols) + word 1 (480 symbols),
# exactly DC-free under Manchester coding, so its mean estimates the
# discriminator's DC bias (carrier frequency offset).
DC_EST_SYMBOLS = 2 * 7 + 2 * 5 * 48      # 494
CORR_BLOCK = 256
MAX_TRIGGER_ERRORS = 6
RSSI_BLOCK = 384   # power-series samples per rssi block (128 sym @ sps 3)
SYM_BLOCK = 128    # symbols per integrate-and-dump block


def _dc_slice(soft):
    """Hard 0/1 symbols from soft captures (..., K, CAPTURE_SYMBOLS),
    sliced against the per-burst DC estimate instead of 0."""
    dc = torch.mean(soft[..., :DC_EST_SYMBOLS].to(torch.float32), dim=-1,
                    keepdim=True)
    return soft >= dc.to(soft.dtype)


@functools.cache
def trigger_template(sps: int) -> np.ndarray:
    """±1 float32 template of the trigger at sps samples/symbol."""
    first = np.where(TRIGGER_BITS == 0, 1.0, -1.0).astype(np.float32)
    pair = np.stack([first, -first], axis=1).reshape(-1)
    return np.repeat(pair, sps)


@functools.cache
def _detection_kernels(sps: int, O: int = CORR_BLOCK):
    """Banded Toeplitz operator computing the full-template and the
    word-sync-tail correlations of O lags at once, and the matching
    banded-ones operator for the window energies.
    Returns (T, E, L, ws_off, tnorm, wsnorm)."""
    tmpl = trigger_template(sps)
    L = len(tmpl)
    ws_off = 2 * 26 * sps
    T = np.zeros((O + L - 1, 2 * O), np.float32)
    E = np.zeros((O + L - 1, 2 * O), np.float32)
    for j in range(O):
        T[j: j + L, j] = tmpl
        T[j + ws_off: j + L, O + j] = tmpl[ws_off:]
        E[j: j + L, j] = 1.0
        E[j + ws_off: j + L, O + j] = 1.0
    tnorm = float(np.sqrt(np.sum(tmpl * tmpl)))
    wsnorm = float(np.sqrt(np.sum(tmpl[ws_off:] ** 2)))
    return T, E, L, ws_off, tnorm, wsnorm


@functools.cache
def _dump_matrix(sps: int) -> np.ndarray:
    """(SYM_BLOCK*sps + sps - 1, sps*SYM_BLOCK) blocked integrate-and-
    dump operator of the JAX package: out[:, p*B + j] =
    mean(x[p + j*sps : p + (j+1)*sps]).  Kept for table parity; the
    port dumps with a reshape (``symbol_phase_streams``)."""
    B = SYM_BLOCK
    W = np.zeros((B * sps + sps - 1, sps * B), np.float32)
    for p in range(sps):
        for j in range(B):
            W[p + j * sps: p + (j + 1) * sps, p * B + j] = 1.0 / sps
    return W


def symbol_phase_streams(demod, sps: int):
    """(..., n) demod -> (..., sps, nsym) integrate-and-dump streams
    (phase p stream k = mean(x[p + k*sps : p + (k+1)*sps])), nsym =
    (n - sps + 1) // sps.  bfloat16 input stays bfloat16 (weights
    rounded to bfloat16, f32 accumulation, as in the JAX package)."""
    x = torch.as_tensor(demod)
    bf16 = x.dtype == torch.bfloat16
    x = x.to(torch.float32)
    n = x.shape[-1]
    nsym = (n - (sps - 1)) // sps
    w = np.float32(1.0 / sps)
    if bf16:
        w = torch.tensor(w).to(torch.bfloat16).item()
    out = torch.stack(
        [(x[..., p: p + nsym * sps].reshape(x.shape[:-1] + (nsym, sps))
          * float(w)).sum(dim=-1) for p in range(sps)], dim=-2)
    return out.to(torch.bfloat16) if bf16 else out


@functools.cache
def _toeplitz_ops(O: int, data_dtype, device):
    """Device copies of the two (O, 2O) pieces of the Toeplitz and energy
    operators, with values rounded to the data dtype, as float32."""
    T, E, L = _detection_kernels(1, O)[:3]
    Tj = np.zeros((2, O, 2 * O), np.float32)
    Ej = np.zeros((2, O, 2 * O), np.float32)
    Tj[0], Ej[0] = T[:O], E[:O]
    Tj[1, :L - 1], Ej[1, :L - 1] = T[O:], E[O:]
    return tuple(torch.as_tensor(a, device=device).to(data_dtype)
                 .to(torch.float32) for a in (Tj[0], Tj[1], Ej[0], Ej[1]))


@functools.cache
def _trigger_pattern(device):
    return torch.as_tensor(trigger_template(1) > 0, device=device)


def find_bursts_phases(phases, sps: int, max_bursts: int = 4,
                       threshold: float = 0.6, corr_block: int = 128,
                       out_bf16: bool = False):
    """Symbol-domain burst detection on phase streams (..., sps, nsym),
    bfloat16 or float32.

    Returns (starts (..., K) int32 in SAMPLE units — the first capture
    sample, valid (..., K) bool, quality (..., K) float32).  Greedy NMS
    masks -L..+(L+CAPTURE) symbols (in sample units, across all phases
    jointly) around each accepted peak; the flattening order
    (phase-major, then lag) fixes which of tied maxima wins.

    A CUDA tensor launches the hand-written kernel
    (``kernels.trigger_search``) or raises; a CPU tensor computes the
    plain version, ``find_bursts_phases_reference``.  There is no
    fallback from one to the other."""
    x = torch.as_tensor(phases)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"phases must be bfloat16 or float32, got {x.dtype}")
    if sps < 1 or x.ndim < 2 or x.shape[-2] != sps:
        raise ValueError(f"phases must be (..., sps={sps}, nsym), got "
                         f"{tuple(x.shape)}")
    if x.shape[-1] < TRIGGER_SYMBOLS:
        raise ValueError(f"phases hold {x.shape[-1]} symbols, the trigger "
                         f"{TRIGGER_SYMBOLS}")
    if max_bursts < 1:
        raise ValueError(f"max_bursts must be at least 1, got {max_bursts}")
    if corr_block < TRIGGER_SYMBOLS - 1:
        raise ValueError(f"corr_block must be at least "
                         f"{TRIGGER_SYMBOLS - 1}, got {corr_block}")
    if x.device.type == "cpu":
        return find_bursts_phases_reference(x, sps, max_bursts, threshold,
                                            corr_block, out_bf16)
    if x.device.type != "cuda":
        raise ValueError(f"phases must lie on the CPU or a CUDA device, not "
                         f"{x.device}")
    # imported here: the kernel's module reads this one's constants
    from amps_tpu_torch.kernels import trigger_search
    return trigger_search.search(x, sps, max_bursts, threshold, corr_block,
                                 out_bf16)


def trigger_quality_reference(phases, corr_block: int = 128,
                              out_bf16: bool = False):
    """The quality plane (..., sps, no) of the plain trigger search, in
    the accumulation dtype (bfloat16 with ``out_bf16``, else float32), on
    any device: the JAX package's banded Toeplitz matmul of the phase
    streams (..., sps, nsym), the window energies, and the smaller of the
    whole trigger's and the word-sync tail's normalised correlations at
    each lag o < no = nsym - 73."""
    x = torch.as_tensor(phases)
    if x.dtype != torch.bfloat16:
        x = x.to(torch.float32)
    T, E, L, ws_off, tnorm, wsnorm = _detection_kernels(1, corr_block)
    O = corr_block
    assert O >= L - 1, (O, L)
    nsym = x.shape[-1]
    no = nsym - L + 1
    nblk = -(-no // O)
    npad = (nblk + 1) * O
    if npad > nsym:
        xp = torch.cat([x, x.new_zeros(x.shape[:-1] + (npad - nsym,))], -1)
    else:
        xp = x[..., :npad]
    T0, T1, E0, E1 = _toeplitz_ops(O, x.dtype, x.device)
    p0 = xp[..., : nblk * O].reshape(x.shape[:-1] + (nblk, O))
    p1 = xp[..., O: (nblk + 1) * O].reshape(x.shape[:-1] + (nblk, O))
    acc_t = torch.bfloat16 if out_bf16 else torch.float32

    def mm(a, W):   # data-dtype operands, f32 accumulation, acc_t result
        return (a.to(torch.float32) @ W).to(acc_t)

    # each plane goes as soon as it is used (at a wide bank each is
    # gigabytes); the in-place sums are the same additions
    def unblk(a):
        return a.reshape(x.shape[:-1] + (nblk * O,))[..., :no]

    out = mm(p0, T0)
    out += mm(p1, T1)
    corr, ws_corr = unblk(out[..., :O]), unblk(out[..., O:])
    del out
    een = mm(p0 * p0, E0)
    sq = p1 * p1
    del xp, p0, p1
    een += mm(sq, E1)
    del sq
    energy, ws_energy = unblk(een[..., :O]), unblk(een[..., O:])
    del een

    def c(v):   # a constant in the accumulation dtype
        return torch.full((), v, dtype=acc_t, device=x.device)

    def norm(cr, en, tn):   # cr / (sqrt(max(en, 1e-9)) * tn), one plane
        q = torch.maximum(en, c(1e-9))
        q.sqrt_()
        q.mul_(c(tn))
        return torch.div(cr, q, out=q)

    q_full = norm(corr, energy, tnorm)
    del corr, energy
    q_ws = norm(ws_corr, ws_energy, wsnorm)
    del ws_corr, ws_energy
    return torch.minimum(q_full, q_ws, out=q_full)


def find_bursts_phases_reference(phases, sps: int, max_bursts: int = 4,
                                 threshold: float = 0.6,
                                 corr_block: int = 128,
                                 out_bf16: bool = False):
    """Plain PyTorch version of ``find_bursts_phases``, on any device: the
    quality plane (``trigger_quality_reference``) and K argmax / mask
    rounds."""
    quality = trigger_quality_reference(phases, corr_block, out_bf16)
    L = TRIGGER_SYMBOLS
    no = quality.shape[-1]
    dev = quality.device
    batch = quality.shape[:-2]
    q = quality.reshape(batch + (sps * no,))
    del quality
    pos = (torch.arange(sps, device=dev)[:, None]
           + sps * torch.arange(no, device=dev)[None, :]).reshape(-1)
    neg_inf = torch.full((), float("-inf"), dtype=q.dtype, device=dev)
    spos_l, peaks_l = [], []
    for k in range(max_bursts):
        idx = torch.argmax(q, dim=-1)
        peak = torch.gather(q, -1, idx[..., None])[..., 0]
        s = pos[idx]
        spos_l.append(s)
        peaks_l.append(peak.to(torch.float32))
        if k + 1 < max_bursts:
            mask = ((pos > s[..., None] - L * sps)
                    & (pos < s[..., None] + (L + CAPTURE_SYMBOLS) * sps))
            q = torch.where(mask, neg_inf, q)
    spos = torch.stack(spos_l, dim=-1)
    peaks = torch.stack(peaks_l, dim=-1)
    starts = (spos + L * sps).to(torch.int32)
    valid = peaks >= threshold
    return starts, valid, peaks


def extract_from_phases(phases, starts, sps: int, hard_dtype=torch.uint8,
                        lead: int = 0):
    """Burst capture from phase streams (..., sps, nsym): for each start
    (SAMPLE units) take CAPTURE_SYMBOLS symbols of phase start % sps from
    symbol start // sps, plus ``lead`` symbols before it.  Symbols
    outside [0, nsym) read zero (floor semantics for negative offsets).
    Returns (hard, soft) or, with lead > 0, (hard, soft, lead_soft)."""
    phases = torch.as_tensor(phases)
    nsym = phases.shape[-1]
    st = torch.as_tensor(starts, device=phases.device).to(torch.int64)
    ph = torch.remainder(st, sps)
    k0 = torch.div(st, sps, rounding_mode="floor") - lead
    sym = k0[..., None] + torch.arange(lead + CAPTURE_SYMBOLS,
                                       device=phases.device)  # (..., K, W)
    inside = (sym >= 0) & (sym < nsym)
    batch = phases.shape[:-2]
    K = st.shape[-1]
    flat = phases.reshape(batch + (sps * nsym,))
    gidx = ph[..., None] * nsym + torch.clamp(sym, 0, nsym - 1)
    picked = torch.gather(flat, -1, gidx.reshape(batch + (-1,)))
    picked = picked.reshape(batch + (K, lead + CAPTURE_SYMBOLS))
    window = torch.where(inside, picked, torch.zeros((), dtype=phases.dtype,
                                                     device=phases.device))
    soft = window[..., lead:]
    hard = _dc_slice(soft).to(hard_dtype)
    if lead == 0:
        return hard, soft
    return hard, soft, window[..., :lead]


def trigger_errors_soft(trig_soft, starts=None, sps: int = 1):
    """Trigger mismatch counts from extracted lead symbols
    (..., K, TRIGGER_SYMBOLS); with ``starts`` (SAMPLE units), symbols
    before the stream head are not counted."""
    soft = trig_soft.to(torch.float32)
    dc = torch.mean(soft, dim=-1, keepdim=True)
    hard = soft >= dc
    patt = _trigger_pattern(soft.device)
    bad = hard != patt
    if starts is not None:
        st = torch.as_tensor(starts, device=soft.device).to(torch.int64)
        n_cut = torch.clamp(
            TRIGGER_SYMBOLS - torch.div(st, sps, rounding_mode="floor"),
            min=0)
        bad = bad & (torch.arange(TRIGGER_SYMBOLS, device=soft.device)
                     >= n_cut[..., None])
    return torch.sum(bad, dim=-1).to(torch.int32)


def apply_trigger_gate_soft(valid, trig_soft, max_err: int,
                            starts=None, sps: int = 1):
    """valid &= trigger slices exactly (within max_err mismatches);
    max_err < 0 disables."""
    if max_err < 0:
        return valid
    return valid & (trigger_errors_soft(trig_soft, starts, sps) <= max_err)


def trigger_errors(phases, starts, sps: int):
    """Trigger mismatch counts (..., K) int32 of the 74 symbols preceding
    each start (SAMPLE units) on phase streams (..., sps, nsym), sliced
    against their own mean; symbols before the stream head are not
    counted (``extract_from_phases``' lead, then
    ``trigger_errors_soft``)."""
    lead = extract_from_phases(phases, starts, sps, lead=TRIGGER_SYMBOLS)[2]
    return trigger_errors_soft(lead, starts, sps)


def apply_trigger_gate(valid, phases, starts, sps: int, max_err: int):
    """valid &= (trigger slices exactly, within max_err mismatches);
    max_err < 0 disables the gate."""
    if max_err < 0:
        return valid
    return valid & (trigger_errors(phases, starts, sps) <= max_err)


def window_power_blocks(parts, B: int = RSSI_BLOCK):
    """Per-block means over the concatenation of per-sample power parts
    (last axis), zero-padded to whole blocks: (..., ceil(n / B))."""
    p = torch.cat([torch.as_tensor(q).to(torch.float32) for q in parts], -1)
    n = p.shape[-1]
    nb = -(-n // B)
    p = torch.nn.functional.pad(p, (0, nb * B - n))
    return torch.sum(p.reshape(p.shape[:-1] + (nb, B)), dim=-1) / float(B)


def power_from_blocks(blk, n: int):
    """Per-stream sqrt(mean power) from window_power_blocks output over
    an n-sample window (the zero-pad dilution is undone)."""
    return torch.sqrt(torch.sum(blk, dim=-1)
                      * float(np.float32(RSSI_BLOCK / n)))


def burst_rssi_blocks(blk, starts, sps: int):
    """Per-candidate band power over the candidate's own capture extent
    from block means (..., nb): sqrt of the mean of the 27 blocks from
    the start's block on (blocks past the end count as zero)."""
    B = RSSI_BLOCK
    nb = blk.shape[-1]
    st = torch.as_tensor(starts, device=blk.device).to(torch.int64)
    b0 = torch.div(st, B, rounding_mode="floor")
    nsel = CAPTURE_SYMBOLS * sps // B + 1
    tgt = b0[..., None] + torch.arange(nsel, device=blk.device)
    inside = (tgt >= 0) & (tgt < nb)
    batch = blk.shape[:-1]
    picked = torch.gather(blk, -1, torch.clamp(tgt, 0, nb - 1)
                          .reshape(batch + (-1,))).reshape(tgt.shape)
    picked = torch.where(inside, picked, torch.zeros((), device=blk.device))
    return torch.sqrt(torch.mean(picked, dim=-1))


def burst_rssi(pw_series, starts, sps: int):
    """Per-candidate capture-extent band power (..., K) from a per-sample
    power series (..., n)."""
    return burst_rssi_blocks(window_power_blocks([pw_series]), starts, sps)


def extract_bursts_batched(demod_p, starts, sps: int):
    """Capture from a demod (..., n) padded so that every valid start's
    capture fits: (hard (..., K, 3374) uint8, soft float32); a capture
    past the end reads zeros."""
    return extract_from_phases(symbol_phase_streams(demod_p, sps), starts,
                               sps)


@functools.cache
def _sample_ops(sps: int, O: int, device):
    """Device copies of the sample-domain Toeplitz and energy operators
    (O + L - 1, 2O) of ``_detection_kernels(sps, O)``."""
    T, E = _detection_kernels(sps, O)[:2]
    return (torch.as_tensor(T, device=device),
            torch.as_tensor(E, device=device))


def find_bursts(demod, sps: int, max_bursts: int = 4,
                threshold: float = 0.6, corr_block: int = CORR_BLOCK):
    """Locate up to ``max_bursts`` trigger hits in an FM-demod block at
    the sample rate: demod (..., n) float32.  Returns (starts (..., K)
    int32, the first capture sample, just past the trigger; valid
    (..., K) bool; quality (..., K) float32, the smaller of the cosine
    similarities of the whole trigger and of its word-sync tail).  Greedy
    NMS masks a trigger length before and a trigger plus a capture after
    each accepted peak."""
    x = torch.as_tensor(demod).to(torch.float32)
    _, _, L, _, tnorm, wsnorm = _detection_kernels(sps, corr_block)
    O = corr_block
    n = x.shape[-1]
    no = n - L + 1
    nblk = -(-no // O)
    npad = (nblk - 1) * O + O + L - 1
    if npad > n:
        xp = torch.cat([x, x.new_zeros(x.shape[:-1] + (npad - n,))], -1)
    else:
        xp = x[..., :npad]
    wins = xp.unfold(-1, O + L - 1, O)             # (..., nblk, O+L-1)
    T, E = _sample_ops(sps, O, x.device)
    out = wins @ T                                  # (..., nblk, 2*O)
    een = (wins * wins) @ E

    def unblk(a):
        return a.reshape(x.shape[:-1] + (nblk * O,))[..., :no]

    corr, ws_corr = unblk(out[..., :O]), unblk(out[..., O:])
    energy, ws_energy = unblk(een[..., :O]), unblk(een[..., O:])
    q_full = corr / (torch.sqrt(torch.clamp(energy, min=1e-9)) * tnorm)
    q_ws = ws_corr / (torch.sqrt(torch.clamp(ws_energy, min=1e-9)) * wsnorm)
    q = torch.minimum(q_full, q_ws)
    pos = torch.arange(no, device=x.device)
    neg_inf = torch.full((), float("-inf"), device=x.device)
    idx_l, peaks_l = [], []
    for _ in range(max_bursts):
        idx = torch.argmax(q, dim=-1)
        idx_l.append(idx)
        peaks_l.append(torch.gather(q, -1, idx[..., None])[..., 0])
        mask = ((pos > idx[..., None] - L)
                & (pos < idx[..., None] + L + CAPTURE_SYMBOLS * sps))
        q = torch.where(mask, neg_inf, q)
    peaks = torch.stack(peaks_l, dim=-1)
    starts = (torch.stack(idx_l, dim=-1) + L).to(torch.int32)
    return starts, peaks >= threshold, peaks


def extract_burst_symbols(demod, starts, sps: int):
    """Integrate-and-dump capture: for each start (first capture sample)
    CAPTURE_SYMBOLS Manchester symbols of sps samples each, read from the
    phase stream of the start's own phase.  demod (..., n) float32,
    starts (..., K).  Returns (hard (..., K, 3374) uint8, soft float32).
    A capture that would run past the stream's end is moved back to end
    with it (the JAX package's clamped slice), so pad the demod."""
    phases = symbol_phase_streams(torch.as_tensor(demod).to(torch.float32),
                                  sps)             # (..., sps, nsym)
    nsym = phases.shape[-1]
    if nsym < CAPTURE_SYMBOLS:
        raise ValueError(f"demod holds {nsym} symbols, a capture needs "
                         f"{CAPTURE_SYMBOLS}")
    st = torch.as_tensor(starts, device=phases.device).to(torch.int64)
    ph = torch.remainder(st, sps)
    k0 = torch.clamp(torch.div(st, sps, rounding_mode="floor"), 0,
                     nsym - CAPTURE_SYMBOLS)
    sym = k0[..., None] + torch.arange(CAPTURE_SYMBOLS, device=phases.device)
    batch = phases.shape[:-2]
    flat = phases.reshape(batch + (sps * nsym,))
    gidx = ph[..., None] * nsym + sym
    soft = torch.gather(flat, -1, gidx.reshape(batch + (-1,))) \
        .reshape(gidx.shape)
    return _dc_slice(soft).to(torch.uint8), soft


def find_and_extract(demod, sps: int, max_bursts: int = 4,
                     threshold: float = 0.6):
    """Detection and capture of one (possibly batched) demod block:
    (starts, valid, quality, hard, soft)."""
    starts, valid, quality = find_bursts(demod, sps, max_bursts, threshold)
    hard, soft = extract_burst_symbols(demod, starts, sps)
    return starts, valid, quality, hard, soft
