"""The reference's receive back end over whole windows of every channel,
at the precisions a configuration states, vectorised in torch.

A window is a channel-major demod plane d (C, n), float64.  With
``io_bf16`` the demod is rounded to bfloat16 before the symbols are
formed, and the symbols are bfloat16 (the mean of three weighted by
1/3 rounded to bfloat16); with ``corr_bf16`` the trigger correlation,
the window energy, each step of the normalisation and the quality are
bfloat16.  Where the states are float32 the reference computes in
float64.  Then, as ``recc`` describes for one burst:

* the quality at every sample offset, the best ``max_bursts`` peaks a
  channel picked greedily, phase-major then offset on ties, each
  masking a trigger before and a trigger and a capture after it;
* valid: quality at least the threshold, the capture inside the window,
  at most 6 of the 74 trigger symbols mis-sliced (symbols before the
  window's head not counted);
* decode (first decodable repeat, a repeat of more than 6 Manchester
  violations an erasure): word_ok of every slot, valid or not.

``receive`` is that back end over a window, slot by slot, at the stated
precisions or (the control) lower ones.  ``judge`` holds another
receiver's slots against it: at the slots' own starts, so that of two
offsets whose qualities tie (a periodic band ties an offset with the
same offset a block later) either may be taken.

"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference import bank, recc

def _bf(t: torch.Tensor, on) -> torch.Tensor:
    """t rounded to bfloat16 (``on`` True), to the dtype ``on`` names
    (the control's float8), or left as it is (``on`` False)."""
    if on is False:
        return t
    return t.to(torch.bfloat16 if on is True else on).to(t.dtype)


def _sums(d: torch.Tensor, sps: int, io_bf16) -> torch.Tensor:
    """(C, sps, nsym) the symbols of ``symbols`` before their rounding."""
    d = _bf(d, io_bf16)
    n = d.shape[-1]
    nsym = (n - (sps - 1)) // sps
    w = float(_bf(torch.tensor(1.0 / sps, dtype=torch.float64), io_bf16))
    return torch.stack([(d[..., p: p + nsym * sps].reshape(
        d.shape[:-1] + (nsym, sps)) * w).sum(-1) for p in range(sps)], -2)


def symbols(d: torch.Tensor, sps: int, io_bf16) -> torch.Tensor:
    """(C, sps, nsym) integrate-and-dump symbol streams of phase p:
    s[p, k] = mean(d[p + k·sps : p + (k+1)·sps]), the weight 1/sps
    rounded as the symbols are."""
    return _bf(_sums(d, sps, io_bf16), io_bf16)


# A float32 front end's demod sample lies this far (rad) from the
# reference's at most, where its arc tangent's branch is settled: 4.5
# times the port's widest on an H100 (8.8e-7, PERF.md).  One within it
# of a bfloat16 rounding midpoint may round to the other side.
DEMOD_TOL = 4e-6
# the relative error of a float32 sum of a few hundred terms at most,
# pairwise or blocked, against the sum's magnitude
SUM_TOL = 2.0 ** -18


def _step(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 at |v| (0 at 0, which rounds exactly)."""
    return torch.where(v == 0, 0.0, torch.ldexp(torch.ones_like(v),
                                                torch.frexp(v)[1] - 8))


def _branch_gap() -> float:
    """The jump of ``bank.poly_arg`` across its octant's edge (rad): an
    unsettled sample may take either side."""
    im = torch.tensor([1.0 - 1e-12, 1.0 + 1e-12], dtype=torch.float64)
    d = bank.poly_arg(im, torch.ones(2, dtype=torch.float64))
    return float((d[1] - d[0]).abs())


def _midway(v: torch.Tensor, by) -> torch.Tensor:
    """Values within ``by`` of a bfloat16 rounding midpoint."""
    return (((v - _bf(v, True)).abs() - _step(v) / 2).abs() <= by)


def room(d: torch.Tensor, keep, sps: int, io_bf16) -> torch.Tensor:
    """(C, sps, nsym) the most by which another float32 front end's
    symbols may lie from ``symbols(d, sps, io_bf16)``: a demod sample
    within ``DEMOD_TOL`` of a bfloat16 rounding midpoint may round a
    step the other way, one whose branch is not settled (``keep``
    False) may jump by the branch gap, and a symbol moved so far, or
    summed in float32, that it may reach its own rounding midpoint may
    round a step the other way.  Zero where the symbols are not
    rounded."""
    if io_bf16 is not True:
        return torch.zeros_like(_sums(d, sps, False))
    amb = torch.where(_midway(d, DEMOD_TOL), _step(d), 0.0)
    if keep is not None:
        amb = torch.where(keep, amb, _branch_gap())
    w = float(_bf(torch.tensor(1.0 / sps, dtype=torch.float64), True))
    moved = _sums(amb, sps, False) * (sps * w)
    v = _sums(d, sps, True)
    acc = _sums(d.abs(), sps, True) * SUM_TOL
    return torch.where(_midway(v, moved + acc), moved + _step(v), 0.0)


def _window_sums(x: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """sum_s weights[s] x[..., j + s] for every j (a run-length form of
    the correlation: the weights are a few runs of equal values)."""
    L = len(weights)
    c = torch.cat([x.new_zeros(x.shape[:-1] + (1,)), torch.cumsum(x, -1)],
                  -1)
    no = x.shape[-1] - L + 1
    out = x.new_zeros(x.shape[:-1] + (no,))
    s = 0
    while s < L:
        e = s
        while e < L and weights[e] == weights[s]:
            e += 1
        if weights[s]:
            out += weights[s] * (c[..., e: e + no] - c[..., s: s + no])
        s = e
    return out


def quality(sym: torch.Tensor, corr_bf16) -> torch.Tensor:
    """(C, sps, no) trigger quality of symbol streams (C, sps, nsym)."""
    tm = recc.TEMPLATE
    full = np.ones(recc.TRIGGER)
    ws = np.zeros(recc.TRIGGER)
    ws[recc.WS_OFF:] = 1
    sq = _bf(sym * sym, corr_bf16)

    def norm(corr, en, tn):
        q = _bf(torch.clamp(_bf(en, corr_bf16), min=1e-9), corr_bf16)
        q = _bf(_bf(torch.sqrt(q), corr_bf16) * _bf(torch.tensor(
            tn, dtype=q.dtype), corr_bf16), corr_bf16)
        return _bf(_bf(corr, corr_bf16) / q, corr_bf16)

    q_full = norm(_window_sums(sym, tm), _window_sums(sq, full),
                  float(np.sqrt((tm ** 2).sum())))
    q_ws = norm(_window_sums(sym, tm * ws), _window_sums(sq, ws),
                float(np.sqrt((tm[recc.WS_OFF:] ** 2).sum())))
    return torch.minimum(q_full, q_ws)


def peaks(q: torch.Tensor, sps: int, max_bursts: int):
    """(starts (C, K) in samples, peak quality (C, K)) of the greedy
    picks: the first maximum in phase-major order, then the mask."""
    C, _, no = q.shape
    flat = q.reshape(C, sps * no).clone()
    pos = (torch.arange(sps, device=q.device)[:, None]
           + sps * torch.arange(no, device=q.device)[None, :]).reshape(-1)
    L = recc.TRIGGER
    st, pk = [], []
    for k in range(max_bursts):
        idx = torch.argmax(flat, dim=-1)
        s = pos[idx]
        st.append(s)
        pk.append(flat.gather(-1, idx[:, None])[:, 0])
        if k + 1 < max_bursts:
            mask = (pos[None] > s[:, None] - L * sps) & \
                (pos[None] < s[:, None] + (L + recc.CAPTURE) * sps)
            flat = flat.masked_fill(mask, float("-inf"))
    return torch.stack(st, -1) + L * sps, torch.stack(pk, -1)


def capture(sym: torch.Tensor, starts: torch.Tensor, sps: int, lead: int,
            n: int):
    """(C, K, lead + n) symbols of each start's phase from symbol
    start // sps - lead; symbols outside the stream read 0."""
    C, _, nsym = sym.shape
    k0 = torch.div(starts, sps, rounding_mode="floor") - lead
    idx = k0[..., None] + torch.arange(lead + n, device=sym.device)
    inside = (idx >= 0) & (idx < nsym)
    ph = torch.remainder(starts, sps)
    flat = sym.reshape(C, -1)
    g = ph[..., None] * nsym + idx.clamp(0, nsym - 1)
    out = flat.gather(-1, g.reshape(C, -1)).reshape(idx.shape)
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype,
                                                device=out.device))


@functools.cache
def _tables():
    """(H (48, 12) syndrome matrix, (4096,) decodable, (4096, 36) the
    info bits each syndrome's error pattern flips) of the shortened
    code: row i the remainder of x^(47-i); a syndrome is decodable when
    it is that of at most two errors in the 63-bit word."""
    rem = [recc._rem(1 << (47 - i), 48) for i in range(48)]
    H = np.array([[r >> (11 - j) & 1 for j in range(12)] for r in rem])
    ok = np.zeros(4096, bool)
    flips = np.zeros((4096, 36), np.uint8)
    for syn, err in recc._error_table().items():
        ok[syn] = True
        for p in err:
            if 15 <= p < 15 + 36:
                flips[syn, p - 15] ^= 1
    return H, ok, flips


def decode(hard: torch.Tensor):
    """(word_ok (..., 7), words (..., 7, 36) uint8) of (..., 3374) 0/1
    captures, the loop's decoder: a repeat decodable with at most
    REPEAT_GATE Manchester violations; the words of the first such
    repeat, corrected (of the first repeat where none is)."""
    H, ok, flips = _tables()
    dev = hard.device
    w = hard[..., 14:].reshape(hard.shape[:-1] + (recc.WORDS, recc.REPEATS,
                                                  96)).to(torch.float64)
    bits = 1 - w[..., 0::2]
    bad = (w[..., 0::2] == w[..., 1::2]).sum(-1)
    # sums of at most 48 ones: exact in float64
    syn = torch.remainder(bits @ torch.as_tensor(H, dtype=torch.float64,
                                                 device=dev), 2)
    idx = (syn * torch.as_tensor([1 << j for j in range(11, -1, -1)],
                                 dtype=torch.float64, device=dev)).sum(-1)
    idx = idx.to(torch.int64)
    good = torch.as_tensor(ok, device=dev)[idx] & (bad <= recc.REPEAT_GATE)
    first = torch.argmax(good.to(torch.int8), -1)
    pick = first[..., None, None].expand(first.shape + (1, 48))
    info = bits.gather(-2, pick)[..., 0, :36].to(torch.uint8)
    fix = torch.as_tensor(flips, device=dev)[idx.gather(-1, first[..., None])
                                             [..., 0]]
    return good.any(-1), info ^ fix


def _near(a: torch.Tensor, level: torch.Tensor, room) -> torch.Tensor:
    """Symbols within two bfloat16 steps and ``room`` of their slice
    level, whose side rounding may decide."""
    return (a - level).abs() <= (a.abs() + level.abs()) * 2.0 ** -7 + room


def _gates(sym, starts, sps, io_bf16, n, slk=None):
    """(capture inside the window and trigger sliced within the gate,
    word_ok, words, decided) of the captures at ``starts`` (C, K):
    ``decided`` where no symbol of the capture or of the counted trigger
    lies within two bfloat16 steps of its slice level, and within the
    room ``slk`` (``room``'s) of the symbol and of the level where it
    is given."""
    win = capture(sym, starts, sps, recc.TRIGGER, recc.CAPTURE)
    soft, lead = win[..., recc.TRIGGER:], win[..., :recc.TRIGGER]
    dc = _bf(soft[..., :recc.DC_SYMBOLS].mean(-1, keepdim=True), io_bf16)
    hard = soft >= dc
    lmean = lead.mean(-1, keepdim=True)
    lh = lead >= lmean
    r, lr = 0.0, 0.0
    if slk is not None:
        rw = capture(slk, starts, sps, recc.TRIGGER, recc.CAPTURE)
        r, lr = rw[..., recc.TRIGGER:], rw[..., :recc.TRIGGER]
        # a level is a mean: its symbols' room, and a float32 sum's
        # rounding; the capture's is then rounded (a step of it)
        top = soft[..., :recc.DC_SYMBOLS]
        r_dc = r[..., :recc.DC_SYMBOLS].mean(-1, keepdim=True) + \
            top.abs().mean(-1, keepdim=True) * SUM_TOL
        r = r + r_dc + _step(dc)
        lr = lr + lr.mean(-1, keepdim=True) + \
            lead.abs().mean(-1, keepdim=True) * SUM_TOL
    patt = torch.as_tensor(recc.TEMPLATE > 0, device=sym.device)
    n_cut = torch.clamp(recc.TRIGGER - torch.div(
        starts, sps, rounding_mode="floor"), min=0)
    counted = torch.arange(recc.TRIGGER, device=sym.device) >= \
        n_cut[..., None]
    errs = ((lh != patt) & counted).sum(-1)
    gate = (starts + recc.CAPTURE * sps <= n) & \
        (errs <= recc.MAX_TRIGGER_ERRORS)
    ok, words = decode(hard)
    decided = ~(_near(soft, dc, r).any(-1)
                | (_near(lead, lmean, lr) & counted).any(-1))
    return gate, ok, words, decided


def receive(d: torch.Tensor, sps: int, io_bf16, corr_bf16, max_bursts: int,
            threshold: float, chunk: int = 1024) -> dict:
    """The back end's slots of a window d (C, n), as the loop makes
    them: starts (C, K) in samples, quality, valid, word_ok (C, K, 7),
    words (C, K, 7, 36)."""
    out = {k: [] for k in ("starts", "quality", "valid", "word_ok",
                           "words")}
    for a in range(0, d.shape[0], chunk):
        sym = symbols(d[a: a + chunk], sps, io_bf16)
        starts, pk = peaks(quality(sym, corr_bf16), sps, max_bursts)
        gate, ok, words, _ = _gates(sym, starts, sps, io_bf16, d.shape[-1])
        for k, v in zip(out, (starts, pk, (pk >= threshold) & gate, ok,
                              words)):
            out[k].append(v)
    return {k: torch.cat(v) for k, v in out.items()}


# a pick on a masked offset, or where the reference has none, reads
# this far below the reference's best
OFF = 4.0


def judge(d: torch.Tensor, slots: dict, sps: int, io_bf16, corr_bf16,
          threshold: float, keep=None, chunk: int = 1024) -> dict:
    """Another receiver's slots of window d (C, n) held against the
    reference's at the slots' own starts, pick by pick as the greedy
    search takes them:

    * ``pick_gap``: the widest gap by which the quality the reference
      gives a pick's offset lies below the reference's best offset not
      masked by the earlier picks;
    * ``quality_err``: the widest gap between a pick's quality and the
      reference's at its offset;
    * ``slot_diff``: slots whose valid, word_ok or decoded words (where
      word_ok) differ from the reference's capture at the same start,
      of the slots whose slicing and gate no rounding decides (no symbol
      within two bfloat16 steps and its ``room`` of its slice level,
      the quality more than four steps from the threshold); ``keep``
      (C, n) marks the samples whose arc tangent's branch is settled;

    and, for the record, the words the slots decoded and those the
    reference decodes at their starts, the slots left out of
    ``slot_diff``, and the first few slots counted in it (channel,
    pick, start)."""
    L = recc.TRIGGER
    gap = qerr = 0.0
    diff = words_ref = words_got = undecided = 0
    diff_at = []
    for a in range(0, d.shape[0], chunk):
        sym = symbols(d[a: a + chunk], sps, io_bf16)
        slk = room(d[a: a + chunk], None if keep is None else
                   keep[a: a + chunk], sps, io_bf16)
        q = quality(sym, corr_bf16)
        C, _, no = q.shape
        flat = q.reshape(C, sps * no)
        pos = (torch.arange(sps, device=q.device)[:, None]
               + sps * torch.arange(no, device=q.device)[None, :]
               ).reshape(-1)
        st = slots["starts"][a: a + chunk].to(torch.int64)
        qs = slots["quality"][a: a + chunk].to(torch.float64)
        u = st - L * sps                                 # trigger offsets
        inside = (u >= 0) & (u < sps * no)
        col = torch.remainder(u, sps) * no + torch.div(
            u, sps, rounding_mode="floor").clamp(0, no - 1)
        for k in range(st.shape[1]):
            best = flat.max(-1).values
            at = torch.where(inside[:, k], flat.gather(
                -1, col[:, k: k + 1])[:, 0], torch.full_like(best, -OFF))
            at = torch.where(torch.isinf(at), -OFF, at)
            none = torch.isinf(best)
            g = torch.where(none, torch.where(torch.isinf(qs[:, k]), 0.0,
                                              OFF), best - at)
            gap = max(gap, float(g.max()))
            e = torch.where(none & torch.isinf(qs[:, k]), 0.0,
                            (torch.nan_to_num(qs[:, k], neginf=-OFF)
                             - at).abs())
            qerr = max(qerr, float(e.max()))
            s = u[:, k: k + 1]
            mask = (pos[None] > s - L * sps) & \
                (pos[None] < s + (L + recc.CAPTURE) * sps)
            flat = flat.masked_fill(mask, float("-inf"))
        q_at = q.reshape(C, -1).gather(-1, col) * inside
        gate, ok, words, decided = _gates(sym, st, sps, io_bf16,
                                          d.shape[-1], slk)
        valid = (q_at >= threshold) & inside & gate
        decided &= (q_at - threshold).abs() > 2.0 ** -6
        g_ok = slots["word_ok"][a: a + chunk].to(torch.bool)
        same = (slots["valid"][a: a + chunk].to(torch.bool) == valid) & \
            (g_ok == ok).all(-1) & \
            ((slots["words"][a: a + chunk].to(torch.uint8) == words)
             .all(-1) | ~ok).all(-1)
        bad = ~same & decided
        diff += int(bad.sum())
        for c, k in bad.nonzero().tolist()[:4 - len(diff_at)]:
            diff_at.append((a + c, k, int(st[c, k])))
        undecided += int((~decided).sum())
        words_ref += int(ok.sum())
        words_got += int(g_ok.sum())
    return {"pick_gap": gap, "quality_err": qerr, "slot_diff": diff,
            "words_at_picks": (words_got, words_ref),
            "slots_rounding_decides": undecided, "diff_at": diff_at}
