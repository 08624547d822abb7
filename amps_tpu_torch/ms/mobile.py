"""SimMobile: a simulated AMPS mobile station for closed-loop tests, the
PyTorch port of ``amps_tpu.ms.mobile`` (host state machine; the
modulators and codecs are the port's).

The counterpart the reference never had (its acceptance bar was real
phones).  Wire it to a BaseStation and the framework exercises the FULL
call lifecycle in software: page -> page response -> voice assignment ->
alert (ringing) -> answer -> handoff -> release — with every message
crossing the real air-interface encodings (FOCC frames with B/I bits,
FVC blank-and-burst repeats, RECC bursts).

Protocol behavior follows TIA/EIA-553: §2.6.3 FOCC word reception
(3-of-5 majority, implemented in ms/focc_rx.py), §3.1.1 busy/idle
deference, §2.4.8 handoff confirmation (50 ms ST, retune, transpond new
SAT), §2.7.2 signaling-tone semantics (ring = ST on, answer = ST drop,
release = 1.8 s ST).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from amps_tpu_torch.config import SystemConfig
from amps_tpu_torch.control import fields
from amps_tpu_torch.dsp.fm import fm_modulate
from amps_tpu_torch.ms.focc_rx import (FRAME_SYMBOLS, decode_focc_stream,
                                 parse_focc_word)
from amps_tpu_torch.ms.fvc_rx import decode_fvc_words
from amps_tpu_torch.tx import recc_ms

IDLE = "idle"
WAIT_ASSIGN = "wait_assign"     # responded on RECC, awaiting channel
RINGING = "ringing"             # on voice channel, alert received
CONVERSATION = "conversation"
RELEASED = "released"

_ALERT_ORDER = 1
_RELEASE_ORDER = 3

SAT_AMPLITUDE = 0.05
ST_AMPLITUDE = 0.05
FRAME_S = 0.01                  # supervision measurement frame


class SimMobile:
    """One mobile.  Feed forward symbols via hear_focc / hear_fvc; pull
    RECC bursts from .outbox and supervision frames from
    supervision_frames() into BaseStation.push_supervision."""

    def __init__(self, min_str: str, esn: int = 0x1234ABCD, sps: int = 5,
                 system: Optional[SystemConfig] = None):
        self.min_str = min_str
        self.min1, self.min2 = fields.parse_min(min_str)
        self.esn = esn
        self.sps = sps
        self.system = system or SystemConfig()
        self.state = IDLE
        self.voice_chan: Optional[int] = None
        self.sat_scc: Optional[int] = None
        self.recc_busy = False
        self.outbox: List[Tuple[str, np.ndarray]] = []
        self.log: List[str] = []
        self._pending_w1: Optional[dict] = None
        self._pending_access: Optional[Tuple[str, np.ndarray]] = None
        self._st_release_frames = 0     # pending release-ST frames to send
        # which interface is consuming the pending release-ST run:
        # rvc_baseband (physical) and supervision_frames (logical) BOTH
        # decrement it, so a harness driving both for the same interval
        # would halve the 1.9 s run and miss the station's 1.8 s
        # release threshold — latched while a run
        # is pending, cleared when it completes
        self._st_iface = None
        self._focc_tail = np.zeros(0, np.float32)  # block-boundary carry
        self._rvc_n = 0                 # RVC sample clock (tone continuity)
        self._rvc_phase = 0.0           # RVC FM phase carry

    # -- forward listening ---------------------------------------------------

    def hear_focc(self, symbols, sps: Optional[int] = None) -> None:
        sps = sps or self.sps
        # carry the undecoded tail across calls: a frame straddling the
        # caller's block boundary would otherwise be dropped (~1 frame
        # in 7 at typical app block sizes — one mobile of sixteen
        # missed its voice assignment that way in the 16-call soak)
        symbols = np.concatenate(
            [self._focc_tail, np.asarray(symbols, np.float32)])
        frames, consumed = decode_focc_stream(symbols, sps,
                                              return_consumed=True)
        # keep at most ~3 frames of raw residue (FRAME_SYMBOLS is
        # Manchester symbols and a frame spans FRAME_SYMBOLS*sps raw
        # samples, so this is 3 whole frames: enough for a straddling
        # frame's head PLUS one full frame for the header-fold
        # alignment; silence must not grow the tail unboundedly)
        keep = (FRAME_SYMBOLS * 3 // 2) * 2 * sps
        tail = symbols[consumed:] if consumed else symbols
        self._focc_tail = tail[-keep:]
        for fr in frames:
            self.recc_busy = fr.busy
            if fr.ok_a:
                self._on_focc_word(parse_focc_word(fr.word_a))
        if (self._pending_access is not None and not self.recc_busy
                and self.state == IDLE):
            # 553 access procedure: a deferred access retries once the
            # B/I bit reads idle again
            kind, burst = self._pending_access
            self._pending_access = None
            self.outbox.append((kind, burst))
            self.state = WAIT_ASSIGN
            self.log.append(f"deferred_{kind}_sent")

    def _on_focc_word(self, p: dict) -> None:
        if p["type"] == "word1":
            self._pending_w1 = p if p["MIN1"] == self.min1 else None
            return
        if self._pending_w1 is None:
            return
        if p["type"] == "word2_order" and p["MIN2"] == self.min2:
            self._pending_w1 = None
            if p["ORDER"] == 0 and self.state == IDLE:          # page
                self.log.append("paged")
                words = recc_ms.page_response_words(self.min_str)
                burst = recc_ms.burst_symbols(words, dcc=self.system.dcc,
                                              sps=self.sps)
                if self.recc_busy:
                    # §3.1.1: defer the access while the RECC is marked
                    # busy; retried when a later frame reads idle (and
                    # the station also repeats pages across superframes,
                    # SystemConfig.page_repeats)
                    self.log.append("recc_busy_defer")
                    self._pending_access = ("page_response", burst)
                    return
                self.state = WAIT_ASSIGN
                self._pending_access = None   # superseded by this access
                self.outbox.append(("page_response", burst))
            elif p["ORDER"] == 7:                               # audit
                self.log.append("audit_confirmed")
            elif p["ORDER"] == 9:                               # intercept
                self.log.append("intercept")
                self.state = IDLE
        elif p["type"] == "word2_voice" and p["MIN2"] == self.min2:
            self._pending_w1 = None
            self.voice_chan = p["CHAN"]
            self.sat_scc = p["SCC"]
            self.log.append(f"assigned {p['CHAN']}")
            if self.state == WAIT_ASSIGN:
                # tuned and transponding SAT; an FVC alert (if this was
                # a page) moves it to RINGING
                self.state = CONVERSATION

    def hear_fvc(self, symbols, sps: Optional[int] = None) -> None:
        for w in decode_fvc_words(symbols, sps or self.sps):
            self._on_fvc_word(w)

    def _on_fvc_word(self, w: np.ndarray) -> None:
        p = fields.FvcVoiceChannel.parse(w)
        if p.is_order:
            order = int("".join(str(int(b)) for b in np.asarray(w)[23:28]), 2)
            if order == _ALERT_ORDER and self.state == CONVERSATION:
                # repeats of the same alert burst are one order
                self.state = RINGING
                self.log.append("ringing")
            elif order == _RELEASE_ORDER and self.state != RELEASED:
                self.log.append("released_by_station")
                self._st_release_frames = int(1.9 / FRAME_S)
                self.state = RELEASED
        else:
            # handoff designation: confirm with 50 ms ST, retune,
            # transpond the (possibly new) SAT (553 §2.4.8); repeats of
            # the same designation are one order
            if p.CHAN != self.voice_chan:
                self.log.append(f"handoff {self.voice_chan}->{p.CHAN}")
                self.voice_chan = p.CHAN
                self.sat_scc = p.SCC

    # -- user actions ---------------------------------------------------------

    def answer(self) -> None:
        if self.state == RINGING:
            self.state = CONVERSATION
            self.log.append("answered")

    def hang_up(self) -> None:
        """Mobile-initiated release: 1.8 s of ST, then off the channel."""
        if self.state in (RINGING, CONVERSATION):
            self._st_release_frames = int(1.9 / FRAME_S)
            self.state = RELEASED
            self.log.append("hang_up")

    def originate(self, dialed: str) -> None:
        if self.state != IDLE or self.recc_busy:
            self.log.append("originate_blocked")
            return
        words = recc_ms.origination_words(self.min_str, dialed, esn=self.esn)
        self.outbox.append(("origination", recc_ms.burst_symbols(
            words, dcc=self.system.dcc, sps=self.sps)))
        self.state = WAIT_ASSIGN
        self.log.append(f"originate {dialed}")

    def register(self) -> None:
        if self.recc_busy:
            self.log.append("register_blocked")
            return
        words = recc_ms.registration_words(self.min_str, esn=self.esn)
        self.outbox.append(("registration", recc_ms.burst_symbols(
            words, dcc=self.system.dcc, sps=self.sps)))
        self.log.append("register")

    # -- reverse voice channel (SAT/ST transponder) ----------------------------

    def rvc_baseband(self, n: int, fs: float, sens: float) -> np.ndarray:
        """(n, 2) riq of this mobile's transponded reverse-voice-channel
        signal at ``fs`` — the PHYSICAL form of supervision_frames, for
        closed loops where the station measures SAT/ST through its real
        (sharded) analysis bank instead of being fed frames directly
        (553 §2.4.2 transponder; §2.7.2 signaling tone).

        Ringing: SAT + ST.  Conversation: SAT (+1 kHz test voice).
        Mobile release: 1.8 s of ST, then carrier off.  Off channel:
        zeros (dead carrier).  Tone phase and FM phase are continuous
        across calls (sample clock + phase carry)."""
        t = (self._rvc_n + np.arange(n)) / fs
        self._rvc_n += n
        on = self.state in (RINGING, CONVERSATION)
        st_n = 0
        if self._st_release_frames > 0:
            assert self._st_iface in (None, "rvc"), \
                ("release-ST run already being consumed via "
                 "supervision_frames; driving rvc_baseband too would "
                 "double-decrement it and short the release tone")
            self._st_iface = "rvc"
            # exact accounting: decrement by the frames actually SENT
            # (a ceil here shorted the 1.9 s run by up to one frame per
            # block — enough to miss the 1.8 s release threshold at
            # small block sizes and fall back to a fade release)
            st_n = min(n, int(round(self._st_release_frames
                                    * FRAME_S * fs)))
            self._st_release_frames -= st_n / (FRAME_S * fs)
            if self._st_release_frames * FRAME_S * fs < 0.5:
                # clamp the float residue: a stuck positive epsilon
                # would keep this branch shadowing the RINGING branch
                # forever and leak one phantom frame to
                # supervision_frames
                self._st_release_frames = 0
                self._st_iface = None
        elif self.state == RINGING:
            st_n = n
        if not on and st_n == 0:
            return np.zeros((n, 2), np.float32)
        m = np.zeros(n, np.float32)
        if self.sat_scc is not None and (on or st_n > 0):
            f_sat = (5970.0, 6000.0, 6030.0)[self.sat_scc]
            m += SAT_AMPLITUDE * np.cos(2 * np.pi * f_sat * t)
        if st_n > 0:
            m[:st_n] += (ST_AMPLITUDE
                         * np.cos(2 * np.pi * 10_000.0 * t[:st_n]))
        if self.state == CONVERSATION:
            m += 0.3 * np.cos(2 * np.pi * 1000.0 * t)
        carrier_n = n if on else st_n     # release ST then carrier off
        iq, ph = fm_modulate(torch.as_tensor(m[:carrier_n]), sens,
                             self._rvc_phase)
        self._rvc_phase = float(ph) % (2 * np.pi)
        out = np.zeros((n, 2), np.float32)
        out[:carrier_n] = iq.numpy()
        return out

    def supervision_frames(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """(n, 4) [SAT0, SAT1, SAT2, ST] amplitudes + (n,) band power —
        what rx.voice.supervision_levels would measure on this mobile's
        reverse voice channel; feed to BaseStation.push_supervision."""
        levels = np.zeros((n, 4), np.float32)
        power = np.zeros(n, np.float32)
        on_channel = self.state in (RINGING, CONVERSATION)
        if self._st_release_frames > 0:
            assert self._st_iface in (None, "frames"), \
                ("release-ST run already being consumed via "
                 "rvc_baseband; driving supervision_frames too would "
                 "double-decrement it and short the release tone")
            self._st_iface = "frames"
        for f in range(n):
            sending_release_st = self._st_release_frames > 0
            if not on_channel and not sending_release_st:
                continue
            power[f] = 1e-3
            if self.sat_scc is not None:
                levels[f, self.sat_scc] = SAT_AMPLITUDE
            if self.state == RINGING or sending_release_st:
                levels[f, 3] = ST_AMPLITUDE
            if sending_release_st:
                self._st_release_frames -= 1
        if self._st_release_frames <= 0:
            self._st_release_frames = max(0, self._st_release_frames)
            if self._st_iface == "frames":
                self._st_iface = None
        return levels, power
