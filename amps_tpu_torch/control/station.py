"""Base-station call control: the recc_decode dispatch + command processor
as one host-side state machine.  The PyTorch port of
``amps_tpu.control.station``; the word builders are the port's
(``codec.words``, CPU tensors read as numpy).

Mirrors (with cited fixes) the reference's two control blocks:

* recc_decode_impl::bursts_message dispatch per TIA/EIA-553 Table 3.7.1-1
  (lib/recc_decode_impl.cc:81-272);
* command_processor_impl::commands_message text commands
  (lib/command_processor_impl.cc:84-117).

The PMT message ports become method calls + a StationEvent log:
  focc_words   -> FoccStream.push_words
  fvc_words    -> FvcStream.set_words
  audio_mute / fvc_mute -> attributes + events (voice path consumes them)
  command_out  -> handle_command (loopback, as in the reference flowgraph)
  debug_output -> events (and the TCP server's reply channel)

Conscious fixes vs the reference (SURVEY.md §7 quirks):
* words are parsed from the BCH-corrected bits, not the raw first repeat;
* word B must itself have decoded OK (the reference only checks word A);
* the out-of-bounds 48-bit read of the 36-bit decode is gone by design.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from amps_tpu_torch.codec import words as W
from amps_tpu_torch.config import PipelineConfig, SystemConfig
from amps_tpu_torch.control import fields
from amps_tpu_torch.control.supervision import (ALERTING, CONVERSATION,
                                          ChannelSupervisor,
                                          SupervisionConfig,
                                          SupervisionEvent)
from amps_tpu_torch.tx.focc import FoccStream, STREAM_BOTH
from amps_tpu_torch.tx.fvc import FvcStream

RELEASE_ORDER = 3   # 553 Table 3.7.1-1 release; not present in reference


@dataclasses.dataclass
class StationEvent:
    kind: str        # focc_words|fvc_words|audio_mute|fvc_mute|command|debug
    payload: object
    t: float = dataclasses.field(default_factory=time.monotonic)


class BaseStation:
    """Call-control state machine wired to the TX streams."""

    def __init__(self, system: Optional[SystemConfig] = None,
                 pipe: Optional[PipelineConfig] = None,
                 on_event: Optional[Callable[[StationEvent], None]] = None,
                 sps: Optional[int] = None,
                 per_channel_fvc: bool = False):
        """``sps``: samples per Manchester symbol for the TX streams —
        pipe.sps (5, the 100 ksps single-channel rate) by default;
        multichannel deployments pass pipe.chan_sps (3, the 60 ksps
        channelizer slot rate).

        ``per_channel_fvc``: give every voice channel its OWN FVC
        stream and mute pair (``fvc_for``/``fvc_mute_for``) so
        CONCURRENT calls signal independently — alerts, releases and
        handoff designations ride the target call's forward channel
        only.  The default keeps the reference's single shared fvc
        block (one call's signaling at a time; handoff refuses while
        other calls are active — the documented shared-FVC caveat)."""
        self.system = system or SystemConfig()
        self.pipe = pipe or PipelineConfig()
        sps = sps or self.pipe.sps
        self._sps = sps
        self.focc = FoccStream(self.system, sps=sps)
        self.fvc = FvcStream(sps=sps, on_command=self.handle_command)
        self.per_channel_fvc = per_channel_fvc
        self.fvc_streams: Dict[int, FvcStream] = {}
        self.fvc_mutes: Dict[int, bool] = {}
        self.audio_mutes: Dict[int, bool] = {}
        self.audio_mute = False
        self.fvc_mute = True
        self.events: List[StationEvent] = []
        self._on_event = on_event
        # round-robin voice channel assignment over the configured plan
        # (the reference hardcodes 355 for page responses and 356 for
        # originations, lib/recc_decode_impl.cc:205,252)
        self._vc_plan = self.system.voice_channels
        # per-voice-channel SAT/ST supervision (an extension over the
        # reference, which never verifies the transponded SAT —
        # control/supervision.py)
        self.supervision_config = SupervisionConfig()
        self.supervisors: Dict[int, ChannelSupervisor] = {}

    # -- plumbing ----------------------------------------------------------

    def _emit(self, kind: str, payload) -> None:
        ev = StationEvent(kind, payload)
        self.events.append(ev)
        if self._on_event:
            self._on_event(ev)

    def _debug(self, msg: str) -> None:
        self._emit("debug", msg)

    def _push_focc(self, *words28, repeats: int = 1) -> None:
        ws = [np.asarray(w, dtype=np.uint8) for w in words28]
        self.focc.push_words(STREAM_BOTH, ws, repeats=repeats)
        self._emit("focc_words", ws)

    def fvc_for(self, chan: Optional[int]) -> FvcStream:
        """The FVC stream serving voice channel ``chan``: per-channel
        when ``per_channel_fvc`` (independent concurrent-call
        signaling), else the single shared stream (reference parity —
        one fvc block, grc/ampsbs.grc)."""
        if not self.per_channel_fvc or chan is None:
            return self.fvc
        if chan not in self.fvc_streams:
            self.fvc_streams[chan] = FvcStream(
                sps=self._sps,
                on_command=lambda cmd, c=chan: self._fvc_timer_cmd(cmd, c))
        return self.fvc_streams[chan]

    def _fvc_timer_cmd(self, cmd: str, chan: int) -> None:
        """Per-channel timerhack: a self-terminating burst's 'fvc off'
        applies to ITS channel's mute pair only."""
        if cmd.startswith("fvc off"):
            self._set_mutes(fvc_mute=True, audio_mute=False, chan=chan)
        else:
            self.handle_command(cmd)

    def fvc_mute_for(self, chan: Optional[int]) -> bool:
        if self.per_channel_fvc and chan is not None:
            return self.fvc_mutes.get(chan, True)
        return self.fvc_mute

    def audio_mute_for(self, chan: Optional[int]) -> bool:
        if self.per_channel_fvc and chan is not None:
            return self.audio_mutes.get(chan, False)
        return self.audio_mute

    def _set_fvc(self, word28, timer: int = 0,
                 chan: Optional[int] = None) -> None:
        w = np.asarray(word28, dtype=np.uint8)
        self.fvc_for(chan).set_words(w, timer=timer)
        self._emit("fvc_words",
                   (w, timer) if (chan is None or not self.per_channel_fvc)
                   else (chan, w, timer))

    def _set_mutes(self, fvc_mute: bool, audio_mute: bool,
                   chan: Optional[int] = None) -> None:
        if self.per_channel_fvc and chan is not None:
            self.fvc_mutes[chan] = fvc_mute
            self.audio_mutes[chan] = audio_mute
            self._emit("fvc_mute", (chan, fvc_mute))
            self._emit("audio_mute", (chan, audio_mute))
            return
        self.fvc_mute = fvc_mute
        self.audio_mute = audio_mute
        self._emit("fvc_mute", fvc_mute)
        self._emit("audio_mute", audio_mute)

    # -- RECC burst dispatch (lib/recc_decode_impl.cc:81-168) --------------

    def handle_burst(self, words, word_ok, bad_symbols=None) -> None:
        """Dispatch one decoded RECC burst.

        words: (7, 36) uint8 corrected bits; word_ok: (7,) bool;
        bad_symbols: optional (8,) Manchester bad-pair counts (DCC +
        7 words, BurstReport.bad_symbols) — BCH-aliased noise captures
        average ~120/240 bad pairs per word where real bursts are ~0,
        so words A/B above SystemConfig.recc_max_bad_symbols drop the
        burst before any call-control action.
        """
        words = np.asarray(words)
        ok = np.asarray(word_ok)
        if bad_symbols is not None:
            bad = np.asarray(bad_symbols)
            if bad[1:3].max() > self.system.recc_max_bad_symbols:
                self._debug(f"dropping noise burst (bad symbol counts "
                            f"{bad[1:3].tolist()})")
                return
        # a seizure happened: mark the RECC busy for one superframe so
        # other mobiles defer while this response is pending (553 §3.1.1;
        # FoccStream.mark_busy documents the granularity)
        self.focc.mark_busy(1)
        if not ok[0]:
            self._debug("got a burst with an invalid Word A")
            return
        wa = fields.RxWordA.parse(words[0])
        if not wa.E:
            self._debug("got a RECC message with E=0; not sure what this is")
            return
        if not ok[1]:
            # fix: the reference uses word B unchecked
            self._debug("burst with invalid Word B; dropping")
            return
        wb = fields.RxWordB.parse(words[1])

        if not wa.T and wb.ORDER == 0 and wb.ORDQ == 0 and wb.MSG_TYPE == 0:
            self._handle_response(wa, wb)
        elif wa.T and wb.ORDER == 0xD:
            self._handle_registration(wa, wb, words, ok)
        elif wa.T and (wa.NAWC > 2 or (wb.ORDER == 0 and wb.ORDQ == 0
                                       and wb.MSG_TYPE == 0)):
            self._handle_origination(wa, wb, words, ok)
        else:
            self._debug(
                f"got unknown RECC message: ORDER {wb.ORDER:#x} "
                f"ORDQ {wb.ORDQ:#x} MSG_TYPE {wb.MSG_TYPE:#x}")

    def _assign_voice_channel(self, kind: str) -> Optional[int]:
        """Voice channel for a new call.  Reference behavior (shared
        FVC): page responses prefer plan[0] = 355, originations
        plan[1] = 356 (lib/recc_decode_impl.cc:205,252), falling over
        to the other plan channel — never onto a live call — and None
        when both are busy.  In ``per_channel_fvc`` (multi-call) mode:
        the first FREE channel of the plan, or None when the plan is
        exhausted."""
        if self.per_channel_fvc:
            for c in self._vc_plan:
                # a channel whose per-channel FVC is still unmuted has a
                # pending signaling burst (typically a release order
                # whose timerhack 'fvc off' has not fired yet) — handing
                # it to a new call would replace the pending burst and
                # the released mobile might never hear its release
                if c not in self.supervisors and self.fvc_mutes.get(c, True):
                    return c
            return None
        # shared-FVC mode keeps the reference's preferred mapping but
        # (fix vs reference) never clobbers a LIVE call's supervisor:
        # replacing supervisors[chan] would orphan the previous call
        # with no release order ever sent (handoff() refuses the same
        # clobber for the same reason).  Preferred channel first, then
        # the other plan channel, else None -> caller drops the access
        # (the mobile retries per 553 access procedures).
        if kind == "response" or len(self._vc_plan) < 2:
            pref = list(dict.fromkeys(
                [self._vc_plan[0]] + list(self._vc_plan[1:2])))
        else:
            pref = [self._vc_plan[1], self._vc_plan[0]]
        for c in pref:
            if c not in self.supervisors:
                return c
        return None

    def _handle_response(self, wa: fields.RxWordA, wb: fields.RxWordB):
        """Page response -> voice assignment + FVC alert
        (lib/recc_decode_impl.cc:195-222)."""
        reqmin = fields.calc_min(wa.MIN1, wb.MIN2)
        self._debug(f"got a response from MIN={reqmin}")
        chan = self._assign_voice_channel("response")
        if chan is None:
            self._debug("no free voice channel; response dropped\n")
            return
        word1 = W.focc_word1(True, self.system.dcc, wa.MIN1)
        word2 = W.focc_word2_voice_channel(self.system.scc, wb.MIN2, 0, chan)
        self._push_focc(word1, word2)
        alert = W.fvc_word1_general(self.system.scc, 0, 0, 1)
        self._set_fvc(alert, timer=self.system.fvc_alert_repeats,
                      chan=chan)
        self._set_mutes(fvc_mute=False, audio_mute=True, chan=chan)
        self._start_supervision(chan, ALERTING)

    def _handle_registration(self, wa, wb, words, ok):
        """Registration order -> audit-order confirmation
        (lib/recc_decode_impl.cc:123-138,181-190)."""
        reqmin = fields.calc_min(wa.MIN1, wb.MIN2)
        self._debug(f"got registration from MIN={reqmin}")
        esn = None
        if wa.S and wa.NAWC > 1:
            # fix vs reference: word C is only trusted when its BCH
            # decode succeeded — an uncorrectable word C would report a
            # garbage ESN (the confirmation itself needs only MIN)
            if not ok[2]:
                self._debug("registration word C failed decode; "
                            "confirming without ESN")
            else:
                wc = fields.RxWordC.parse(words[2])
                esn = wc.SERIAL
                self._debug(f"registration included S; ESN={esn:x}")
                if wc.NAWC != wa.NAWC - 2:
                    self._debug("protocol violation!  Word C NAWC does "
                                "not agree with Word A's -- continuing "
                                "anyway")
        word1 = W.focc_word1(True, self.system.dcc, wa.MIN1)
        word2 = W.focc_word2_general(wb.MIN2, 0, 0, 7)  # audit order
        self._push_focc(word1, word2)

    def _handle_origination(self, wa, wb, words, ok):
        """Origination -> voice assignment (or intercept for leading '0')
        + 'page <digits>' command (lib/recc_decode_impl.cc:139-165,236-272).
        """
        nawc = wa.NAWC
        esn = 0
        nextword = 2
        if wa.S:
            # fix vs reference: an uncorrectable word C carries a
            # garbage ESN — log and continue without it (NAWC
            # adjustment depends only on word A's S bit)
            if ok[nextword]:
                wc = fields.RxWordC.parse(words[nextword])
                esn = wc.SERIAL
                if wc.NAWC != wa.NAWC - 2:
                    self._debug("protocol violation!  Word C NAWC does "
                                "not agree with Word A's -- continuing "
                                "anyway")
            else:
                self._debug("origination word C failed decode; "
                            "ESN unknown")
            nextword += 1
            nawc = wa.NAWC - 2
        if nawc < 1 or nawc > 4:
            self._debug(f"invalid NAWC value in RECC origination: {nawc:#x}")
            return
        dialed = ""
        for _ in range(nawc):
            # fix vs reference: a failed called-address word would
            # dial garbage digits — assigning a voice channel and
            # paging a WRONG number is worse than dropping (the mobile
            # retries per 553 access procedures)
            if not ok[nextword]:
                self._debug("called-address word failed decode; "
                            "origination dropped\n")
                return
            cw = fields.RxWordCalled.parse(words[nextword])
            nextword += 1
            dialed += cw.digits()
        reqmin = fields.calc_min(wa.MIN1, wb.MIN2)
        self._debug(f"origination: MIN={reqmin} ESN={esn:x} dialed {dialed}")

        intercept = bool(dialed and dialed[0] == "0")
        chan = None
        if not intercept:
            # an intercept order needs no voice channel, so plan
            # exhaustion must not block it (the reference always
            # delivers the intercept)
            chan = self._assign_voice_channel("origination")
            if chan is None:
                self._debug("no free voice channel; origination dropped\n")
                return
        word1 = W.focc_word1(True, self.system.dcc, wa.MIN1)
        if intercept:
            # intercept order instead of voice assignment
            word2 = W.focc_word2_general(wb.MIN2, 0, 0, 9)
        else:
            word2 = W.focc_word2_voice_channel(self.system.scc, wb.MIN2, 0,
                                               chan)
        self._push_focc(word1, word2)
        if intercept:
            # the intercept rides the FOCC; no voice channel is touched.
            # Only a shared-slot station keeps the legacy global-mute
            # reset — on a per-channel station the global pair is dead
            # state no mapped slot consults, and flipping it would emit
            # misleading global mute events (r4 advisor finding)
            if not self.per_channel_fvc:
                self._set_mutes(fvc_mute=True, audio_mute=False, chan=None)
        else:
            self._set_mutes(fvc_mute=True, audio_mute=False, chan=chan)
        if not intercept:
            # originating mobile is already off-hook: conversation state
            self._start_supervision(chan, CONVERSATION)
        self._emit("command", f"page {dialed}")
        self.handle_command(f"page {dialed}")

    # -- SAT/ST supervision (extension; control/supervision.py) ------------

    def _start_supervision(self, chan: int, state: str) -> None:
        sup = ChannelSupervisor(chan, self.system.scc,
                                self.supervision_config,
                                on_event=self._on_supervision_event,
                                state=state)
        if state == ALERTING:
            sup.begin_alert()
        self.supervisors[chan] = sup
        self._emit("supervision", (chan, state))

    def _on_supervision_event(self, ev: SupervisionEvent) -> None:
        self._emit("supervision_event", ev)
        if ev.kind == "release":
            self.release_call(ev.channel, ev.reason)
        elif ev.kind == "answer":
            self._debug(f"mobile on channel {ev.channel} answered\n")
            if self.per_channel_fvc:
                # voice path up on THIS call's channel only
                self._set_mutes(fvc_mute=True, audio_mute=False,
                                chan=ev.channel)
            else:
                self.handle_command("fvc off")  # voice path up

    def push_supervision(self, chan: int, levels, power) -> None:
        """Feed per-frame [SAT0-2, ST] amplitudes + band power for one
        voice channel (from rx.voice.supervision_levels)."""
        sup = self.supervisors.get(chan)
        if sup is not None:
            sup.push_frames(levels, power)

    def handoff(self, old_chan: int, new_chan: int, vmac: int = 0) -> bool:
        """Intra-station handoff: move the active call on ``old_chan``
        to ``new_chan`` (extension — the reference cannot move or even
        end calls).

        Sends the VMAC/CHAN voice-channel designation on the station's
        FVC (blank-and-burst, reusing the alert timer so the burst
        self-terminates); per 553 §2.4.8 the mobile confirms with
        a 50 ms ST burst, retunes, and transponds SAT on the new
        channel, where supervision resumes in the same call state (the
        5 s fade timeout comfortably covers the retune gap).

        With the default shared FVC stream (the reference's single fvc
        block) the designation would be heard by every mobile on
        whichever channel carries it, so handoff is refused while any
        OTHER call is active.  ``per_channel_fvc`` lifts this: the
        designation rides the OLD channel's own stream (where the
        mobile is listening) and concurrent calls are untouched.
        """
        if new_chan == old_chan or new_chan in self.supervisors:
            # never clobber another live call's supervisor (it would be
            # silently dropped without a release on its channel)
            self._debug(f"handoff: target channel {new_chan} not free\n")
            return False
        if (not self.per_channel_fvc
                and any(c != old_chan for c in self.supervisors)):
            self._debug("handoff: refused, other calls active and the "
                        "FVC stream is shared\n")
            return False
        sup = self.supervisors.pop(old_chan, None)
        if sup is None or sup.state not in (ALERTING, CONVERSATION):
            if sup is not None:
                self.supervisors[old_chan] = sup
            self._debug(f"handoff: no active call on channel {old_chan}\n")
            return False
        word = W.fvc_word1_voice_channel(self.system.scc, self.system.scc,
                                         vmac, new_chan)
        self._set_fvc(word, timer=self.system.fvc_alert_repeats,
                      chan=old_chan)
        self._set_mutes(fvc_mute=False, audio_mute=True, chan=old_chan)
        if self.per_channel_fvc:
            # the retuned mobile continues its call on the new channel:
            # voice path up there from the start
            self._set_mutes(fvc_mute=True, audio_mute=False,
                            chan=new_chan)
        self._start_supervision(new_chan, sup.state)
        self._emit("handoff", (old_chan, new_chan))
        self._debug(f"handoff: channel {old_chan} -> {new_chan}\n")
        return True

    def release_call(self, chan: int, reason: str = "") -> None:
        """Send the FVC release order and tear the channel down.

        Shared-FVC caveat (see handoff): with multiple concurrent calls
        the release order rides the one FVC stream and may be heard on
        another call's channel; the supervisor teardown itself is
        always channel-exact."""
        sup = self.supervisors.pop(chan, None)
        if (not self.per_channel_fvc
                and any(c != chan for c in self.supervisors)):
            self._debug("release: other calls active; shared-FVC order "
                        "may be heard on their channels\n")
        self._debug(f"releasing channel {chan}: {reason}\n")
        rel = W.fvc_word1_general(self.system.scc, 0, 0, RELEASE_ORDER)
        # the FVC timer mechanism self-emits 'fvc off' after the order
        # has repeated (the reference's timerhack, lib/fvc_impl.cc:163)
        self._set_fvc(rel, timer=self.system.fvc_alert_repeats, chan=chan)
        self._set_mutes(fvc_mute=False, audio_mute=True, chan=chan)
        self._emit("release", (chan, reason))

    # -- operator commands (lib/command_processor_impl.cc:84-117) ----------

    def handle_command(self, cmdstr: str) -> None:
        cmd = cmdstr.strip("\x00")
        if cmd.startswith("fvc off"):
            self._set_mutes(fvc_mute=True, audio_mute=False)
            self._debug("turning FVC data OFF; audio ON\n")
        elif cmd.startswith("fvc on"):
            self._set_mutes(fvc_mute=False, audio_mute=True)
            self._debug("turning FVC data ON; audio OFF\n")
        elif cmd.startswith("fvc alert"):
            alert = W.fvc_word1_general(self.system.scc, 0, 0, 1)
            self._set_fvc(alert, timer=0)
        elif cmd.lower().startswith("page "):
            self._handle_page(cmd[5:].strip())
        elif cmd.lower().startswith("handoff "):
            # extension command: 'handoff <old_chan> <new_chan>'
            parts = cmd.split()
            try:
                old_c, new_c = int(parts[1]), int(parts[2])
            except (ValueError, IndexError):
                self._debug("usage: handoff <old_chan> <new_chan>\n")
            else:
                self.handoff(old_c, new_c)
        elif cmd.lower().startswith("release "):
            # extension command: 'release <chan>' — operator-initiated
            # teardown (FVC release order + supervisor removal)
            parts = cmd.split()
            try:
                chan = int(parts[1])
            except (ValueError, IndexError):
                self._debug("usage: release <chan>\n")
            else:
                if chan in self.supervisors:
                    self.release_call(chan, "operator release")
                else:
                    self._debug(f"release: no active call on channel "
                                f"{chan}\n")
        else:
            self._debug("invalid command\n")

    def _handle_page(self, numstr: str) -> None:
        """lib/command_processor_impl.cc:58-82."""
        if len(numstr) < 1:
            self._debug("missing MIN in page command\n")
            return
        parsed = fields.parse_min(numstr)
        if parsed is None:
            self._debug("invalid MIN entered")
            return
        self._debug("paging!\n")
        min1, min2 = parsed
        word1 = W.focc_word1(True, self.system.dcc, min1)
        word2 = W.focc_word2_general(min2, 0, 0, 0)  # page order
        # repeated across superframes: an origination marks the RECC
        # busy for the superframe that carries the first copy, so the
        # paged mobile would otherwise defer and never hear it again
        self._push_focc(word1, word2, repeats=self.system.page_repeats)
