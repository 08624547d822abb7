"""Link-quality evaluation: detection and word success vs SNR for the
RECC receiver, the PyTorch port of ``amps_tpu.eval.ber``.

The reference publishes no BER numbers (its acceptance bar is 'decodes
with real phones'); this harness pins the receiver's curve so timing
recovery or correlator changes that regress sensitivity fail loudly.
Every trial of one SNR runs as one batch: the discriminator, the
sample-domain trigger search, one batched capture gather and the BCH
decode.  Noise comes from a ``torch.Generator`` on the curve's device,
seeded by ``seed``: the JAX package's ``jax.random`` stream cannot be
reproduced, so the rates agree with the JAX curves to sampling noise,
not draw for draw.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from amps_tpu_torch.config import PipelineConfig
from amps_tpu_torch.device import resolve_device
from amps_tpu_torch.dsp.fm import fm_modulate_symbols, quadrature_demod
from amps_tpu_torch.eval import channel
from amps_tpu_torch.parallel.pipeline import MultichannelSpec
from amps_tpu_torch.rx import correlator, decoder
from amps_tpu_torch.tx import recc_ms

# the production erasure gate -- derived from the single source of truth
# so retuning MultichannelSpec.repeat_gate retunes the pinned curves too
PRODUCTION_REPEAT_GATE = MultichannelSpec().decode_repeat_gate


def _rx_trials(iq, words_true, sps: int, policy: str, repeat_gate):
    """Shared RX tail: (trials, n, 2) impaired IQ -> (detected (trials,),
    word_good (trials, nw), repeat_used (trials, nw)), on the IQ's
    device.  ``words_true``: (nw, 36) uint8."""
    iq = torch.as_tensor(iq)
    trials = iq.shape[0]
    demod, _ = quadrature_demod(iq)              # (trials, n)
    starts, valid, _ = correlator.find_bursts(demod, sps, 1, 0.5)
    padlen = correlator.CAPTURE_SYMBOLS * sps
    demod_p = torch.cat([demod, demod.new_zeros((trials, padlen))], dim=-1)
    hard, _ = correlator.extract_burst_symbols(demod_p, starts, sps)
    dec = decoder.decode_bursts(hard[:, 0], policy, repeat_gate)
    wt = torch.as_tensor(np.asarray(words_true), device=iq.device)
    nw = wt.shape[0]
    ok = dec.word_ok[:, :nw]
    match = torch.all(dec.words[:, :nw] == wt[None].to(dec.words.dtype),
                      dim=-1)
    detected = valid[:, 0]
    word_good = ok & match & detected[:, None]
    # diagnostics: repeat_used == -1 marks words decoded by the majority
    # vote itself (vs the first_ok fallback)
    return detected, word_good, dec.repeat_used[:, :nw]


def _test_burst_iq(sps: int, device=None):
    """Shared trial signal: a page-response burst with idle lead/tail,
    FSK-modulated at sps samples per symbol.  Returns (iq (n, 2) float32
    on ``device``, (nw, 36) uint8 true words)."""
    pipe = PipelineConfig()
    words = recc_ms.page_response_words("5551234567")
    syms = recc_ms.burst_symbols(words, dcc=0, sps=sps)
    lead = np.tile(np.array([1, -1], np.int8), 300)
    stream = np.concatenate([lead, syms, lead]).astype(np.int8)
    sens = 2.0 * np.pi * pipe.deviation_hz / (sps * pipe.baud)
    iq, _ = fm_modulate_symbols(torch.as_tensor(stream, device=device), sens)
    return iq, np.stack(words).astype(np.uint8)


def _rates(detected, word_good, trials: int, **more) -> dict:
    detected = detected.cpu().numpy()
    word_good = word_good.cpu().numpy()
    return {"detect_rate": float(detected.mean()),
            "word_success_rate": float(word_good.mean()),
            "trials": trials, **more}


def recc_link_curve(snr_dbs: Sequence[float], trials: int = 32,
                    seed: int = 0, sps: int = 3,
                    policy: str = "first_ok",
                    repeat_gate=PRODUCTION_REPEAT_GATE,
                    device=None) -> Dict[float, dict]:
    """Detection rate and word-success rate vs per-sample complex SNR.

    Signal is a unit-modulus FSK burst; SNR(dB) = -10 log10(sigma_c^2)
    with sigma_c^2 the complex noise variance.  ``repeat_gate``
    defaults to the production erasure gate (MultichannelSpec) so
    the pinned curves describe the shipping decode path; None
    measures the ungated legacy decode.  Runs on the current CUDA
    device unless ``device`` names another ("cpu")."""
    dev = resolve_device(device)
    iq, words_true = _test_burst_iq(sps, dev)
    n = iq.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for snr in snr_dbs:
        sigma = float(np.sqrt(10.0 ** (-snr / 10.0) / 2.0))  # per I/Q
        noise = torch.randn((trials, n, 2), generator=gen, device=dev)
        detected, word_good, used = _rx_trials(
            iq[None] + sigma * noise, words_true, sps, policy, repeat_gate)
        rec = _rates(detected, word_good, trials,
                     words_per_burst=int(word_good.shape[1]))
        if policy == "majority" and bool(detected.any()):
            # of the words counted good, how many came from the vote
            # itself (used == -1) vs the first_ok fallback?
            good = (word_good & detected[:, None]).cpu().numpy()
            used = used.cpu().numpy()
            rec["majority_vote_fraction"] = (
                float((good & (used == -1)).sum() / max(good.sum(), 1)))
        out[float(snr)] = rec
    return out


def recc_fading_curve(snr_dbs: Sequence[float], doppler_hz: float = 77.0,
                      trials: int = 64, seed: int = 0, sps: int = 3,
                      policy: str = "majority",
                      repeat_gate=PRODUCTION_REPEAT_GATE,
                      device=None) -> Dict[float, dict]:
    """Detection / word-success vs average SNR under Rayleigh flat
    fading (eval/channel.py, unit mean power, from numpy
    ``default_rng(seed)``) at the given Doppler.

    77 Hz ~ 100 km/h at 835 MHz: a 169 ms RECC burst then spans ~13
    fade cycles, so the 5 repeats of each word see independent fades --
    the regime where majority combining pays.  Runs on the current CUDA
    device unless ``device`` names another ("cpu")."""
    dev = resolve_device(device)
    iq, words_true = _test_burst_iq(sps, dev)
    iq = iq.cpu().numpy()
    n = iq.shape[0]
    fs = float(sps * PipelineConfig().baud)
    rng = np.random.default_rng(seed)
    faded = torch.as_tensor(np.stack([
        channel.apply_gain(iq, channel.rayleigh_gain(n, fs, doppler_hz, rng))
        for _ in range(trials)]), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for snr in snr_dbs:
        sigma = float(np.sqrt(10.0 ** (-snr / 10.0) / 2.0))
        noise = torch.randn((trials, n, 2), generator=gen, device=dev)
        detected, word_good, _ = _rx_trials(
            faded + sigma * noise, words_true, sps, policy, repeat_gate)
        out[float(snr)] = _rates(detected, word_good, trials,
                                 doppler_hz=doppler_hz)
    return out
