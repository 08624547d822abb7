"""Mobile-station simulator (the other side of the air interface), the
PyTorch port of ``amps_tpu.ms``.

The reference's acceptance bar is "decodes with real phones"
(README.md:5) — it ships no mobile side at all, so its forward path is
untestable without hardware.  This package is the simulated phone:
FOCC/FVC air-interface decoders and a call state machine, enabling
closed-loop full-call tests (page -> response -> assignment -> alert ->
answer -> handoff -> release) entirely in software.

Eval-grade by design: host NumPy where convenient (a SimMobile decodes
one channel at spec rates; it is not the base station's hot path).
"""

from amps_tpu_torch.ms.focc_rx import decode_focc_stream, parse_focc_word
from amps_tpu_torch.ms.fvc_rx import decode_fvc_stream, decode_fvc_words
from amps_tpu_torch.ms.mobile import SimMobile

__all__ = ["decode_focc_stream", "parse_focc_word",
           "decode_fvc_stream", "decode_fvc_words",
           "SimMobile"]
