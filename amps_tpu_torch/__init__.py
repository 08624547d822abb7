"""amps_tpu_torch — the PyTorch/CUDA port of ``amps_tpu`` for NVIDIA Hopper.

The JAX package ``amps_tpu`` stays the reference; this package keeps its
module paths and function names so each counterpart is easy to find, and
never imports ``jax`` or ``amps_tpu``.

Ported so far (ROADMAP M0-M6): the single-device receive block
(``parallel.pipeline``, stages 1-3 in ``kernels/rx_phases.py``) and its
batched form; the station's streaming duplex (``runtime.streamer``:
``MultichannelReceiver``, front end ``kernels/rx_front.py``;
``MultichannelTransmitter``, synthesis ``kernels/synth.py``; the fused
closed loop), checkpoints and elastic recovery; the control plane, the
voice channel and the mobile simulator (its ear ``kernels/analysis.py``);
and the station as operators run it: ``apps`` (``python -m
amps_tpu_torch bs|monitor|demo``), the threaded executor, the command
server, SDR and native ring I/O, and the traffic and link-quality
harnesses (``eval``).

Each kernel wrapper launches a hand-written CUDA kernel (``csrc/``) on
CUDA tensors and runs its plain PyTorch version on CPU tensors.
"""

__version__ = "0.1.0"

from amps_tpu_torch import device  # noqa: F401  (TF32 off on import)
from amps_tpu_torch.config import SystemConfig, PipelineConfig  # noqa: F401
