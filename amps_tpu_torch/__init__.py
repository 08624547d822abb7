"""amps_tpu_torch — the PyTorch/CUDA port of ``amps_tpu`` for NVIDIA Hopper.

The JAX package ``amps_tpu`` stays the reference; this package keeps its
module paths and function names so each counterpart is easy to find, and
never imports ``jax`` or ``amps_tpu``.

Slices ported so far:

* the single-device receive block
  ``parallel.pipeline.rx_multichannel_block`` (analysis bank -> FM
  discriminator -> integrate-and-dump -> trigger search -> capture ->
  BCH decode), stages 1-3 in ``kernels/rx_phases.py``;
* the station's streaming duplex, ``runtime.streamer``:
  ``MultichannelReceiver`` with its front end in ``kernels/rx_front.py``
  and ``MultichannelTransmitter`` with its synthesis bank in
  ``kernels/synth.py``, plus checkpoints (``runtime.state``) and
  elastic recovery (``runtime.resilient``).

Each kernel wrapper launches a hand-written CUDA kernel (``csrc/``) on
CUDA tensors and runs its plain PyTorch version on CPU tensors.
"""

__version__ = "0.1.0"

from amps_tpu_torch import device  # noqa: F401  (TF32 off on import)
from amps_tpu_torch.config import SystemConfig, PipelineConfig  # noqa: F401
