"""Samples/s rate meters and profiler ranges, the PyTorch port of
``amps_tpu.utils.profiling``.

Every streaming stage can wrap itself in a RateMeter, and hot sections
in ``trace``, a ``torch.profiler.record_function`` range: it shows in
any ``torch.profiler`` window open around the section and costs nearly
nothing when none is.  The JAX package's ``start_server`` (a
``jax.profiler`` server for TensorBoard capture) has no torch
counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class RateMeter:
    """Exponential-moving-average samples/s counter."""

    def __init__(self, name: str, alpha: float = 0.2):
        self.name = name
        self.alpha = alpha
        self.rate = 0.0
        self.total = 0
        self._t_last: Optional[float] = None

    def update(self, n_samples: int) -> None:
        now = time.perf_counter()
        self.total += n_samples
        if self._t_last is not None:
            dt = now - self._t_last
            if dt > 0:
                inst = n_samples / dt
                self.rate = (self.alpha * inst
                             + (1 - self.alpha) * (self.rate or inst))
        self._t_last = now

    def __repr__(self) -> str:
        return f"RateMeter({self.name}: {self.rate/1e6:.2f} Msamples/s)"


_METERS: Dict[str, RateMeter] = {}


def meter(name: str) -> RateMeter:
    if name not in _METERS:
        _METERS[name] = RateMeter(name)
    return _METERS[name]


@contextlib.contextmanager
def trace(label: str):
    """Mark a section as a ``torch.profiler`` range named ``label``."""
    with torch.profiler.record_function(label):
        yield
