"""``amps_tpu_torch.dryrun.entry``, the port's counterpart of
``__graft_entry__.entry``: the same spec (M=16, T=8) and input
(``default_rng(0)`` N(0, 0.1) IQ, 8192 samples), and the same receive
block.  With the default spec (f32 quality planes, ``corr_bf16=False``)
starts, valid, words and word_ok match the JAX forward exactly."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from amps_tpu_torch import dryrun
from amps_tpu_torch.kernels import rx_phases as K3

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry()


def test_entry_matches_the_jax_entry():
    jfn, (jx,) = _jax_entry()
    fn, (x,) = dryrun.entry(device="cpu")
    assert x.device.type == "cpu" and x.dtype == torch.float32
    assert np.array_equal(x.numpy(), np.asarray(jx))
    want = jfn(jx)
    before = K3.LAUNCHES
    got = fn(x)
    assert K3.LAUNCHES == before      # the plain front end on the CPU
    for key in ("starts", "valid", "words", "word_ok"):
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        assert np.array_equal(got[key].numpy(), w), key
    for key in ("rssi", "chan_power"):
        assert np.isfinite(got[key].numpy()).all(), key
    # a second slot that the NMS left no lag reads -inf in both packages
    q, wq = got["quality"].numpy(), np.asarray(want["quality"])
    assert np.array_equal(np.isfinite(q), np.isfinite(wq))
    assert np.abs(q[np.isfinite(q)] - wq[np.isfinite(wq)]).max() < 1e-3


def test_entry_defaults_to_the_card(monkeypatch):
    """Without a device the input goes to the current CUDA device, and
    without CUDA that raises: the CPU is used only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.entry()
