"""The PyTorch port's constant tables are bit-equal to the JAX package's,
and the port imports neither JAX nor the JAX package."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from amps_tpu.codec import bch as jbch
from amps_tpu.codec import bits as jbits
from amps_tpu.dsp import channelizer as jchz
from amps_tpu.dsp import windows as jwin
from amps_tpu.pallas import rx_phases_kernel as jk3
from amps_tpu.pallas import synthesizer_kernel as jk4
from amps_tpu.rx import correlator as jcor
from amps_tpu.rx import decoder as jdec
from amps_tpu_torch.codec import bch as tbch
from amps_tpu_torch.codec import bits as tbits
from amps_tpu_torch.dsp import channelizer as tchz
from amps_tpu_torch.dsp import polyphase as tpoly
from amps_tpu_torch.dsp import windows as twin
from amps_tpu_torch.kernels import analysis as tka
from amps_tpu_torch.kernels import synth as tk4
from amps_tpu_torch.rx import correlator as tcor
from amps_tpu_torch.rx import decoder as tdec

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["hamming", "hann", "blackman",
                                  "blackman_harris", "rectangular"])
def test_window(kind):
    assert np.array_equal(twin._window(kind, 257), jwin._window(kind, 257))


@pytest.mark.parametrize("M,T", [(16, 4), (64, 8), (256, 8), (1024, 8)])
def test_prototype_taps_and_dft_mats(M, T):
    assert np.array_equal(tchz.prototype_taps(M, T), jchz.prototype_taps(M, T))
    for a, b in zip(tchz._dft_mats(M), jchz._dft_mats(M)):
        assert np.array_equal(a, b)
    for a, b in zip(tpoly._dft_mats_folded(M), jchz._dft_mats_folded(M)):
        assert np.array_equal(a, b)
    assert tchz.default_split(M) == jchz.default_split(M)


@pytest.mark.parametrize("M,M2", [(32, 8), (1024, 128)])
def test_dft_split_mats(M, M2):
    for a, b in zip(tchz._dft_split_mats(M, M2), jchz._dft_split_mats(M, M2)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("M,T", [(64, 8), (256, 8), (1024, 8)])
def test_kernel_tables_match_pallas_k3(M, T):
    """The FFT tile's tables that the K3 and K4 kernels are handed: the
    fold coefficients are K3's ``_fold_coef`` bit for bit; K4's gain taps
    are its ``_ola_coef`` ((T, M), taps × P); the twiddles are W_M^e =
    e^{-j2πe/M} of ``fft_twiddle_exponents`` from float64, to f32
    rounding."""
    coef, tw = tka._tables(M, T, torch.device("cpu"))
    assert np.array_equal(coef.numpy(), jk3._fold_coef(M, T))
    gm = tk4._gain_taps(M, T, torch.device("cpu"))
    assert gm.shape == (T, M)
    assert np.array_equal(gm.numpy(), jk4._ola_coef(M, T))
    e = tka.fft_twiddle_exponents(M)
    want = np.exp(-2j * np.pi * e.astype(np.float64) / M)
    assert tw.shape == (len(e), 2)
    assert np.abs(tw[:, 0].numpy() - want.real).max() < 1e-7
    assert np.abs(tw[:, 1].numpy() - want.imag).max() < 1e-7


@pytest.mark.parametrize("sps", [1, 3])
def test_correlator_tables(sps):
    assert np.array_equal(tcor.trigger_template(sps),
                          jcor.trigger_template(sps))
    for O in (128, 256):
        for a, b in zip(tcor._detection_kernels(sps, O),
                        jcor._detection_kernels(sps, O)):
            assert np.array_equal(a, b)
    assert np.array_equal(tcor._dump_matrix(sps), jcor._dump_matrix(sps))
    for name in ("TRIGGER_SYMBOLS", "CAPTURE_SYMBOLS", "DC_EST_SYMBOLS",
                 "RSSI_BLOCK", "SYM_BLOCK", "MAX_TRIGGER_ERRORS"):
        assert getattr(tcor, name) == getattr(jcor, name), name
    assert np.array_equal(tcor.TRIGGER_BITS, jcor.TRIGGER_BITS)


def test_codec_tables():
    assert np.array_equal(tbch.recc_syndrome_matrix(),
                          jbch.recc_syndrome_matrix())
    assert np.array_equal(tbch.recc_decode_table_packed(),
                          jbch.recc_decode_table_packed())
    for k in (28, 36):
        assert np.array_equal(tbch._parity_matrix(k), jbch._parity_matrix(k))
    for a, b in zip(tdec._word_syndrome_op(), jdec._word_syndrome_op()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("nbits", [3, 12, 24, 36])
def test_bits_match_jax(nbits):
    rng = np.random.default_rng(nbits)
    for v in rng.integers(0, 1 << nbits, 20):
        assert np.array_equal(tbits.expandbits_np(int(v), nbits),
                              jbits.expandbits_np(int(v), nbits))
    if nbits < 32:   # packbits' default dtypes (int32 / uint32) hold < 32 bits
        bits = rng.integers(0, 2, (5, 7, nbits)).astype(np.uint8)
        got = tbits.packbits(torch.as_tensor(bits)).numpy()
        assert np.array_equal(got, np.asarray(jbits.packbits(bits)))


def test_port_imports_without_jax():
    """The port must run where JAX is not installed: every module of it,
    the apps and examples included, imports with jax, amps_tpu and the
    repository's JAX apps and examples blocked."""
    code = ("import sys\n"
            "for name in ('jax', 'amps_tpu', 'apps', 'examples'):\n"
            "    sys.modules[name] = None\n"
            "import importlib, pkgutil, amps_tpu_torch\n"
            "for m in pkgutil.walk_packages(amps_tpu_torch.__path__,\n"
            "                               'amps_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "for m in ('amps_tpu_torch.runtime.resilient',\n"
            "          'amps_tpu_torch.apps.bs_app',\n"
            "          'amps_tpu_torch.examples.call_lifecycle_demo',\n"
            "          'amps_tpu_torch.__main__'):\n"
            "    assert m in sys.modules, m\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'jaxlib', 'amps_tpu', 'apps', 'examples')"
            " and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_tf32_off():
    import amps_tpu_torch  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
