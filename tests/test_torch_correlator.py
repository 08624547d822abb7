"""Trigger search, capture, trigger gate and power blocks of the port
against the JAX package on the same phase streams (numpy in, both
sides): integers and booleans exactly equal, floats within 1e-5 in f32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from amps_tpu.rx import correlator as jcor
from amps_tpu.tx import recc_ms
from amps_tpu_torch.rx import correlator as tcor

torch.set_num_threads(1)

SPS = 3


def _phases(seed=0, C=6, nsym=5200):
    """Noise phase streams with planted bursts at several phases and
    offsets (two on channel 2, one on channel 5 ending past the tail)."""
    rng = np.random.default_rng(seed)
    ph = rng.normal(0, 0.6, (C, SPS, nsym)).astype(np.float32)
    words = [rng.integers(0, 2, 36).astype(np.uint8) for _ in range(3)]
    syms = recc_ms.burst_symbols(words, sps=1).astype(np.float32) * 0.8
    for c, p, s0 in ((0, 0, 100), (1, 2, 40), (2, 1, 10), (2, 0, 4100),
                     (4, 2, 1200), (5, 1, 3000)):
        n = min(len(syms), nsym - s0)
        for q in range(SPS):
            gain = 1.0 if q == p else 0.45
            ph[c, q, s0: s0 + n] = (gain * syms[:n]
                                    + rng.normal(0, 0.05, n))
    return ph


def _to(ph, dtype):
    return (torch.as_tensor(ph).to(torch.bfloat16) if dtype == "bf16"
            else torch.as_tensor(ph))


def _jx(ph, dtype):
    return jnp.asarray(ph, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("max_bursts", [1, 3])
def test_find_bursts_phases(dtype, max_bursts):
    ph = _phases()
    js, jv, jq = (np.asarray(a) for a in jcor.find_bursts_phases(
        _jx(ph, dtype), SPS, max_bursts, 0.55))
    ts, tv, tq = tcor.find_bursts_phases(_to(ph, dtype), SPS, max_bursts,
                                         0.55)
    assert ts.dtype == torch.int32 and tv.dtype == torch.bool
    assert np.array_equal(ts.numpy(), js)
    assert np.array_equal(tv.numpy(), jv)
    np.testing.assert_allclose(tq.numpy(), jq, atol=1e-5)
    assert jv.sum() >= 5


def test_find_bursts_phases_bf16_quality_plane():
    """corr_bf16: the planted bursts are found at the same starts."""
    ph = _phases(seed=1)
    js, jv, _ = (np.asarray(a) for a in jcor.find_bursts_phases(
        _jx(ph, "bf16"), SPS, 2, 0.55, out_bf16=True))
    ts, tv, _ = tcor.find_bursts_phases(_to(ph, "bf16"), SPS, 2, 0.55,
                                        out_bf16=True)
    assert np.array_equal(tv.numpy(), jv)
    assert np.array_equal(ts.numpy()[jv], js[jv])


def _starts(nsym):
    # head (lead symbols before the window, k0 < 0), mid-stream, the
    # tail (capture cut off), far past the end
    return np.array([[0, 7], [16, 74 * SPS - 1], [74 * SPS + 2, 1500],
                     [3 * nsym - 3000, 3 * nsym - 1], [3 * 10 ** 6, 601],
                     [301, 302]], np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lead", [0, 74])
def test_extract_from_phases(dtype, lead):
    ph = _phases(seed=2)
    st = _starts(ph.shape[-1])
    hard_j = jnp.bfloat16 if dtype == "bf16" else jnp.uint8
    hard_t = torch.bfloat16 if dtype == "bf16" else torch.uint8
    want = [np.asarray(a, np.float32) for a in jcor.extract_from_phases(
        _jx(ph, dtype), jnp.asarray(st), SPS, hard_dtype=hard_j, lead=lead)]
    got = tcor.extract_from_phases(_to(ph, dtype), torch.tensor(st), SPS,
                                   hard_dtype=hard_t, lead=lead)
    assert len(got) == len(want) == (2 if lead == 0 else 3)
    assert got[0].dtype == hard_t
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.float().numpy(), w)


@pytest.mark.parametrize("found", [True, False])
def test_trigger_gate_soft(found):
    """Gate on detector starts, and on hand-made starts whose lead
    symbols fall before the stream head."""
    ph = _phases(seed=3)
    if found:
        st = np.asarray(jcor.find_bursts_phases(jnp.asarray(ph), SPS, 2,
                                                0.3)[0])
    else:
        st = _starts(ph.shape[-1])
    valid = np.ones(st.shape, bool)
    _, _, lead = jcor.extract_from_phases(jnp.asarray(ph), jnp.asarray(st),
                                          SPS, lead=74)
    lead_np = np.asarray(lead)
    for max_err in (-1, 0, 6, 40):
        want = np.asarray(jcor.apply_trigger_gate_soft(
            jnp.asarray(valid), lead, max_err, jnp.asarray(st), SPS))
        got = tcor.apply_trigger_gate_soft(
            torch.as_tensor(valid), torch.tensor(lead_np), max_err,
            torch.tensor(st), SPS)
        assert np.array_equal(got.numpy(), want), max_err
    want = np.asarray(jcor.trigger_errors_soft(lead))
    got = tcor.trigger_errors_soft(torch.tensor(lead_np))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_power_blocks_and_rssi():
    rng = np.random.default_rng(4)
    pw = rng.exponential(0.5, (5, 10001)).astype(np.float32)
    want = np.asarray(jcor.window_power_blocks([jnp.asarray(pw)]))
    got = tcor.window_power_blocks([torch.as_tensor(pw)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    want_2 = np.asarray(jcor.window_power_blocks(
        [jnp.asarray(pw[:, :500]), jnp.asarray(pw[:, 500:])]))
    got_2 = tcor.window_power_blocks([torch.as_tensor(pw[:, :500]),
                                      torch.as_tensor(pw[:, 500:])])
    np.testing.assert_allclose(got_2.numpy(), want_2, rtol=1e-5)
    np.testing.assert_allclose(
        tcor.power_from_blocks(got, 10001).numpy(),
        np.asarray(jcor.power_from_blocks(jnp.asarray(want), 10001)),
        rtol=1e-5)
    st = np.array([[0, 385], [5000, 9990], [-400, 20000], [383, 384],
                   [1, 2]], np.int32)
    want_r = np.asarray(jcor.burst_rssi_blocks(jnp.asarray(want),
                                               jnp.asarray(st), SPS))
    got_r = tcor.burst_rssi_blocks(torch.tensor(want), torch.tensor(st),
                                   SPS)
    np.testing.assert_allclose(got_r.numpy(), want_r, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_symbol_phase_streams(dtype):
    rng = np.random.default_rng(5)
    d = rng.uniform(-np.pi, np.pi, (4, 1001)).astype(np.float32)
    want = np.asarray(jcor.symbol_phase_streams(_jx(d, dtype), SPS),
                      np.float32)
    got = tcor.symbol_phase_streams(_to(d, dtype), SPS)
    assert got.shape == want.shape == (4, SPS, 333)
    atol = 0.02 if dtype == "bf16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


# -- the trigger search's entry point and the kernel's tiling -------------

def _bad_search_call(bad):
    """find_bursts_phases arguments that name one fault each."""
    x = torch.zeros((2, SPS, 400))
    return {
        "float64": ((x.double(), SPS), {}),
        "float16": ((x.half(), SPS), {}),
        "int32": ((x.int(), SPS), {}),
        "sps_axis": ((x, 2), {}),
        "sps_zero": ((x[..., :0, :], 0), {}),
        "one_axis": ((x[0, 0], 1), {}),
        "short_row": ((x[..., :73], SPS), {}),
        "no_bursts": ((x, SPS), {"max_bursts": 0}),
        "small_block": ((x, SPS), {"corr_block": 72}),
        "meta_device": ((x.to("meta"), SPS), {}),
    }[bad]


@pytest.mark.parametrize("bad", ["float64", "float16", "int32", "sps_axis",
                                 "sps_zero", "one_axis", "short_row",
                                 "no_bursts", "small_block", "meta_device"])
def test_find_bursts_phases_rejects_before_dispatch(bad, monkeypatch):
    """Each bad argument raises ValueError before the plain version (or
    the kernel) is reached."""
    def reached(*a, **k):
        raise AssertionError("dispatched")

    monkeypatch.setattr(tcor, "find_bursts_phases_reference", reached)
    args, kw = _bad_search_call(bad)
    with pytest.raises(ValueError):
        tcor.find_bursts_phases(*args, **kw)


@pytest.mark.parametrize("dtype,out_bf16,max_bursts,corr_block,shape", [
    ("f32", False, 1, 128, (6, SPS, 5200)),
    ("bf16", True, 2, 128, (6, SPS, 5200)),
    ("bf16", False, 4, 256, (2, 3, 1, 900)),
    ("f32", True, 3, 100, (3, SPS, 140)),
])
def test_find_bursts_phases_on_cpu_is_the_plain_version(
        dtype, out_bf16, max_bursts, corr_block, shape):
    """A CPU tensor computes the plain version exactly, and launches no
    kernel."""
    from amps_tpu_torch.kernels import trigger_search as KS
    rng = np.random.default_rng(sum(shape))
    ph = _phases() if shape == (6, SPS, 5200) else \
        rng.normal(0, 0.6, shape).astype(np.float32)
    x = _to(ph, dtype)
    before = KS.LAUNCHES
    got = tcor.find_bursts_phases(x, shape[-2], max_bursts, 0.55,
                                  corr_block, out_bf16)
    want = tcor.find_bursts_phases_reference(x, shape[-2], max_bursts, 0.55,
                                             corr_block, out_bf16)
    assert KS.LAUNCHES == before
    assert [t.dtype for t in got] == [torch.int32, torch.bool,
                                     torch.float32]
    assert got[0].shape == shape[:-2] + (max_bursts,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    q = tcor.trigger_quality_reference(x, corr_block, out_bf16)
    assert q.shape == shape[:-1] + (shape[-1] - 73,)
    assert q.dtype == (torch.bfloat16 if out_bf16 else torch.float32)
    assert torch.equal(got[2][..., 0], q.flatten(-2).amax(-1).float())
