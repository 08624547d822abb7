"""The port's native host runtime (``amps_tpu_torch.runtime.native_rt``,
built with g++ at first use into ``amps_tpu_torch/build/``): bit-exact
against the NumPy oracle ``amps_tpu.ref`` and, where it loads, the JAX
package's library; a missing compiler or a failed build raises."""

import pathlib

import numpy as np
import pytest

from amps_tpu.ref import bch_ref, frames_ref
from amps_tpu.runtime import native_rt as jnative
from amps_tpu_torch.runtime import native_rt

PKG = pathlib.Path(native_rt.__file__).resolve().parents[1]
REPO = PKG.parent


def _jax_native():
    """The JAX package's bindings when its committed library loads."""
    return jnative if jnative.available() else None


def test_bch_encode_matches_oracle(rng):
    jn = _jax_native()
    for _ in range(20):
        info = rng.integers(0, 2, 28).astype(np.uint8)
        got = native_rt.focc_bch_encode(info)
        assert np.array_equal(got, bch_ref.focc_bch_encode(info))
        info36 = rng.integers(0, 2, 36).astype(np.uint8)
        got36 = native_rt.recc_bch_encode(info36)
        assert np.array_equal(got36, bch_ref.recc_bch_encode(info36))
        if jn is not None:
            assert np.array_equal(got, jn.focc_bch_encode(info))
            assert np.array_equal(got36, jn.recc_bch_encode(info36))


def test_bch_decode_matches_oracle(rng):
    jn = _jax_native()
    # clean, 1-2 errors, and random garbage
    for nerr in (0, 1, 2):
        for _ in range(10):
            info = rng.integers(0, 2, 36).astype(np.uint8)
            rx = bch_ref.recc_bch_encode(info).copy()
            rx[rng.choice(48, size=nerr, replace=False)] ^= 1
            got, ok = native_rt.recc_bch_decode(rx)
            assert ok and np.array_equal(got, info)
    for _ in range(30):
        rx = rng.integers(0, 2, 48).astype(np.uint8)
        got, ok = native_rt.recc_bch_decode(rx)
        want, wok = bch_ref.recc_bch_decode(rx)
        assert ok == wok
        if wok:
            assert np.array_equal(got, want)
        if jn is not None:
            jgot, jok = jn.recc_bch_decode(rx)
            assert ok == jok and np.array_equal(got, jgot)


@pytest.mark.parametrize("fn, n", [(native_rt.focc_bch_encode, 28),
                                   (native_rt.recc_bch_encode, 36),
                                   (native_rt.recc_bch_decode, 48)])
def test_bch_wrong_length_raises(fn, n):
    """The C side reads a fixed number of bits: a short or long word is
    refused before any pointer is passed."""
    for size in (n - 1, n + 1):
        with pytest.raises(ValueError, match=f"expected {n} bits"):
            fn(np.zeros(size, np.uint8))


def test_manchester_roundtrip(rng):
    bits = rng.integers(0, 2, 200).astype(np.uint8)
    syms = native_rt.manchester_encode(bits, 3)
    assert np.array_equal(syms, frames_ref.manchester_symbols(bits, 3))
    hard = (syms[::3] > 0).astype(np.uint8)  # one sample per half-symbol
    out, bad = native_rt.manchester_decode(hard)
    assert bad == 0
    assert np.array_equal(out, bits)
    jn = _jax_native()
    if jn is not None:
        assert np.array_equal(syms, jn.manchester_encode(bits, 3))


def test_trigger_scan():
    trig = frames_ref.manchester_symbols(frames_ref.RECC_TRIGGER_BITS)
    trig01 = (trig > 0).astype(np.uint8)
    hay = np.concatenate([np.tile([1, 0], 100).astype(np.uint8), trig01,
                          np.tile([0, 1], 50).astype(np.uint8)])
    off = native_rt.trigger_scan(hay, trig01)
    # memmem semantics: the first match; the dotting prefix overlaps the
    # trigger's own leading dotting, so the match lands before 200
    assert off >= 0
    assert np.array_equal(hay[off:off + len(trig01)], trig01)
    assert native_rt.trigger_scan(np.zeros(50, np.uint8), trig01) == -1
    jn = _jax_native()
    if jn is not None:
        assert off == jn.trigger_scan(hay, trig01)


def test_ring_buffer():
    r = native_rt.Ring(1 << 10)
    assert r.readable == 0
    assert r.write(b"hello world") == 11
    assert r.readable == 11
    assert r.read(5) == b"hello"
    assert r.read(100) == b" world"
    # wraparound
    blob = bytes(range(256)) * 3
    for _ in range(10):
        r.write(blob)
        got = r.read(len(blob))
        assert got == blob[:len(got)]
    # overflow: writes cap at capacity
    assert r.write(bytes(2048)) == 1024
    assert r.writable == 0
    # a buffer is read in place: a memoryview of a float32 array
    r.read(1024)
    x = np.arange(8, dtype=np.float32)
    assert r.write(memoryview(x).cast("B")[8:]) == 24
    assert np.array_equal(np.frombuffer(r.read(24), np.float32), x[2:])
    with pytest.raises(ValueError, match="power of two"):
        native_rt.Ring(1000)


def test_library_builds_under_the_port():
    """The library lands in amps_tpu_torch/build/, named by a hash of the
    source and the flags; nothing is written under amps_tpu/."""
    path = native_rt.build()
    assert path.parent == PKG / "build"
    assert path.name.startswith("libampsrt_") and path.exists()
    assert path == native_rt.library_path()
    jax_dir = REPO / "amps_tpu" / "runtime" / "native"
    assert sorted(p.name for p in jax_dir.iterdir()) == \
        ["ampsrt.cc", "build.sh", "libampsrt.so"]


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_rt, "BUILD_DIR", tmp_path)
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_rt, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_rt.build()
    assert not native_rt.library_path().exists()
    monkeypatch.setattr(native_rt.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_rt.build()
