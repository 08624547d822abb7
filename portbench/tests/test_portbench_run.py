"""A run without a card refuses with a reason; a run on the CPU at a
small size (the harness's look for a chip skipped) comes out correct,
and comes out not correct with the timed path broken underneath: a
step that leaves the receiver's state as it was, half of the channels
left out, a decoded word altered where it is made; the control, the
reference in bfloat16 in the program's place, fails the cell's limits."""

import json
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import run
from small import M, small

ROOT = pathlib.Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
PUSHES = 20
SEED = 2**31 + 12345


def command(cwd, *args):
    return subprocess.run([sys.executable, "-m", "portbench.run",
                           "--workload", "band1024.duplex", "--seed", "1",
                           "--seconds", "1", "--trace", "0", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = command(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_refuses_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "portbench:" in out.stderr


def small_run(seed=SEED):
    return run.execute(small(), seed, 0, False, CPU, time.perf_counter(),
                       units=PUSHES)


def test_clean_run_is_correct():
    res = small_run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    found = small()
    assert set(res["metrics"]) == {m["name"] for m in run.cell_metrics(
        found["bench"], "band1024.rx", False)}
    json.dumps(res)


def stuck_state(monkeypatch):
    from amps_tpu_torch.runtime import streamer
    orig = streamer._rx_stream_block

    def step(x, hist, carry, prev, pw_carry, *a):
        out = orig(x, hist, carry, prev, pw_carry, *a)
        out.update(hist=hist, carry=carry, prev=prev, pw_carry=pw_carry)
        return out

    monkeypatch.setattr(streamer, "_rx_stream_block", step)


def half_the_channels(monkeypatch):
    from amps_tpu_torch.runtime import streamer
    orig = streamer._rx_stream_block

    def step(*a):
        front_end = a[-1]

        def half(*b):
            d, last, pw = front_end(*b)
            d, pw = d.clone(), pw.clone()
            d[M // 2:] = 0
            pw[M // 2:] = 0
            return d, last, pw

        return orig(*a[:-1], half)

    monkeypatch.setattr(streamer, "_rx_stream_block", step)


def altered_word(monkeypatch):
    from amps_tpu_torch.rx import decoder
    orig = decoder.decode_bursts

    def decode(*a, **k):
        dec = orig(*a, **k)
        words = dec.words.clone()
        words[..., 0, 20] ^= 1
        return dec._replace(words=words)

    monkeypatch.setattr(decoder, "decode_bursts", decode)


@pytest.mark.parametrize("fault", [stuck_state, half_the_channels,
                                   altered_word])
def test_broken_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = small_run()
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["band1024.rx", "wide16384.rx"])
def test_control_fails_the_cells_limits(cell):
    f = small(cell)
    res = run.execute(f, 11, 0, False, CPU, time.perf_counter(), units=12,
                      control=True)
    lim = f["limits"]
    assert res["correct"]
    assert any(v > lim[k] for k, v in res["control"].items())
