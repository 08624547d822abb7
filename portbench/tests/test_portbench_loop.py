"""The duplex loop's cell on the CPU at a small size (the harness's look
for a chip skipped): correct as it stands; not correct with the loop's
state left as it was, with only its carried demod overlap left as it
was, with half of the channels left out of the synthesis, with a slot
made valid or a word made decodable where the back end decides; the
control, the reference in bfloat16 and float8 in the program's place,
fails the cell's limits."""

import time

import pytest
import torch

from portbench import run
from small import M, small

CPU = torch.device("cpu")
CELLS = ["wide16384.duplex", "band1024.duplex"]


def small_run(cell="band1024.duplex"):
    return run.execute(small(cell), 2**31 + 77, 0, False, CPU,
                       time.perf_counter(), units=2)


@pytest.mark.parametrize("cell", CELLS)
def test_clean_loop_is_correct(cell):
    res = small_run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 2 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in run.cell_metrics(
        small(cell)["bench"], cell, False)}


def stuck_state(monkeypatch):
    from amps_tpu_torch.runtime import streamer
    orig = streamer.closed_loop_block

    def block(Y, st, *a, **k):
        return st, orig(Y, st, *a, **k)[1]

    monkeypatch.setattr(streamer, "closed_loop_block", block)


def stuck_carry(monkeypatch):
    from amps_tpu_torch.runtime import streamer
    orig = streamer.closed_loop_block

    def block(Y, st, *a, **k):
        st2, pl = orig(Y, st, *a, **k)
        return dict(st2, carry=st["carry"].clone()), pl

    monkeypatch.setattr(streamer, "closed_loop_block", block)


def half_the_channels(monkeypatch):
    from amps_tpu_torch.kernels import synth
    orig = synth.synthesize_block

    def half(Y, *a):
        Y = Y.clone()
        Y[:, M // 2:] = 0
        return orig(Y, *a)

    monkeypatch.setattr(synth, "synthesize_block", half)


def altered_answer(monkeypatch):
    from amps_tpu_torch.runtime import streamer
    orig = streamer.closed_loop_block

    def block(*a, **k):
        st, pl = orig(*a, **k)
        valid = pl["valid"].clone()
        valid[0, 0] = True
        return st, dict(pl, valid=valid)

    monkeypatch.setattr(streamer, "closed_loop_block", block)


def altered_word(monkeypatch):
    from amps_tpu_torch.runtime import streamer
    orig = streamer.closed_loop_block

    def block(*a, **k):
        st, pl = orig(*a, **k)
        ok = pl["word_ok"].clone()
        ok[1, 0, 3] = ~ok[1, 0, 3]
        return st, dict(pl, word_ok=ok)

    monkeypatch.setattr(streamer, "closed_loop_block", block)


@pytest.mark.parametrize("fault", [stuck_state, stuck_carry,
                                   half_the_channels, altered_answer,
                                   altered_word])
def test_broken_loop_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not small_run()["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limits(cell):
    f = small(cell)
    res = run.execute(f, 13, 0, False, CPU, time.perf_counter(), units=2,
                      control=True)
    lim = f["limits"]
    assert res["correct"]
    assert any(v > lim[k] for k, v in res["control"].items())
    # the control's picks and words, not only its front end, fail
    assert res["control"]["quality_err"] > lim["quality_err"]
