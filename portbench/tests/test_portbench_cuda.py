"""On the card: each cell's command, as the benchmark runs it (a process
of its own, the run's full length), untraced and traced, exits 0 with a
correct result line that reports every metric of the cell."""

import json
import pathlib
import subprocess
import sys

import pytest

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_run_on_the_card(card, cell, traced):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2**31 + 99), "--seconds", str(BENCH["run_seconds"]),
         "--trace", str(traced)], cwd=ROOT, capture_output=True, text=True,
        timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    key = "per_layer" if traced else "end_to_end"
    names = {m["name"] for m in BENCH[key]
             if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == names
    assert list(res)[-1] == "checks"
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
