"""Every configuration, traffic mix, limit file and metric that
BENCHMARK.json names loads by name, and the file keeps to the shape the
harness reads."""

import importlib
import json
import pathlib
import re

import pytest

from portbench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    found = run.load_cell(cell, ROOT)
    drive = importlib.import_module(
        f"portbench.drive.{found['mix']['kind']}")
    assert found["cfg"]["name"] == found["cell"]["config"]
    assert set(found["limits"]) == set(drive.NUMBERS)
    e2e = {m["name"] for m in run.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.cell_metrics(BENCH, cell, True)
    assert found["cell"]["chips"] == 1


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    for w in m.get("workloads", []):
        assert w in CELLS
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        e2e = {x["name"]: x for x in BENCH["end_to_end"]}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads(m):
    from portbench import trace
    # an empty trace has nothing to read: the reader returns None
    assert run.read_metric(m["name"], trace.Trace()) is None


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert c["file"].startswith("portbench/")
    assert cfg["name"] == c["name"] and c["reduced"] == []
    assert cfg["sample_rate_hz"] == cfg["num_channels"] * \
        cfg["channel_spacing_hz"]
    assert cfg["chan_rate"] == 2 * cfg["channel_spacing_hz"]
