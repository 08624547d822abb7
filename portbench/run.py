"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``portbench/configs/<name>.json``) and traffic mix
(``portbench/traffic/<name>.json``, whose ``kind`` names the module
``portbench/drive/<kind>.py``); the limits of the numbers compared are
``portbench/limits/<cell>.json`` and each per-layer metric is read by
``portbench/metrics/<metric>.py``.  Adding a cell, a mix or a metric
adds files and entries; no file here changes.

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a few profiled sub-windows of the window, with
the device's busy time and the breakdown.  Every run checks its outputs
against the plain reference once the window has closed and prints each
number compared beside its limit, as the last lines of standard error
and under ``checks``, the last key of the result line, which is the
last line of standard output.  The run exits non-zero with no result
line without a CUDA device (or with fewer than the cell asks for),
without the port, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "amps_tpu")


class Refusal(Exception):
    """A run that cannot be made; its reason goes to standard error."""


def _json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell's entries and files, found by name from BENCHMARK.json."""
    bench_path = root / "BENCHMARK.json"
    if not bench_path.exists():
        raise Refusal(f"no BENCHMARK.json under {root}")
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refusal(f"no workload {name!r}; there are {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    mix = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    return dict(bench=bench, cell=cell, cfg=_json(root / conf["file"]),
                mix=mix, limits=_json(HERE / "limits" / f"{name}.json"))


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries a run of ``cell`` reports."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key]
            if cell in m.get("workloads", [cell])]


def read_metric(name: str, tr):
    """A per-layer metric's value from the trace by its reader,
    ``metrics/<name>.py``'s ``read``; None when it finds nothing."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(tr)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_kernels(M: int) -> None:
    """The port's kernel libraries for width M, into its build
    directory in the checkout (built once; later runs load them): the
    main library, and a library of width M where the FFT tile takes M
    and the main library does not hold it (the device-memory route runs
    from the main library)."""
    from amps_tpu_torch.kernels import analysis, build
    own = M not in analysis.LIBRARY_WIDTHS and not analysis.route_length(M)
    build.build(widths=(M,) if own else ())


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def execute(found: dict, seed: int, seconds: float, traced: bool, device,
            t_start: float, units: int = 0, control: bool = False) -> dict:
    """Run the cell on ``device`` and return the result line's object.
    ``units`` fixes the window's pushes or calls instead of its length
    (tests); ``control`` adds the control's readings of the numbers
    compared under ``"control"`` (``portbench.control``)."""
    import torch
    from portbench import trace
    bench, cell, cfg, mix = (found[k] for k in ("bench", "cell", "cfg",
                                                "mix"))
    drive = importlib.import_module(f"portbench.drive.{mix['kind']}")
    out = drive.run(cfg, mix, seed, seconds, device, traced, t_start,
                    units, control)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], traced):
        # an end-to-end metric "<quantity>.<variant>" reports the
        # quantity; the variant only gives it a bound of its own
        v = (read_metric(m["name"], out["trace"]) if traced
             else out["metrics"].get(m["name"].split(".")[0]))
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": found["limits"][k]}
              for k, v in out["numbers"].items()}
    correct = (out["attempted"] > 0 and
               all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    res = {"correct": correct, "attempted": out["attempted"],
           "failed": out["failed"], "metrics": metrics, "device": dev}
    if traced:
        tr = out["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        res["breakdown"] = trace.breakdown(tr)
        res["trace_tries"] = tr.tries
    res["units"] = out["units"]
    res["info"] = out.get("info", {})
    if control:
        res["control"] = out["control"]
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the caches of a run live at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".portbench_cache" / "triton")
    try:
        found = load_cell(args.workload)
        import torch
        chips = found["cell"]["chips"]
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            raise Refusal(f"{args.workload} needs {chips} CUDA device(s); "
                          f"this machine has {have}")
        t_import = time.perf_counter()
        try:
            build_kernels(found["cfg"]["num_channels"])
        except ImportError as e:
            raise Refusal(f"the port is not importable here: {e}") from e
        print(f"setup: start to torch and the card {t_import - T_START:.3f} "
              f"s, the port's kernels {time.perf_counter() - t_import:.3f} s",
              file=sys.stderr)
        device = torch.device("cuda", 0)
        res = execute(found, args.seed, args.seconds, bool(args.trace),
                      device, T_START)
        bad = forbidden_modules()
        if bad:
            raise Refusal(f"loaded in this process: {', '.join(bad)}")
    except Refusal as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}; units {res['units']}; profiler tries "
          f"{res.get('trace_tries', 0)}", file=sys.stderr)
    for k, v in res["info"].items():
        print(f"not compared, {k} (program, reference): {v!r}",
              file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
