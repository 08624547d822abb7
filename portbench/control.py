"""The lower-precision control of a cell's comparison, and the
program's readings beside it, on several seeds in one process.

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Each seed runs the cell as ``portbench.run`` does, for ``--seconds`` at
the cell's own load, and prints one JSON line: the numbers the run
compares, of the program and of the control (the plain reference
computed in the precisions below the configuration's, in the program's
place), and what the run records beside them.  A limit lies between the
program's largest reading and the control's smallest.  The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    found = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    run.build_kernels(found["cfg"]["num_channels"])
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        res = run.execute(found, seed, args.seconds, False, dev,
                          time.perf_counter(), control=True)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {k: c["value"] for k, c in res["checks"].items()},
            "control": res["control"], "info": res["info"],
            "correct": res["correct"], "metrics": res["metrics"]}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
