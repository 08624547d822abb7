"""Unified CLI of the port -- the operator surface the reference
provides as GRC flowgraphs (grc/ampsbs.grc, grc/recctest.grc).

    python -m amps_tpu_torch bs       [...]   # BS-in-a-box (ampsbs.grc role)
    python -m amps_tpu_torch monitor  [...]   # RECC capture replay (recctest.grc)
    python -m amps_tpu_torch demo             # end-to-end loopback walkthrough

Each subcommand forwards to the corresponding application module; run
with -h for its options.  The port has no benchmark command yet.
"""

from __future__ import annotations

import sys


def main(argv=None, _result: dict | None = None):
    """Dispatch ``argv``; ``_result`` goes on to ``bs`` (see
    ``apps.bs_app.main``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = argv.pop(0) if argv else "help"
    if cmd == "bs":
        from amps_tpu_torch.apps.bs_app import main as m
        return m(argv, _result)
    if cmd == "monitor":
        from amps_tpu_torch.apps.recc_monitor import main as m
        return m(argv)
    if cmd == "demo":
        from amps_tpu_torch.examples.bs_loopback_demo import main as m
        return m()
    if cmd == "bench":
        print("amps_tpu_torch has no benchmark yet (ROADMAP Queue 1 item 1); "
              "python3 chip_smoke.py times the port on a CUDA card",
              file=sys.stderr)
        return 2
    print(__doc__.strip())
    return 0 if cmd in ("help", "-h", "--help") else 2


if __name__ == "__main__":
    raise SystemExit(main())
