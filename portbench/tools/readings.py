"""The readings that the limits of ``correct`` were set from: a cell's
checks over many seeds in one process (set-up paid once for CUDA and the
kernel build); with ``--control`` the same with the control in the
program's place, and with ``--fault <name>`` with that fault of faults.py
planted underneath. Not run by the benchmark's own runs.

    python3 portbench/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 [--control | --fault half_batch_left_out]

Prints one JSON line a seed: the checks and, for the program, the
end-to-end metrics of that short window."""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0] = str(ROOT)

from portbench import run, spec  # noqa: E402
from portbench.control import control_fault  # noqa: E402
from portbench.faults import FAULTS, wrap_collect  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args()
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        fault = (control_fault(cell, seed, "cuda") if args.control
                 else wrap_collect(FAULTS[args.fault]) if args.fault else None)
        r = run.run_cell(cell, seed, args.seconds, False, "cuda", fault=fault)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "correct": r["correct"],
                          "checks": {k: c["value"] for k, c in r["checks"].items()},
                          "metrics": {k: m["value"] for k, m in r["metrics"].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
