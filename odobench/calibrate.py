"""Readings for the limits of `correct`: many seeds in one process.

    python3 -m odobench.calibrate --workload <cell> --seconds <s>
        [--seeds a,b,...] [--control-seeds c,d,...] [--check-frames n]

Runs the cell's timed path once a seed (set-up is paid once: the port's
import, its kernels), then the control (`reference/control.py`: the
reference in TF32 in the program's place) on the control seeds, and prints
one JSON line a run: the compared numbers and every checked frame. Not a
measurement: nothing it prints is a metric.
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--check-frames", type=int, default=None)
    args = ap.parse_args(argv)

    from odobench.harness import run_cell
    from odobench.reference.control import Control

    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), Control) for s in args.control_seeds.split(",") if s]
    for seed, factory in runs:
        details = {}
        try:
            result = run_cell(args.workload, seed, args.seconds, False, device="cuda:0",
                              system_factory=factory, check_frames=args.check_frames,
                              details=details, log=lambda line: print(line, file=sys.stderr))
            out = {"checks": result["checks"], "correct": result["correct"],
                   "attempted": result["attempted"], "metrics": result["metrics"]}
        except Exception as e:  # a control that crashes has failed
            out = {"error": repr(e)}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "system": "control" if factory else "program", **out,
                          "checked": details.get("checked", [])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
