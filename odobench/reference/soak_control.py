"""The controls of a `kiss_soak` cell: systems the check must reject.

    python3 -m odobench.reference.soak_control --workload <cell> --seconds <s>
        --seeds a,b,... [--controls tf32,ground_off,kiss_tf32]

Each answers the traffic's calls in the program's place, as
`reference/control.py` does:
  * `tf32`: `kiss_soak` (u16 map, ground fit) in float32 with every matrix
    product in TF32, one precision below the configuration's;
  * `ground_off`: `kiss_soak` in float64 with `engine.ground_align` 0, the
    fit left out;
  * `kiss_tf32`: `reference/control.py` itself, plain `kiss.py` in TF32.
Prints one JSON line a run: the compared numbers and every checked frame.
Not a measurement: nothing it prints is a metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from odobench.reference import control, kiss, kiss_soak


class Tf32(control.Control):
    """`kiss_soak` in TF32 in the program's place."""

    def __init__(self, kiss_config: dict, device, rows: int = 1):
        self.soak = self.params_of(kiss_config)
        super().__init__(kiss_config, device, rows)

    def params_of(self, kiss_config: dict) -> kiss_soak.Params:
        return kiss_soak.Params.from_config(kiss_config)

    def math(self) -> kiss.Math:
        return kiss.Math(precision="tf32", device=self.device)

    def new_drive(self) -> None:
        self.odo = [kiss_soak.Odometry(self.soak, self.math()) for _ in range(self.rows)]


class GroundOff(Tf32):
    """`kiss_soak` in float64 without the ground fit in the program's place."""

    def params_of(self, kiss_config: dict) -> kiss_soak.Params:
        return dataclasses.replace(kiss_soak.Params.from_config(kiss_config), ground_align=0.0)

    def math(self) -> kiss.Math:
        return kiss.Math(torch.float64, "full", self.device)


CONTROLS = {"tf32": Tf32, "ground_off": GroundOff, "kiss_tf32": control.Control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default=",".join(CONTROLS))
    args = ap.parse_args(argv)

    from odobench.harness import run_cell

    for name in args.controls.split(","):
        for seed in (int(s) for s in args.seeds.split(",") if s):
            details = {}
            try:
                result = run_cell(args.workload, seed, args.seconds, False, device="cuda:0",
                                  system_factory=CONTROLS[name], details=details,
                                  log=lambda line: print(line, file=sys.stderr))
                out = {"checks": result["checks"], "correct": result["correct"],
                       "attempted": result["attempted"]}
            except Exception as e:  # a control that crashes has failed
                out = {"error": repr(e)}
            print(json.dumps({"workload": args.workload, "seed": seed, "control": name, **out,
                              "checked": details.get("checked", [])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
