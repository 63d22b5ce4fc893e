"""The control: the reference in the program's place, one precision down.

The configuration states float32 with TF32 off (the port's default); the
control computes the reference's float32 arithmetic with every matrix
product in TF32 (`kiss.Math(precision="tf32")`) and answers the traffic's
calls with its own trajectory. The comparison that decides `correct` must
reject it (`odobench/tests/test_odobench_control.py`, `odobench/calibrate.py`).
"""

from __future__ import annotations

from typing import List

import numpy as np

from odobench.reference import kiss


class Control:
    """The same calls as `odobench.program.Port`."""

    def __init__(self, kiss_config: dict, device, rows: int = 1):
        self.params = kiss.Params.from_config(kiss_config)
        self.device = device
        self.rows = int(rows)
        self._iters: List[int] = []
        self.new_drive()

    def new_drive(self) -> None:
        self.odo = [kiss.Odometry(self.params, kiss.Math(precision="tf32", device=self.device))
                    for _ in range(self.rows)]

    def _step(self, row: int, points, stamps) -> np.ndarray:
        pose, iters, _ = self.odo[row].step(points, stamps)
        self._iters.append(iters)
        return pose.double().cpu().numpy()

    def chunk(self, scans) -> np.ndarray:
        return np.stack([self._step(0, p, s) for p, s in scans])

    def step_rows(self, scans) -> np.ndarray:
        return np.stack([self._step(b, p, s) for b, (p, s) in enumerate(scans)])

    def forget(self) -> None:
        """Drop the iteration counts recorded so far (the warm-up's)."""
        self._iters = []

    def iterations(self) -> List[int]:
        return list(self._iters)
