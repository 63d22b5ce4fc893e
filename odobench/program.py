"""The program under test, behind the calls the traffic makes.

The port's host wrappers, called as their users call them: the CLI and the
pipeline's chunked driver (`KissICP.build_chunk` -> `dispatch_chunk` ->
`summary_poses`), and B sequences in lockstep
(`BatchedOdometry.register_frames`). Each call runs
inside a benchmark span, `odobench/<call>`, which the trace readers use.

The JAX package is never imported; the port is imported when a system is
made, not with this module.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.profiler import record_function


class Port:
    """One drive (or B drives in lockstep) through the port's wrappers."""

    def __init__(self, kiss: dict, device, rows: int = 1):
        from kiss_icp_tpu_torch.config.schema import config_from_dict

        self.config = config_from_dict(kiss)
        self.device = torch.device(device)
        self.rows = int(rows)
        self._iters: List[torch.Tensor] = []
        self.new_drive()

    def new_drive(self) -> None:
        """A fresh state: the start of a drive."""
        from kiss_icp_tpu_torch.odometry import KissICP
        from kiss_icp_tpu_torch.parallel.batch import BatchedOdometry

        self.odo = None  # the old state's memory goes back first
        if self.rows == 1:
            self.odo = KissICP(self.config, device=self.device)
        else:
            self.odo = BatchedOdometry(self.config, self.rows, device=self.device)

    def chunk(self, scans) -> np.ndarray:
        """K frames a call, as the pipeline's chunked driver: (K, 4, 4)."""
        with record_function("odobench/build_chunk"):
            packed, dropped = self.odo.build_chunk([s[0] for s in scans], [s[1] for s in scans])
        with record_function("odobench/dispatch_chunk"):
            summary = self.odo.dispatch_chunk(packed, dropped)
        with record_function("odobench/summary_poses"):
            poses = self.odo.summary_poses(summary)
            # The pipeline checks the rolling origin where it has the poses.
            self.odo.maybe_rebase(poses[-1, :3, 3])
        self._iters.append(summary.num_iterations)
        return poses

    def step_rows(self, scans) -> np.ndarray:
        """One frame of each of B sequences: (B, 4, 4)."""
        with record_function("odobench/register_frames"):
            poses = self.odo.register_frames([s[0] for s in scans], [s[1] for s in scans])
        self._iters.append(self.odo.last_result.num_iterations.reshape(-1))
        return poses.astype(np.float64)

    def forget(self) -> None:
        """Drop the iteration counts recorded so far (the warm-up's)."""
        self._iters = []

    def iterations(self) -> List[int]:
        """GN iterations of every frame so far, in call order (a call's B
        rows in row order)."""
        if not self._iters:
            return []
        return [int(i) for i in torch.cat([t.reshape(-1) for t in self._iters]).cpu()]
