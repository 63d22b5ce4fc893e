"""Multi-process execution: the batched odometry spread over processes.

Port of `kiss_icp_tpu/parallel/multihost.py`. JAX joins the processes into
one runtime (`jax.distributed.initialize`) whose devices form the ("seq",
"pts") mesh. Here `initialize_from_env` joins them into a
`torch.distributed` process group, one device a rank, and the grid of
parallel/batch.make_mesh lies over the ranks (parallel/grid.py): each rank
advances its own sequences on its own device, and the poses are gathered so
that every rank holds all B of them. Sequences exchange nothing, so nothing
crosses the ranks inside a frame.

Environment contract (the JAX package's variables):

    KISS_COORDINATOR    host:port of process 0 (e.g. "10.0.0.1:8476")
    KISS_NUM_PROCESSES  total process count
    KISS_PROCESS_ID     this process's rank in [0, num_processes)
    KISS_DIST_BACKEND   "gloo" (default: CPU tensors; the host-side pose
                        exchange) or "nccl" (CUDA tensors, one card a rank)
    KISS_LOCAL_RANK     with nccl, the card of this process on its host
                        (default: KISS_PROCESS_ID)
    KISS_DIST_TIMEOUT   seconds a collective may wait (default 300)

With none of these set (or num_processes == 1) there is no process group
and everything runs in this process.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.parallel import batch as pbatch
from kiss_icp_tpu_torch.parallel.grid import DeviceMesh, world


@dataclass(frozen=True)
class MultihostSpec:
    coordinator: Optional[str]
    num_processes: int
    process_id: int

    @property
    def is_multiprocess(self) -> bool:
        return self.num_processes > 1


def spec_from_env(environ=None) -> MultihostSpec:
    """Read the launch topology from the environment (see the module
    docstring)."""
    env = os.environ if environ is None else environ
    return MultihostSpec(
        coordinator=env.get("KISS_COORDINATOR"),
        num_processes=int(env.get("KISS_NUM_PROCESSES", "1")),
        process_id=int(env.get("KISS_PROCESS_ID", "0")),
    )


def initialize_from_env(environ=None) -> MultihostSpec:
    """`torch.distributed.init_process_group` (init method
    tcp://KISS_COORDINATOR) when launched multi-process; no-op else.
    Returns the parsed spec either way.

    The backend is the environment's KISS_DIST_BACKEND, gloo by default.
    NCCL carries CUDA tensors with one card a rank: this process takes card
    KISS_LOCAL_RANK, and a rank without a card of its own raises (NCCL
    refuses two ranks on one card)."""
    env = os.environ if environ is None else environ
    spec = spec_from_env(env)
    if not spec.is_multiprocess:
        return spec
    if not spec.coordinator:
        raise ValueError("KISS_NUM_PROCESSES > 1 requires KISS_COORDINATOR=host:port")
    backend = env.get("KISS_DIST_BACKEND", "gloo")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"KISS_DIST_BACKEND must be gloo or nccl, got {backend!r}")
    if backend == "nccl":
        local = int(env.get("KISS_LOCAL_RANK", spec.process_id))
        n_cards = torch.cuda.device_count()
        if local >= n_cards:
            raise RuntimeError(f"NCCL needs one card a rank: this rank would take card "
                               f"{local} of {n_cards}")
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=f"tcp://{spec.coordinator}", world_size=spec.num_processes,
        rank=spec.process_id,
        timeout=datetime.timedelta(seconds=float(env.get("KISS_DIST_TIMEOUT", "300"))))
    return spec


class MultihostBatchedOdometry:
    """B sequences advancing in lockstep across every rank's device.

    Each rank calls `register_frames` with the scans of its LOCAL sequences
    (global batch B = ranks x local batch) and gets back the global (B, 4,
    4) poses, gathered over the "seq" axis. It owns its state and donates
    it."""

    def __init__(self, config: KISSConfig, global_batch: int,
                 mesh: Optional[DeviceMesh] = None, device=None):
        self.config = config
        self.batch = global_batch
        self.mesh = mesh if mesh is not None else pbatch.make_mesh(device=device)
        self._seq = self.mesh.axis(pbatch.SEQ_AXIS)
        if global_batch % self._seq.ranks:
            raise ValueError(f"global batch {global_batch} does not split over "
                             f"{self._seq.ranks} ranks")
        self.last_input_dropped = 0
        self.total_input_dropped = 0
        self._cap = int(config.engine.max_points_per_frame)
        self._opts = pbatch.lockstep_options(self.mesh)
        self.state = pbatch.init_batched_state(config, self.local_batch, self.mesh.device)
        self.last_result: Optional[odometry.FrameResult] = None

    @property
    def local_batch(self) -> int:
        """Sequences this process must feed (global batch / ranks)."""
        return self.batch // self._seq.ranks

    def register_frames(self, frames, timestamps=None) -> np.ndarray:
        """frames: `local_batch` (N_i, 3) scans of this process's sequences.
        Returns the global (B, 4, 4) float32 poses. Oversized scans are
        stride-subsampled with drop accounting (`total_input_dropped`)."""
        lb = self.local_batch
        assert len(frames) == lb, (len(frames), lb)
        pts = np.empty((lb, self._cap, 3), np.float32)
        ts = np.empty((lb, self._cap), np.float32)
        valid = np.empty((lb, self._cap), bool)
        self.last_input_dropped = sum(
            odometry.pad_scan(f, None if timestamps is None else timestamps[i],
                              pts[i], ts[i], valid[i]) for i, f in enumerate(frames))
        self.total_input_dropped += self.last_input_dropped
        self.state, self.last_result = odometry.register_frame_batched(
            self.config, self.state, *pbatch._on(self.mesh.device, pts, ts, valid),
            donate=True, **self._opts)
        return self._seq.gather_host(self.last_result.pose).numpy()


def launch_info() -> str:
    """One-line description of the active topology (for logs)."""
    n, rank = world()
    return f"process {rank}/{n}, 1 local / {n} global devices"
