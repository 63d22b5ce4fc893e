"""The sequence axis: B independent sequences advanced in lockstep.

Port of `kiss_icp_tpu/parallel/batch.py`. The JAX package lays a ("seq",
"pts") device mesh over its chips and `jax.vmap`s the frame step over the
sequences. Here the grid is one device, 1 x 1: one CUDA card, or the CPU
when asked. A larger grid, or a "pts" extent above 1 (which needs a psum
across devices), raises NotImplementedError until ROADMAP item 16b.

On one card the sequence axis is what fills a device that one sequence
leaves mostly idle: `odometry.register_frame_batched` runs the B rows'
Gauss-Newton loops as one lockstep loop, so every iteration launches the NN
kernel (K2) and the normal-equation kernel (K1) once for all B rows and
reads one scalar on the host, whatever B (see its docstring for the stages
that still run row by row and the modes that run whole rows apart).

The state is the single-sequence `OdometryState` with every leaf stacked on
a leading B axis (`init_batched_state`); `convert.state_to_numpy` /
`state_from_numpy` carry it to and from the JAX package's batched state.
Entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig

SEQ_AXIS = "seq"
PTS_AXIS = "pts"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """The port's device grid: ("seq", "pts") = (1, 1) over one device."""

    device: torch.device

    @property
    def shape(self) -> dict:
        return {SEQ_AXIS: 1, PTS_AXIS: 1}


def make_mesh(n_devices: Optional[int] = None, pts_shards: Optional[int] = None,
              device=None) -> DeviceMesh:
    """A ("seq", "pts") grid: one device (`device`, default CUDA; n_devices
    None means one). More devices, or pts_shards > 1, raise."""
    n_devices = 1 if n_devices is None else int(n_devices)
    pts_shards = 1 if pts_shards is None else int(pts_shards)
    if n_devices != 1 or pts_shards != 1:
        raise NotImplementedError(
            f"a {n_devices}-device grid with pts_shards={pts_shards}: only one device "
            "(1 x 1) is ported; the multi-device seq axis and the pts axis (a psum "
            "across devices) are ROADMAP item 16b")
    return DeviceMesh(odometry.resolve_device(device))


def init_batched_state(config: KISSConfig, batch: int, device=None) -> odometry.OdometryState:
    """Per-sequence odometry states stacked on a leading batch axis."""
    one = odometry.init_state(config, device)

    def stack(x):
        # u16 points expand as their int16 bits (CUDA has few uint16 kernels).
        bits = x.view(torch.int16) if x.dtype == torch.uint16 else x
        return bits.expand((batch,) + x.shape).contiguous().view(x.dtype)

    return torch.utils._pytree.tree_map(stack, one)


def batched_state_sharding(mesh: DeviceMesh) -> torch.device:
    """Where a batched state lives: the grid's one device (JAX: the batch
    axis sharded over "seq")."""
    return mesh.device


def _on(device: torch.device, *arrays):
    """numpy arrays or tensors as tensors on `device`."""
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def make_batched_step(config: KISSConfig, mesh: Optional[DeviceMesh] = None):
    """One lockstep frame-advance of B sequences: `step(state, points
    (B,N,3), timestamps (B,N), valid (B,N)) -> (state, FrameResult)`, inputs
    (numpy or tensors) moved to the grid's device (default: the state's).
    The state is donated when `engine.donate_state` is set."""

    def step(state, points, timestamps, valid):
        dev = mesh.device if mesh is not None else state.pose.device
        return odometry.register_frame_batched(
            config, state, *_on(dev, points, timestamps, valid))

    return step


def make_batched_chunked_step(config: KISSConfig, mesh: Optional[DeviceMesh] = None,
                              seq_mode: str = "vmap"):
    """A (B sequences) x (K frames) advance: `step(state, points (K,B,N,3),
    timestamps (K,B,N), valid (K,B,N)) -> (state, poses (K,B,4,4))`.

    `seq_mode` says how the sequence axis meets the frame loop:
      * "vmap": frame by frame, the B rows in lockstep
        (`odometry.register_frame_batched`); a frame's K1 and K2 launches
        follow its slowest row's iterations.
      * "map": row by row, each row's K frames through `make_chunked_step`
        on views of the stacked state, with its own trip counts: a chunk's
        launches are the sum over rows. Single-device only, as in JAX: with
        a grid it raises.
    A chunk that does not donate (`engine.donate_state` unset) copies the
    stacked map once."""
    if seq_mode not in ("vmap", "map"):
        raise ValueError(f"unknown seq_mode {seq_mode!r}")
    if seq_mode == "map" and mesh is not None:
        raise ValueError(
            "seq_mode='map' is the single-device program; on a mesh use "
            "parallel/pod.py (per-row decoupling with uniform collectives)")
    donate = bool(config.engine.donate_state)
    row_chunk = odometry.make_chunked_step(config, donate=True)

    def chunk(state, points, timestamps, valid):
        dev = mesh.device if mesh is not None else state.pose.device
        points, timestamps, valid = _on(dev, points, timestamps, valid)
        if not donate:
            state = state._replace(map=odometry.copy_map(state.map))
        if seq_mode == "vmap":
            poses = []
            for k in range(points.shape[0]):
                state, res = odometry.register_frame_batched(
                    config, state, points[k], timestamps[k], valid[k], donate=True)
                poses.append(res.pose)
            return state, torch.stack(poses)
        rows, poses = [], []
        for b in range(points.shape[1]):
            row, summary = row_chunk(odometry.state_row(state, b), points[:, b],
                                     timestamps[:, b], valid[:, b])
            rows.append(row)
            poses.append(summary.poses)
        return odometry.store_rows(state, rows), torch.stack(poses, dim=1)

    return chunk


class BatchedOdometry:
    """Host-side wrapper: B sequences in lockstep, numpy in and out like
    `odometry.KissICP`, one batched step advancing all of them a frame.
    It owns its state and always donates it."""

    def __init__(self, config: KISSConfig, batch: int, mesh: Optional[DeviceMesh] = None,
                 device=None):
        self.config = config
        self.batch = batch
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.state = init_batched_state(config, batch, self.mesh.device)
        self._cap = int(config.engine.max_points_per_frame)
        self.last_input_dropped = 0
        self.total_input_dropped = 0
        self.last_result: Optional[odometry.FrameResult] = None

    def register_frames(self, frames, timestamps=None) -> np.ndarray:
        """frames: list of B (N_i, 3) scans. Returns (B, 4, 4) float32 poses.

        Oversized scans are stride-subsampled with drop accounting
        (odometry.subsample_to_capacity: head truncation would angularly
        bias an azimuth-ordered scan)."""
        assert len(frames) == self.batch
        pts = np.zeros((self.batch, self._cap, 3), np.float32)
        ts = np.zeros((self.batch, self._cap), np.float32)
        valid = np.zeros((self.batch, self._cap), bool)
        self.last_input_dropped = 0
        for i, f in enumerate(frames):
            t = None if timestamps is None else timestamps[i]
            f, t, dropped = odometry.subsample_to_capacity(f, t, self._cap)
            self.last_input_dropped += dropped
            n = len(f)
            pts[i, :n] = f[:, :3]
            valid[i, :n] = True
            if t is not None and len(t) == n:
                ts[i, :n] = np.asarray(t)
        self.total_input_dropped += self.last_input_dropped
        self.state, self.last_result = odometry.register_frame_batched(
            self.config, self.state, *_on(self.mesh.device, pts, ts, valid), donate=True)
        return self.last_result.pose.cpu().numpy()

    @property
    def poses(self) -> np.ndarray:
        return self.state.pose.cpu().numpy()
