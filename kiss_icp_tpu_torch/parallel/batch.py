"""The sequence axis: B independent sequences advanced in lockstep.

Port of `kiss_icp_tpu/parallel/batch.py`. The JAX package lays a ("seq",
"pts") device mesh over its chips and `jax.vmap`s the frame step over the
sequences. Here the grid (parallel/grid.py) is 1 x 1 on one device (one
CUDA card, or the CPU when asked), or lies over the ranks of an initialised
process group, one device a rank (`make_mesh`): "seq" splits the rows, each
rank advancing its own rows on its own device (the inputs and the state a
step takes are that rank's rows); "pts" > 1 sums each row's normal
equations over the axis's blocks of the source points
(parallel/sharded_icp.block_systems, JAX's psum), every rank of the axis
holding the same rows.

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

from typing import Optional

import numpy as np
import torch

from kiss_icp_tpu_torch import odometry, trace
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.parallel.grid import DeviceMesh, GridAxis, process_axes, world

SEQ_AXIS = "seq"
PTS_AXIS = "pts"


def make_mesh(n_devices: Optional[int] = None, pts_shards: Optional[int] = None,
              device=None) -> DeviceMesh:
    """A ("seq", "pts") grid of n_devices / pts_shards x pts_shards devices
    (JAX `make_mesh`), one device a rank of the initialised process group,
    or this process's one device (`device`, default CUDA) when there is
    none. `n_devices` defaults to every rank, `pts_shards` to 1 (sequence
    parallelism needs no collective). More devices than ranks raise a
    ValueError, as JAX's reshape of too few devices does."""
    n_ranks, _ = world()
    n_devices = n_ranks if n_devices is None else int(n_devices)
    pts_shards = 1 if pts_shards is None else int(pts_shards)
    if n_devices != n_ranks:
        raise ValueError(f"a {n_devices}-device grid over {n_ranks} process(es): the port "
                         "lays one device a rank of the process group (initialise "
                         "torch.distributed with that world size)")
    if n_devices % pts_shards:
        raise ValueError(f"{n_devices} devices do not split into pts_shards={pts_shards}")
    dev = odometry.resolve_device(device)
    if n_ranks == 1:
        return DeviceMesh(dev, ((SEQ_AXIS, GridAxis(1)), (PTS_AXIS, GridAxis(1))))
    return DeviceMesh(dev, process_axes((SEQ_AXIS, PTS_AXIS),
                                        (n_devices // pts_shards, pts_shards)))


def lockstep_options(mesh: Optional[DeviceMesh]) -> dict:
    """What the lockstep loop of `odometry.register_frame_batched` takes
    from the grid: with a "pts" axis of P > 1, each row's normal equations
    summed over the P blocks of its source (one batched K1 launch over this
    rank's blocks) and the loop's trip count shared by the axis's ranks."""
    if mesh is None or mesh.shape.get(PTS_AXIS, 1) == 1:
        return {}
    from kiss_icp_tpu_torch.parallel.sharded_icp import block_systems, local_points

    ax = mesh.axis(PTS_AXIS)

    def linsys_fn(src, neighbors, mask, kernel_scale, center, active):
        return block_systems(ax, *(local_points(ax, t, 1) for t in (src, neighbors, mask)),
                             kernel_scale, center, active)

    return {"linsys_fn": linsys_fn, "any_active_fn": ax.any if ax.ranks > 1 else None}


def init_batched_state(config: KISSConfig, batch: int, device=None) -> odometry.OdometryState:
    """Per-sequence odometry states stacked on a leading batch axis."""
    one = odometry.init_state(config, device)

    def stack(x):
        # u16 points expand as their int16 bits (CUDA has few uint16 kernels).
        bits = x.view(torch.int16) if x.dtype == torch.uint16 else x
        return bits.expand((batch,) + x.shape).contiguous().view(x.dtype)

    return torch.utils._pytree.tree_map(stack, one)


def batched_state_sharding(mesh: DeviceMesh) -> torch.device:
    """Where a batched state lives: this rank's device, holding its rows
    (JAX: the batch axis sharded over "seq")."""
    return mesh.device


@trace.spanned("kiss/h2d")
def _on(device: torch.device, *arrays):
    """numpy arrays or tensors as tensors on `device` (span `kiss/h2d`)."""
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def make_batched_step(config: KISSConfig, mesh: Optional[DeviceMesh] = None):
    """One lockstep frame-advance of B sequences: `step(state, points
    (B,N,3), timestamps (B,N), valid (B,N)) -> (state, FrameResult)`, inputs
    (numpy or tensors) moved to the grid's device (default: the state's);
    on a grid over several ranks, B is this rank's rows. The state is
    donated when `engine.donate_state` is set."""
    opts = lockstep_options(mesh)

    def step(state, points, timestamps, valid):
        dev = mesh.device if mesh is not None else state.pose.device
        return odometry.register_frame_batched(
            config, state, *_on(dev, points, timestamps, valid), **opts)

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
    stacked map once, and updates that copy without CUDA graphs."""
    if seq_mode not in ("vmap", "map"):
        raise ValueError(f"unknown seq_mode {seq_mode!r}")
    if seq_mode == "map" and mesh is not None:
        raise ValueError(
            "seq_mode='map' is the single-device program; on a mesh use "
            "parallel/pod.py (per-row decoupling with uniform collectives)")
    donate = bool(config.engine.donate_state)
    row_chunk = odometry.make_chunked_step(config, donate=True, map_graph=donate)
    opts = lockstep_options(mesh)

    def chunk(state, points, timestamps, valid):
        dev = mesh.device if mesh is not None else state.pose.device
        points, timestamps, valid = _on(dev, points, timestamps, valid)
        if not donate:
            state = state._replace(map=odometry.copy_map(state.map))
        if seq_mode == "vmap":
            poses = []
            for k in range(points.shape[0]):
                state, res = odometry.register_frame_batched(
                    config, state, points[k], timestamps[k], valid[k], donate=True,
                    map_graph=donate, **opts)
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
        self._opts = lockstep_options(self.mesh)
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
        with trace.span("kiss/pack"):
            pts = np.empty((self.batch, self._cap, 3), np.float32)
            ts = np.empty((self.batch, self._cap), np.float32)
            valid = np.empty((self.batch, self._cap), bool)
            self.last_input_dropped = sum(
                odometry.pad_scan(f, None if timestamps is None else timestamps[i],
                                  pts[i], ts[i], valid[i]) for i, f in enumerate(frames))
        self.total_input_dropped += self.last_input_dropped
        self.state, self.last_result = odometry.register_frame_batched(
            self.config, self.state, *_on(self.mesh.device, pts, ts, valid), donate=True,
            **self._opts)
        return trace.read("poses", self.last_result.pose.cpu).numpy()

    @property
    def poses(self) -> np.ndarray:
        return trace.read("poses", self.state.pose.cpu).numpy()
