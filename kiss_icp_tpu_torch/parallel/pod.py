"""The pod program: B sequences x map sharding on one ("seq", "map") grid.

Port of `kiss_icp_tpu/parallel/pod.py`. Sequence b's voxel map is split
into D shards as in parallel/sharded_map.py; the B sequences' states are
stacked on a leading axis (`PodState`: ShardedMapState with a leading B).

Execution on one card (or the CPU in one process): the sequences advance
one after another, each over its K frames with the map-sharded frame step,
as JAX's `lax.map` runs a mesh row's local sequences. Each sequence keeps its
own Gauss-Newton trip counts (JAX's lax.map layout; the lockstep layout
would give the same per-sequence results with the slowest sequence's trip
count). Per GN iteration a sequence launches the batched K2 once over its
D shard rows and the batched K1 once over its D stripes.

Across processes (a process group of R ranks, parallel/grid.py), the ranks
split the "seq" axis, as the JAX docstring lays "seq" over the slow links:
each rank advances its B / R sequences with all their shards, and the
sequences exchange nothing, so no collective runs inside a frame; the
wrapper gathers the poses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.ops import threshold
from kiss_icp_tpu_torch.parallel import sharded_map
from kiss_icp_tpu_torch.parallel.batch import _on
from kiss_icp_tpu_torch.parallel.grid import DeviceMesh, GridAxis, process_axes, world
from kiss_icp_tpu_torch.parallel.sharded_map import MAP_AXIS, ShardedMapState, ShardFrameResult

SEQ_AXIS = "seq"


def make_pod_mesh(n_seq: int, n_map: int, device=None) -> DeviceMesh:
    """A ("seq", "map") grid of n_seq x n_map. Under a process group of R
    ranks, the ranks split "seq" (R must divide n_seq) and every map shard
    of a sequence sits in its rank's process; alone, one process holds the
    whole grid on `device` (default CUDA)."""
    n_ranks, _ = world()
    if n_seq % n_ranks:
        raise ValueError(f"a seq axis of {n_seq} does not split over {n_ranks} processes")
    axes = (process_axes((SEQ_AXIS, MAP_AXIS), (n_ranks, 1), (n_seq // n_ranks, n_map))
            if n_ranks > 1 else ((SEQ_AXIS, GridAxis(n_seq)), (MAP_AXIS, GridAxis(n_map))))
    return DeviceMesh(odometry.resolve_device(device), axes)


class PodState(NamedTuple):
    """B sequences' odometry state on the ("seq", "map") grid: every leaf
    of sharded_map.ShardedMapState with a leading axis of this process's
    sequences (all B in one process)."""

    pose: torch.Tensor  # (B, 4, 4)
    delta: torch.Tensor  # (B, 4, 4)
    threshold: threshold.ThresholdState  # leaves (B, ...)
    vkeys: torch.Tensor  # (B, C, 3)
    fprints: torch.Tensor  # (B, C)
    counts: torch.Tensor  # (B, C)
    points: torch.Tensor  # (B, C, P, 3)
    total_points: torch.Tensor  # (B, D)
    num_dropped_voxels: torch.Tensor  # (B, D)
    num_oob_points: torch.Tensor  # (B, D)


# PodState is ShardedMapState with a leading sequence axis on every leaf:
# the per-sequence view and its inverse are positional, so a field added to
# one class and not the other fails here, at import.
if PodState._fields != ShardedMapState._fields:  # pragma: no cover
    raise ImportError(
        "PodState and ShardedMapState field lists diverged: "
        f"{PodState._fields} vs {ShardedMapState._fields}; the positional "
        "views in _per_seq_state/_store_seqs require exact parity")


def _map_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The grid's "map" axis alone: what a sequence's frame step runs on."""
    return DeviceMesh(mesh.device, ((MAP_AXIS, mesh.axis(MAP_AXIS)),))


def init_pod_state(config: KISSConfig, mesh: DeviceMesh, batch: int) -> PodState:
    """Fresh state of this process's share of `batch` sequences."""
    seq = mesh.axis(SEQ_AXIS)
    if batch % seq.extent:
        raise ValueError(f"batch {batch} must divide over the seq axis {seq.extent}")
    local = batch // seq.ranks
    one = sharded_map.init_sharded_state(config, _map_mesh(mesh))

    def stack(x):
        bits = x.view(torch.int16) if x.dtype == torch.uint16 else x
        return bits.expand((local,) + x.shape).contiguous().view(x.dtype)

    return PodState(*torch.utils._pytree.tree_map(stack, tuple(one)))


def _per_seq_state(state: PodState, b: int) -> ShardedMapState:
    """Sequence b's leaves as the single-sequence state frame_step_shard
    takes: views, so that the step's in-place table writes land in the
    stacked tables."""
    return ShardedMapState(*torch.utils._pytree.tree_map(lambda x: x[b], tuple(state)))


def _store_seqs(state: PodState, seqs) -> PodState:
    """The stacked state after each sequence's steps: the tables were
    written in place through the views; the small leaves are stacked anew."""
    def stacked(get):
        return torch.stack([get(s) for s in seqs])

    return state._replace(
        pose=stacked(lambda s: s.pose), delta=stacked(lambda s: s.delta),
        threshold=threshold.ThresholdState(*(stacked(lambda s, i=i: s.threshold[i])
                                             for i in range(3))),
        total_points=stacked(lambda s: s.total_points),
        num_dropped_voxels=stacked(lambda s: s.num_dropped_voxels),
        num_oob_points=stacked(lambda s: s.num_oob_points))


def make_pod_chunked_step(config: KISSConfig, mesh: DeviceMesh, donate: Optional[bool] = None):
    """A (B sequences) x (K frames) pod advance: `step(state, points
    (B,K,N,3), timestamps (B,K,N), valid (B,K,N)) -> (state,
    ShardFrameResult with leading (B', K) axes)`, B' this process's
    sequences (all B in one process; under a process group each rank takes
    its rows of the global inputs). Sequence by sequence, each with its own
    trip counts (see the module docstring). A step that does not donate
    (`donate`, default `engine.donate_state`) copies the tables once."""
    mmesh = _map_mesh(mesh)
    mcfg_local = sharded_map.local_map_config(config, mmesh)
    map_axis, seq = mesh.axis(MAP_AXIS), mesh.axis(SEQ_AXIS)
    donate = bool(config.engine.donate_state) if donate is None else donate

    def step(state: PodState, points, timestamps, valid):
        points, timestamps, valid = _on(mesh.device, points, timestamps, valid)
        local = state.pose.shape[0]
        if points.shape[0] != local:  # the global batch: this rank's rows
            lo = seq.index * local
            points, timestamps, valid = (a[lo:lo + local] for a in (points, timestamps, valid))
        if not donate:
            state = state._replace(vkeys=state.vkeys.clone(), fprints=state.fprints.clone(),
                                   counts=state.counts.clone(), points=state.points.clone())
        seqs, results = [], []
        for b in range(local):
            st, frames = _per_seq_state(state, b), []
            for k in range(points.shape[1]):
                st, res = sharded_map.frame_step_shard(
                    config, mcfg_local, map_axis, st, points[b, k], timestamps[b, k],
                    valid[b, k])
                frames.append(res)
            seqs.append(st)
            results.append(sharded_map.stack_results(frames))
        return (_store_seqs(state, seqs),
                ShardFrameResult(*(torch.stack(f) for f in list(zip(*results))[:8])))

    return step


class PodOdometry:
    """Host-side wrapper: B sequences, maps sharded, numpy scans in, (B, K,
    4, 4) poses out (JAX `PodOdometry`). It owns its state and donates it."""

    def __init__(self, config: KISSConfig, batch: int, mesh: Optional[DeviceMesh] = None,
                 n_map: Optional[int] = None, device=None):
        if mesh is None:
            d = n_map if n_map else max(1, int(config.engine.map_shards))
            mesh = make_pod_mesh(world()[0], d, device)
        self.config = config
        self.mesh = mesh
        self.batch = batch
        self._step = make_pod_chunked_step(config, mesh, donate=True)
        self.state = init_pod_state(config, mesh, batch)
        self._cap = int(config.engine.max_points_per_frame)
        self.last_results: Optional[ShardFrameResult] = None
        self.last_input_dropped = 0
        self.total_input_dropped = 0

    def register_chunks(self, frames, timestamps=None) -> np.ndarray:
        """frames: B lists of K (N_i, 3) scans. Returns (B, K, 4, 4).

        Oversized scans are stride-subsampled (the semantics and drop
        accounting of KissICP: head truncation would angularly bias an
        azimuth-ordered scan); losses accumulate in `total_input_dropped`.
        """
        b = len(frames)
        assert b == self.batch, (b, self.batch)
        k = len(frames[0])
        if any(len(seq) != k for seq in frames):
            raise ValueError(
                f"all sequences must supply the same chunk length; got "
                f"{[len(seq) for seq in frames]} (pad short sequences with "
                "empty scans or trim to the shortest)")
        cap = self._cap
        pts = np.empty((b, k, cap, 3), np.float32)
        ts = np.empty((b, k, cap), np.float32)
        valid = np.empty((b, k, cap), bool)
        self.last_input_dropped = sum(
            odometry.pad_scan(frames[i][j], None if timestamps is None else timestamps[i][j],
                              pts[i, j], ts[i, j], valid[i, j])
            for i in range(b) for j in range(k))
        self.total_input_dropped += self.last_input_dropped
        self.state, results = self._step(self.state, pts, ts, valid)
        self.last_results = results
        return self.mesh.axis(SEQ_AXIS).gather_host(results.pose).numpy()

    @property
    def poses(self) -> np.ndarray:
        return self.mesh.axis(SEQ_AXIS).gather_host(self.state.pose).numpy()

