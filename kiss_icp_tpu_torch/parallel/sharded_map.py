"""Map-sharded odometry: the voxel map's slots split over a grid axis.

Port of `kiss_icp_tpu/parallel/sharded_map.py`. Each of D map shards owns
`capacity / D` slots of the local map. A voxel belongs to the shard given by
the LOW log2(D) bits of its mixed spatial hash (`shard_of`); home buckets
inside a shard use the TOP bits (`hash_map.window_row`), so every shard's
table keeps the global load factor and the tables match the JAX package's
slot for slot. The 27 query neighbours of a point scatter across all shards,
so a frame's association is:

  1. every shard answers all queries against its own table: one launch of
     the batched NN kernel (K2, kernels/nn27.query_nearest_batched) with
     the shards as rows;
  2. the per-query (d^2, neighbour, shard) candidates are min-combined as
     JAX's ppermute ring does (`ring_min_combine`: each shard folds in the
     others' candidates in ring order, ties to the lower shard id; a NaN
     d^2 never wins, so a shard keeps its own NaN as on the JAX mesh);
  3. the Gauss-Newton normal equations are built on the 1/D stripe
     `arange(S) % D == shard` of each shard's correspondences (one launch
     of the batched K1 with the D stripes as rows) and summed in shard order
     (JAX's psum).

Deskew, both downsamples, the threshold and the pose update run once, as the
replicated computation of the JAX program; the owned-voxel insert and the
trim run shard by shard (the port has no batched insert).

The grid axis "map" (parallel/grid.py) is R process ranks x L local shard
rows. On one card, or the CPU in one process, all D shards sit side by side
(R = 1): the port then has the sharded engine's semantics (per-shard
capacity, per-shard drops, the combine and the sum) but one device holds
every shard, so sharding saves no device memory there. Across R > 1 ranks,
each process holds its L = D / R shards and the collectives gather over the
axis's process group; the reductions keep their index order, so the tables
and poses are bit-identical whatever the split.

State layout: the JAX global map leaves, `(C, ...)` with shard d owning the
contiguous slots `[d C/D, (d+1) C/D)`, viewed as `(D, C/D, ...)` for the
kernels; per-shard counters are `(D,)`. In a process of an R-rank axis the
leaves are its local block: `(L C/D, ...)` and `(L,)`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.ops import ground, hash_map, registration, se3, threshold, voxel
from kiss_icp_tpu_torch.parallel.batch import _on
from kiss_icp_tpu_torch.parallel.grid import DeviceMesh, GridAxis, process_axes, world

MAP_AXIS = "map"


class ShardedMapState(NamedTuple):
    """Odometry state with the map sharded over the "map" axis: the map
    leaves of this process's shards (all D of them on one device), and
    per-shard counters. Same fields, in the same order, as the JAX
    package's ShardedMapState (its checkpoint leaf order)."""

    pose: torch.Tensor  # (4, 4)
    delta: torch.Tensor  # (4, 4)
    threshold: threshold.ThresholdState
    vkeys: torch.Tensor  # (L C/D, 3)
    fprints: torch.Tensor  # (L C/D,)
    counts: torch.Tensor  # (L C/D,)
    points: torch.Tensor  # (L C/D, P, 3)
    total_points: torch.Tensor  # (L,) int32 per-shard totals
    num_dropped_voxels: torch.Tensor  # (L,) int32 per-shard drop counts
    num_oob_points: torch.Tensor  # (L,) int32 per-shard out-of-envelope points


class ShardFrameResult(NamedTuple):
    """Per-frame scalars of a map-sharded step (the same on every rank),
    and, from a step built `with_points`, the deskewed frame and the ICP
    source (None otherwise)."""

    pose: torch.Tensor  # (4, 4)
    sigma: torch.Tensor  # ()
    num_iterations: torch.Tensor  # () int32
    num_correspondences: torch.Tensor  # () int32 — at convergence
    num_dropped_downsample: torch.Tensor  # () int32
    num_dropped_map_voxels: torch.Tensor  # () int32 — summed over shards
    num_oob_points: torch.Tensor  # () int32 — summed over shards
    used_fallback: torch.Tensor  # () bool
    frame_points: Optional[torch.Tensor] = None  # (N, 3) deskewed + cropped frame
    frame_valid: Optional[torch.Tensor] = None  # (N,)
    source_points: Optional[torch.Tensor] = None  # (S, 3) ICP source (sensor frame)
    source_valid: Optional[torch.Tensor] = None  # (S,)


def _shard_log2(d: int) -> int:
    if d < 1 or d & (d - 1):
        raise ValueError(f"map axis extent must be a power of two, got {d}")
    return d.bit_length() - 1


def map_mesh(n_shards: int, device=None) -> DeviceMesh:
    """A ("map",) grid of `n_shards` shards over the processes of the
    initialised process group (one, when there is none): each process holds
    n_shards / ranks shard rows on `device` (default CUDA)."""
    n_ranks, rank = world()
    n_shards = int(n_shards)
    if n_shards % n_ranks:
        raise ValueError(f"{n_shards} map shards do not split over {n_ranks} processes")
    axes = (process_axes((MAP_AXIS,), (n_ranks,), (n_shards // n_ranks,)) if n_ranks > 1
            else ((MAP_AXIS, GridAxis(n_shards)),))
    return DeviceMesh(odometry.resolve_device(device), axes)


def local_map_config(config: KISSConfig, mesh: DeviceMesh) -> hash_map.MapConfig:
    """Per-shard map config: same semantics, 1/D the slots."""
    mcfg = odometry.map_config(config)
    d_log2 = _shard_log2(mesh.shape[MAP_AXIS])
    if mcfg.capacity_log2 <= d_log2:
        raise ValueError("map capacity must exceed the shard count")
    return dataclasses.replace(mcfg, capacity_log2=mcfg.capacity_log2 - d_log2)


def shard_of(coords: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owning shard of voxel coords (..., 3): low bits of the mixed hash
    (home buckets use the top bits: independent index sets)."""
    return (hash_map._hash_coords(coords) & (n_shards - 1)).to(torch.int32)


def init_sharded_state(config: KISSConfig, mesh: DeviceMesh) -> ShardedMapState:
    """Fresh state of this process's shards, on the grid's device, with the
    map storage `engine.map_storage` asks for."""
    ax = mesh.axis(MAP_AXIS)
    mcfg_local = local_map_config(config, mesh)
    block = dataclasses.replace(
        mcfg_local, capacity_log2=mcfg_local.capacity_log2 + _shard_log2(ax.local))
    m = hash_map.create_map(block, device=mesh.device)
    dev = mesh.device
    zeros = lambda: torch.zeros(ax.local, dtype=torch.int32, device=dev)  # noqa: E731
    return ShardedMapState(
        pose=se3.identity(device=dev),
        delta=se3.identity(device=dev),
        threshold=threshold.init_state(config.adaptive_threshold.initial_threshold,
                                       device=dev),
        vkeys=m.vkeys, fprints=m.fprints, counts=m.counts, points=m.points,
        total_points=zeros(), num_dropped_voxels=zeros(), num_oob_points=zeros(),
    )


def shard_rows(state: ShardedMapState, n_rows: int) -> hash_map.VoxelMap:
    """The (L, C/D, ...) views of the map leaves the kernels take, with the
    (L,) counters."""
    cl = state.fprints.shape[0] // n_rows
    p = state.points.shape[1]
    return hash_map.VoxelMap(state.vkeys.view(n_rows, cl, 3), state.fprints.view(n_rows, cl),
                             state.counts.view(n_rows, cl), state.points.view(n_rows, cl, p, 3),
                             state.total_points, state.num_dropped_voxels,
                             state.num_oob_points)


def ring_min_combine(d2: torch.Tensor, nn: torch.Tensor, rows: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global per-query NN of shards `rows` (L,) from every shard's
    candidates d2 (D, S), nn (D, S, 3): JAX's ppermute ring. Shard g starts
    from its own candidates and folds in those of shard g - h at hop h
    (h = 1 .. D-1); a candidate wins on a smaller d^2, or an equal one from
    a lower shard id. Without NaN every shard ends with the lexicographic
    minimum; a NaN d^2 never wins, so a shard keeps its own NaN, as on the
    JAX mesh. Returns (d2 (L, S), nn (L, S, 3))."""
    d = d2.shape[0]
    rows = rows.to(torch.int64)
    best_d2, best_nn = d2[rows], nn[rows]
    best_sid = rows[:, None].expand_as(best_d2)
    for h in range(1, d):
        src = (rows - h) % d
        recv_d2, recv_sid = d2[src], src[:, None]
        take = (recv_d2 < best_d2) | ((recv_d2 == best_d2) & (recv_sid < best_sid))
        best_d2 = torch.where(take, recv_d2, best_d2)
        best_nn = torch.where(take[..., None], nn[src], best_nn)
        best_sid = torch.where(take, recv_sid, best_sid)
    return best_d2, best_nn


def copy_tables(state: ShardedMapState) -> ShardedMapState:
    """The state with copies of its map tables (what a step that does not
    donate writes into)."""
    return state._replace(vkeys=state.vkeys.clone(), fprints=state.fprints.clone(),
                          counts=state.counts.clone(), points=state.points.clone())


def frame_step_shard(
    config: KISSConfig,
    mcfg_local: hash_map.MapConfig,
    axis: GridAxis,
    state: ShardedMapState,
    points: torch.Tensor,
    timestamps: torch.Tensor,
    valid: torch.Tensor,
    *,
    with_points: bool = False,
) -> Tuple[ShardedMapState, ShardFrameResult]:
    """One odometry frame over this process's shards of the "map" `axis`
    (JAX `frame_step_shard`). Writes the state's map tables IN PLACE (the
    caller copies them to keep its state: `copy_tables`); the returned
    state holds the same tables and new small leaves.

    Per GN iteration: one batched K2 launch with the L local shards as rows
    (the same queries each row), the ring combine over the gathered D rows,
    one batched K1 launch with the L stripes as rows, the sums over D in
    shard order; and per trip of `engine.gn_unroll` iterations the loop's
    one host read (all-reduced over the axis's ranks, so every rank runs
    the same trip count; on one process, each trip on the card is the
    replay of one CUDA graph). An empty map on every shard skips the loop
    and the final count: no launch.
    """
    vsize = float(config.mapping.voxel_size)
    n_shards, n_local = axis.extent, axis.local
    dev = state.pose.device
    from kiss_icp_tpu_torch.kernels import linsys, nn27

    m_rows = shard_rows(state, n_local)
    rows = axis.rows(dev)

    # 1.-2. Deskew + crop + double downsample (the JAX program's replicated part).
    prep, frame_ds = odometry._deskew_downsample(config, points, timestamps, valid,
                                                 state.delta)
    source = odometry._source_cloud(config, frame_ds)

    # 3.-4. Threshold + constant-velocity guess.
    sigma = odometry._sigma_for_frame(config, state)
    initial_guess = state.pose @ state.delta
    max_distance = 3.0 * sigma
    guess = initial_guess.to(torch.float32)
    n_src = source.points.shape[0]
    stripe = (torch.arange(n_src, device=dev) % n_shards)[None, :] == rows[:, None]  # (L, S)
    active = torch.ones(n_local, dtype=torch.bool, device=dev)
    q_valid = source.valid.expand(n_local, n_src).contiguous()
    global_empty = bool(axis.total(state.total_points) == 0)

    # What the loop's query and normal equations read besides their
    # arguments, passed to them by the loop (on the card, a CUDA graph's
    # copies of the operands; the tables where they lie).
    operands = (q_valid, stripe, active, rows, m_rows.vkeys, m_rows.fprints)
    tables = (m_rows.counts, m_rows.points)

    def query_fn(src, q_valid, stripe, active, rows, vkeys, fprints, counts, points):
        shards = m_rows._replace(vkeys=vkeys, fprints=fprints, counts=counts, points=points)
        q = nn27.query_nearest_batched(mcfg_local, shards,
                                       src.expand(n_local, n_src, 3).contiguous(),
                                       q_valid, active)
        d2, nn = ring_min_combine(axis.gather(torch.square(q.distances)),
                                  axis.gather(q.neighbors), rows)
        return torch.sqrt(d2), nn

    def linsys_fn(src, neighbors, corr, kernel_scale, center, q_valid, stripe, active,
                  *maps):
        ls = linsys.build_linear_systems(
            src.expand(n_local, n_src, 3).contiguous(), neighbors, corr & stripe,
            kernel_scale.expand(n_local).contiguous(),
            center.expand(n_local, 3).contiguous(), active)
        return registration.LinearSystem(axis.total(ls.jtj), axis.total(ls.jtr),
                                         axis.total(ls.num_correspondences))

    i32 = dict(dtype=torch.int32, device=dev)
    if global_empty:
        new_pose = guess
        iters = torch.zeros((), **i32)
        pose_finite = torch.ones((), dtype=torch.bool, device=dev)
    else:
        t_icp, iters = registration.gauss_newton_loop(
            source.points, source.valid, guess, max_distance, sigma,
            query_fn=query_fn, linsys_fn=linsys_fn,
            max_iterations=int(config.registration.max_num_iterations),
            convergence=float(config.registration.convergence_criterion),
            any_active_fn=axis.any if axis.ranks > 1 else None,
            unroll=int(config.engine.gn_unroll), operands=operands, tables=tables,
            graph_key=(mcfg_local, axis.extent, axis.ranks, axis.index))
        aligned = t_icp @ guess
        pose_finite = torch.all(torch.isfinite(aligned))
        new_pose = torch.where(pose_finite, aligned, guess)
    new_pose = se3.orthonormalize(new_pose)
    new_pose = ground.maybe_align(config, frame_ds.points, frame_ds.valid, new_pose)

    # Final correspondence count: each shard counts its stripe of the
    # combined answer, summed over the shards.
    if global_empty:
        n_corr = torch.zeros((), **i32)
    else:
        dist_f, _ = query_fn(se3.transform(new_pose, source.points), *operands, *tables)
        corr_f = torch.isfinite(dist_f) & source.valid & (dist_f < max_distance)
        n_corr = axis.total(torch.sum(corr_f & stripe, dim=-1, dtype=torch.int32))

    # 6.-7. Threshold update.
    model_deviation = se3.inverse(initial_guess) @ new_pose
    new_threshold = threshold.update_model_deviation(
        state.threshold, model_deviation,
        max_range=float(config.data.max_range),
        min_motion_th=float(config.adaptive_threshold.min_motion_th),
    )

    # 8. Each shard inserts only the voxels it owns, then trims.
    world_points = se3.transform(new_pose, frame_ds.points)
    owner = shard_of(voxel.point_to_voxel(world_points, vsize), n_shards)
    totals, drops, oobs, ins_drops, ins_oobs = [], [], [], [], []
    for r in range(n_local):
        m = hash_map.VoxelMap(m_rows.vkeys[r], m_rows.fprints[r], m_rows.counts[r],
                              m_rows.points[r], state.total_points[r],
                              state.num_dropped_voxels[r], state.num_oob_points[r])
        new_m, ins = hash_map.insert(mcfg_local, m, world_points,
                                     frame_ds.valid & (owner == rows[r]))
        new_m = hash_map.trim(mcfg_local, new_m, new_pose[:3, 3])
        totals.append(new_m.total_points)
        drops.append(new_m.num_dropped_voxels)
        oobs.append(new_m.num_oob_points)
        ins_drops.append(ins.num_dropped_voxels)
        ins_oobs.append(ins.num_oob_points)
    # Both drop counters in one sum over the shards.
    frame_drops = axis.total(torch.stack([torch.stack(ins_drops), torch.stack(ins_oobs)], 1))

    new_state = ShardedMapState(
        pose=new_pose,
        delta=se3.inverse(state.pose) @ new_pose,
        threshold=new_threshold,
        vkeys=state.vkeys, fprints=state.fprints, counts=state.counts, points=state.points,
        total_points=torch.stack(totals),
        num_dropped_voxels=torch.stack(drops),
        num_oob_points=torch.stack(oobs),
    )
    result = ShardFrameResult(
        pose=new_pose,
        sigma=sigma,
        num_iterations=iters,
        num_correspondences=n_corr,
        num_dropped_downsample=frame_ds.num_dropped + source.num_dropped,
        num_dropped_map_voxels=frame_drops[0],
        num_oob_points=frame_drops[1],
        used_fallback=~pose_finite,
        frame_points=prep.points if with_points else None,
        frame_valid=prep.valid if with_points else None,
        source_points=source.points if with_points else None,
        source_valid=source.valid if with_points else None,
    )
    return new_state, result


def make_map_sharded_step(config: KISSConfig, mesh: DeviceMesh, with_points: bool = False):
    """One odometry step with the map sharded over `mesh`'s "map" axis:
    `step(state, points (N,3), timestamps (N,), valid (N,)) -> (state,
    ShardFrameResult)`, inputs (numpy or tensors) moved to the grid's
    device. Per-frame semantics match `odometry.register_frame` except that
    overflowing voxels drop per shard (each has 1/D of the slots).
    `with_points` also returns the deskewed frame and the ICP source. The
    state is donated when `engine.donate_state` is set; otherwise the step
    writes copies of its tables."""
    mcfg_local = local_map_config(config, mesh)
    axis = mesh.axis(MAP_AXIS)
    donate = bool(config.engine.donate_state)

    def step(state, points, timestamps, valid):
        if not donate:
            state = copy_tables(state)
        return frame_step_shard(config, mcfg_local, axis, state,
                                *_on(mesh.device, points, timestamps, valid),
                                with_points=with_points)

    return step


def stack_results(results) -> ShardFrameResult:
    """K per-frame results as one with a leading (K,) on each scalar field
    (the point fields stay None, as in JAX's chunked program)."""
    return ShardFrameResult(*(torch.stack(f) for f in list(zip(*results))[:8]))


def make_map_sharded_chunked_step(config: KISSConfig, mesh: DeviceMesh,
                                  donate: Optional[bool] = None):
    """K frames of the map-sharded step: `chunk(state, points (K,N,3), ts
    (K,N), valid (K,N)) -> (state, ShardFrameResult with a leading (K,))`.
    A chunk that does not donate (`donate`, default `engine.donate_state`)
    copies the tables once."""
    mcfg_local = local_map_config(config, mesh)
    axis = mesh.axis(MAP_AXIS)
    donate = bool(config.engine.donate_state) if donate is None else donate

    def chunk(state, points, timestamps, valid):
        points, timestamps, valid = _on(mesh.device, points, timestamps, valid)
        if not donate:
            state = copy_tables(state)
        results = []
        for k in range(points.shape[0]):
            state, res = frame_step_shard(config, mcfg_local, axis, state, points[k],
                                          timestamps[k], valid[k])
            results.append(res)
        return state, stack_results(results)

    return chunk


def shard_live_voxels(state: ShardedMapState, n_shards: int) -> torch.Tensor:
    """Live-voxel count of each shard of the tables given: (D,) for the
    whole map (n_shards = D), (L,) for a process's block."""
    return torch.sum((state.counts > 0).view(n_shards, -1), dim=1, dtype=torch.int32)


# The communication model of JAX's map-sharded GN loop: pure arithmetic of
# the config and the shard count, kept with JAX's numbers.

def ring_payload_bytes(config: KISSConfig, n_shards: int) -> int:
    """Bytes each shard sends per GN iteration for the NN ring combine on
    JAX's mesh: three arrays one hop per step for D-1 steps, the squared
    distances (S,) f32, the neighbours (S, 3) f32 and the shard ids (S,)
    i32, 20 bytes per source row per hop (the summed normal equations'
    ~172 B are excluded). In the port the same candidates cross once, in
    one gather over the axis's ranks."""
    s = int(config.engine.source_capacity)
    return (n_shards - 1) * s * (4 + 12 + 4)


def ring_collective_permutes_per_gn_iteration(n_shards: int) -> int:
    """collective-permute ops per GN iteration per device in JAX's program:
    three arrays x (D-1) hops."""
    return 3 * (n_shards - 1)


def expected_collective_permutes(n_shards: int) -> int:
    """collective-permute ops in JAX's lowered single-frame program: 3(D-1)
    in the GN while body + 2(D-1) in the final correspondence count (its
    ring's neighbour payload is dead code there)."""
    return 5 * (n_shards - 1)
