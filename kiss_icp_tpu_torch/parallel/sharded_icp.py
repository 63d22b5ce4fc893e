"""Intra-frame sharded ICP: one sequence, its points split over a "pts" axis.

Port of `kiss_icp_tpu/parallel/sharded_icp.py`. JAX shards the source
points over the devices of a "pts" mesh axis (contiguous blocks of N/P
points), runs the NN association and the Geman-McClure (JTJ, JTr)
contraction per device against a replicated map, and sums the 6x6+6+1
partials with `psum` (the reference's tbb::parallel_reduce,
Registration.cpp:101-118); the solve and the pose update run replicated.

Here the axis is R ranks x L local blocks (parallel/grid.py). Each process
queries its blocks' points against the whole map with one K2 launch
(kernels/nn27.py: the map is the same for every block), builds the L
blocks' partial systems with one batched K1 launch (one block a row), and
the partials of all P blocks are summed in block order (`block_systems`).
The map is whole on every rank.
"""

from __future__ import annotations

import torch

from kiss_icp_tpu_torch.ops import hash_map, registration, se3
from kiss_icp_tpu_torch.parallel.grid import DeviceMesh, GridAxis

PTS_AXIS = "pts"


def local_points(axis: GridAxis, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This process's contiguous blocks (offset .. offset + L of the P) of
    the N points along `dim` of `t`. N must divide by P."""
    n = t.shape[dim]
    if n % axis.extent:
        raise ValueError(f"{n} points do not split into {axis.extent} blocks of the pts axis")
    nb = n // axis.extent
    return t.narrow(dim, axis.offset * nb, axis.local * nb)


def block_systems(axis: GridAxis, source, targets, mask, kernel_scale, center, active
                  ) -> registration.LinearSystem:
    """B normal-equation systems, each summed over `axis`'s P contiguous
    blocks of the points (JAX's "pts" shards): source, targets (B,M,3),
    mask (B,M) this process's L blocks (`local_points`; the whole N when
    R = 1), kernel_scale (B,), center (B,3), active (B,). One batched K1
    launch with a row per (row, local block), then the sum over the P
    blocks in block order."""
    from kiss_icp_tpu_torch.kernels import linsys

    b, m = source.shape[0], source.shape[1]
    l = axis.local
    nb = m // l

    def blocks(t):  # (B, L*nb, ...) -> (B*L, nb, ...)
        return t.reshape(b * l, nb, *t.shape[2:]).contiguous()

    def each(t):  # (B, ...) -> (B*L, ...)
        return t.repeat_interleave(l, dim=0).contiguous()

    ls = linsys.build_linear_systems(blocks(source), blocks(targets), blocks(mask),
                                     each(kernel_scale), each(center), each(active))

    def total(x):  # (B*L, ...) -> (L, B, ...) -> summed over the P blocks
        return axis.total(x.reshape(b, l, *x.shape[1:]).transpose(0, 1))

    return registration.LinearSystem(total(ls.jtj), total(ls.jtr),
                                     total(ls.num_correspondences))


def make_sharded_align(
    cfg: hash_map.MapConfig,
    mesh: DeviceMesh,
    *,
    max_iterations: int,
    convergence: float,
    axis: str = PTS_AXIS,
):
    """`align(map, points (N,3), valid (N,), guess, max_dist, sigma) ->
    AlignResult` with the point axis split over `mesh`'s `axis` (JAX
    `make_sharded_align`). N must divide by the axis extent P. Every rank
    passes the whole (N, 3) source and the whole map; each works on its
    blocks. The final correspondence count is summed over the blocks."""
    from kiss_icp_tpu_torch.kernels import nn27

    ax = mesh.axis(axis)

    def align(m: hash_map.VoxelMap, points, valid, guess, max_distance, kernel_scale
              ) -> registration.AlignResult:
        pts = local_points(ax, points).contiguous()
        vld = local_points(ax, valid).contiguous()
        guess = guess.to(torch.float32)
        one = torch.ones(1, dtype=torch.bool, device=pts.device)

        def query_fn(src):
            q = nn27.query_nearest(cfg, m, src, vld)
            return q.distances, q.neighbors

        def linsys_fn(src, neighbors, corr, ks, center):
            ls = block_systems(ax, src[None], neighbors[None], corr[None], ks[None],
                               center[None], one)
            return registration.LinearSystem(ls.jtj[0], ls.jtr[0], ls.num_correspondences[0])

        empty = hash_map.is_empty(m)
        if bool(empty):
            zero = torch.zeros((), dtype=torch.int32, device=pts.device)
            return registration.AlignResult(guess, zero, zero.clone(), zero.clone())
        t_icp, iters = registration.gauss_newton_loop(
            pts, vld, guess, max_distance, kernel_scale, query_fn=query_fn,
            linsys_fn=linsys_fn, max_iterations=max_iterations, convergence=convergence,
            any_active_fn=ax.any if ax.ranks > 1 else None)
        pose = t_icp @ guess
        q = nn27.query_nearest(cfg, m, se3.transform(pose, pts), vld)
        n_corr = ax.total(torch.sum(q.found & (q.distances < max_distance),
                                    dtype=torch.int32)[None])
        return registration.AlignResult(pose, iters, n_corr,
                                        torch.zeros((), dtype=torch.int32, device=pts.device))

    return align
