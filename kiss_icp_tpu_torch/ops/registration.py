"""Robust point-to-point ICP (Gauss-Newton + Geman-McClure).

Port of `kiss_icp_tpu/ops/registration.py` (reference Registration.cpp:
52-167). The ICP loop is a `control.while_loop` over its carry, as JAX's
`lax.while_loop`: run live, one scalar read per iteration (the convergence
test); under `torch.export`, a `torch.while_loop`. Each iteration runs an
NN query (the fused NN kernel, kernels/nn27.py, in most modes; see
`align_points_to_map`) and the normal-equation kernel (kernels/linsys.py)
on CUDA tensors, or their plain versions on CPU tensors.

Recentering for float32, as in the JAX package: the linear system is built
with lever arms about the current sensor position `c` (source - c), and the
increment exp(dx) is conjugated back as T(c) @ exp(dx) @ T(-c). Identical
fixed point in exact arithmetic, well conditioned in f32 at kilometer scale.

Geman-McClure weight, exactly as the reference (Registration.cpp:95-98):
    w(r2) = kernel_scale^2 / (kernel_scale + r2)^2.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch.profiler import record_function

from kiss_icp_tpu_torch.ops import compact_map, control, hash_map, se3


class LinearSystem(NamedTuple):
    jtj: torch.Tensor  # (6, 6) float32
    jtr: torch.Tensor  # (6,) float32
    num_correspondences: torch.Tensor  # () int32


def build_linear_system(
    source: torch.Tensor,
    targets: torch.Tensor,
    weights_mask: torch.Tensor,
    kernel_scale: torch.Tensor,
    center: torch.Tensor,
) -> LinearSystem:
    """(JTJ, JTr) over one correspondence set, masked and recentered: the
    plain PyTorch version of the normal-equation kernel (kernels/linsys.py).

    Reference BuildLinearSystem (Registration.cpp:80-121) with
    J = [I3 | -hat(source - center)] and residual r = source - target.
    """
    r = source - targets  # (N, 3)
    r2 = torch.sum(r * r, dim=-1)  # (N,)
    k = kernel_scale
    w = (k * k) / torch.square(k + r2)
    w = torch.where(weights_mask, w, torch.zeros_like(w))

    s = source - center[None, :]  # recentered lever arms
    n = source.shape[0]
    eye = torch.eye(3, dtype=source.dtype, device=source.device).expand(n, 3, 3)
    jac = torch.cat([eye, -se3.hat(s)], dim=-1)  # (N, 3, 6)
    wjac = jac * w[:, None, None]
    jtj = torch.einsum("nij,nik->jk", wjac, jac)
    jtr = torch.einsum("nij,ni->j", wjac, r)
    return LinearSystem(jtj, jtr, torch.sum(weights_mask, dtype=torch.int32))


def solve_increment(ls: LinearSystem) -> torch.Tensor:
    """dx = solve(JTJ, -JTr) by Cholesky (the reference uses LDLT).

    Guarded: a relative Tikhonov floor keeps near-singular systems finite in
    f32; a failed factorization (the JAX Cholesky's NaN) or any non-finite
    result becomes a zero step; the step norm is capped at 10; with no
    correspondences the step is zero.
    """
    scale = torch.max(torch.abs(torch.diagonal(ls.jtj)))
    eps = torch.where(scale > 0, scale * 1e-7, torch.ones_like(scale))
    jtj = ls.jtj + eps * torch.eye(6, dtype=ls.jtj.dtype, device=ls.jtj.device)
    chol, info = torch.linalg.cholesky_ex(jtj)
    dx = torch.cholesky_solve(-ls.jtr[:, None], chol)[:, 0]
    zero = torch.zeros_like(dx)
    dx = torch.where((info == 0) & torch.all(torch.isfinite(dx)), dx, zero)
    norm = torch.linalg.norm(dx)
    dx = torch.where(norm > 10.0, dx * (10.0 / norm), dx)
    return torch.where(ls.num_correspondences > 0, dx, zero)


class AlignResult(NamedTuple):
    pose: torch.Tensor  # (4, 4) new world pose of the scan
    num_iterations: torch.Tensor  # () int32 — ICP iterations run
    num_correspondences: torch.Tensor  # () int32 — after the last iteration
    num_dropped_compact: torch.Tensor  # () int32 — live voxels missing from the
    #                                    compact view ("compact*" modes; 0 elsewhere)


def _apply_increment(dx: torch.Tensor, center: torch.Tensor, src: torch.Tensor,
                     t_icp: torch.Tensor):
    """Apply one recentered GN increment: (src, t_icp) moved by exp(dx)
    conjugated back to the world frame, and the step's norm at the WORLD
    origin, which the convergence test reads, like the reference
    (`dx.norm() < criterion`, Registration.cpp:163)."""
    est = se3.se3_exp(dx)
    est[:3, 3] += center - est[:3, :3] @ center
    v, w = dx[:3], dx[3:]
    v_world = v - torch.linalg.cross(w, center, dim=-1)
    step = torch.sqrt(torch.sum(v_world * v_world) + torch.sum(w * w))
    return se3.transform(est, src), est @ t_icp, step


def gauss_newton_loop(
    points: torch.Tensor,
    valid: torch.Tensor,
    initial_guess: torch.Tensor,
    max_distance: torch.Tensor,
    kernel_scale: torch.Tensor,
    *,
    query_fn: Callable,
    linsys_fn: Callable,
    max_iterations: int,
    convergence: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ICP loop (reference Registration.cpp:151-164; JAX
    `registration.gauss_newton_loop`).

    query_fn(src) -> (distances (N,), neighbors (N, 3));
    linsys_fn(src, neighbors, mask, kernel_scale, center) -> LinearSystem.
    Runs until the world-frame increment norm is below `convergence` (the
    iteration that converges still applies its step and is counted) or
    `max_iterations`. Returns (t_icp (4, 4), iterations () int32) with final
    pose = t_icp @ guess.
    """
    guess = initial_guess.to(torch.float32)
    src0 = se3.transform(guess, points)
    center = guess[:3, 3].contiguous()  # the K1 kernel reads it by pointer
    dev = points.device

    def cond(src, t_icp, it, done):
        return (it < max_iterations) & ~done

    def body(src, t_icp, it, done):
        dist, neighbors = query_fn(src)
        corr = torch.isfinite(dist) & valid & (dist < max_distance)
        dx = solve_increment(linsys_fn(src, neighbors, corr, kernel_scale, center))
        src, t_icp, step = _apply_increment(dx, center, src, t_icp)
        return src, t_icp, it + 1, step < convergence

    _, t_icp, it, _ = control.while_loop(cond, body, (
        src0, se3.identity(device=dev), torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev)))
    return t_icp, it


def gauss_newton_loop_cached(
    points: torch.Tensor,
    valid: torch.Tensor,
    initial_guess: torch.Tensor,
    max_distance: torch.Tensor,
    kernel_scale: torch.Tensor,
    *,
    gather_fn: Callable,
    refresh_dist: float,
    max_iterations: int,
    convergence: float,
    linsys_fn: Callable,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ICP loop with cached data association (nn_mode "cached"; JAX
    `registration.gauss_newton_loop_cached`).

    `gather_fn(src) -> (cand (N, C, 3), cand_valid (N, C))` gathers each
    source point's C nearest candidates; the iterations re-select the
    nearest within them and gather again (a `control.cond`) only once a
    valid point has moved more than `refresh_dist` since the last gather.
    Run live, two scalar reads per iteration: the convergence test and the
    refresh test.

    Returns (t_icp (4, 4), iterations () int32, re-gathers () int32).
    """
    guess = initial_guess.to(torch.float32)
    src0 = se3.transform(guess, points)
    center = guess[:3, 3].contiguous()  # the K1 kernel reads it by pointer
    dev = points.device
    rows = torch.arange(points.shape[0], device=dev)
    cand0, cval0 = gather_fn(src0)
    i32 = dict(dtype=torch.int32, device=dev)

    def regather(src, cand, cval, ref_src, n_regather):
        cand, cval = gather_fn(src)
        return cand, cval, control.fresh(src), n_regather + 1

    def keep(src, cand, cval, ref_src, n_regather):
        return tuple(control.fresh(t) for t in (cand, cval, ref_src, n_regather))

    def cond(src, t_icp, it, done, cand, cval, moved, ref_src, n_regather):
        return (it < max_iterations) & ~done

    def body(src, t_icp, it, done, cand, cval, moved, ref_src, n_regather):
        cand, cval, ref_src, n_regather = control.cond(
            moved > refresh_dist, regather, keep, (src, cand, cval, ref_src, n_regather))
        diff = src[:, None, :] - cand
        sq = diff * diff
        d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]  # (N, C)
        d2 = torch.where(cval, d2, torch.full_like(d2, float("inf")))
        best = torch.argmin(d2, dim=-1)
        dist = torch.sqrt(d2[rows, best])
        corr = torch.isfinite(dist) & valid & (dist < max_distance)
        dx = solve_increment(linsys_fn(src, cand[rows, best], corr, kernel_scale, center))
        src, t_icp, step = _apply_increment(dx, center, src, t_icp)
        moved = torch.max(torch.where(valid, torch.linalg.norm(src - ref_src, dim=-1),
                                      torch.zeros_like(dist)))
        return (src, t_icp, it + 1, step < convergence, cand, cval, moved, ref_src,
                n_regather)

    out = control.while_loop(cond, body, (
        src0, se3.identity(device=dev), torch.zeros((), **i32),
        torch.zeros((), dtype=torch.bool, device=dev), cand0, cval0,
        torch.zeros((), dtype=torch.float32, device=dev), src0, torch.zeros((), **i32)))
    return out[1], out[2], out[8]


def align_points_to_map(
    cfg: hash_map.MapConfig,
    m: hash_map.VoxelMap,
    points: torch.Tensor,
    valid: torch.Tensor,
    initial_guess: torch.Tensor,
    max_distance: torch.Tensor,
    kernel_scale: torch.Tensor,
    *,
    max_iterations: int,
    convergence: float,
    nn_mode: str = "gather27",
    nn_live_capacity_log2: int = 15,
    nn_probe_length: int = 8,
    assoc_cache_size: int = 8,
    assoc_refresh_dist: float = 0.25,
) -> AlignResult:
    """Register one body-frame source scan against the local map.

    Mirrors Registration::AlignPointsToMap (Registration.cpp:138-167): an
    empty map returns the guess with 0 iterations (a `control.cond`, so no
    kernel runs on frame 0); otherwise iterate NN
    association + robust GN. The NN query of each `nn_mode`:

      * "gather27", "pallas_fused", "compact", "compact_loop": the fused NN
        kernel on CUDA tensors, its plain version on CPU tensors.
      * "loop27": the same on CUDA tensors; on CPU tensors the 27-offset
        loop (hash_map.query_nearest_loop), which gives the same answers.
      * "compact*" also build the compact view (ops/compact_map.py) once per
        call, for its drop count (`num_dropped_compact`) only: the JAX modes
        query the view, whose answers are the sparse query's, and the card
        gathers the sparse map's rows directly, so the port does not query
        the view.
      * "cached": `gauss_newton_loop_cached` over hash_map.query_topc's
        `assoc_cache_size` candidates, re-gathered past `assoc_refresh_dist`.

    The final correspondence count goes through the mode's own query.
    """
    # The kernels' wrappers import this module for the plain versions.
    from kiss_icp_tpu_torch.kernels import linsys, nn27

    def sparse(src):
        return nn27.query_nearest(cfg, m, src, valid)

    if nn_mode in ("gather27", "pallas_fused", "cached", "compact", "compact_loop"):
        nn = sparse
    elif nn_mode == "loop27":
        def nn(src):
            if src.device.type == "cpu":
                return hash_map.query_nearest_loop(cfg, m, src, valid)
            return sparse(src)
    else:
        raise ValueError(f"unknown nn_mode: {nn_mode!r}")

    def empty(guess):
        # Nothing to register against: the guess, 0 iterations, no launch.
        zero = torch.zeros((), dtype=torch.int32, device=guess.device)
        return control.fresh(guess), zero, zero.clone(), zero.clone()

    def register(guess):
        num_dropped_compact = torch.zeros((), dtype=torch.int32, device=guess.device)
        if nn_mode in ("compact", "compact_loop"):
            ccfg = compact_map.CompactConfig(live_capacity_log2=nn_live_capacity_log2,
                                             hash_capacity_log2=nn_live_capacity_log2 + 2,
                                             probe_length=nn_probe_length)
            with record_function("kiss/compact_view"):
                num_dropped_compact = compact_map.build_compact(cfg, ccfg, m).num_dropped

        if nn_mode == "cached":
            t_icp, iters, _ = gauss_newton_loop_cached(
                points, valid, guess, max_distance, kernel_scale,
                gather_fn=lambda src: hash_map.query_topc(cfg, m, src, assoc_cache_size),
                refresh_dist=float(assoc_refresh_dist), max_iterations=max_iterations,
                convergence=convergence, linsys_fn=linsys.build_linear_system)
        else:
            def query_fn(src):
                q = nn(src)
                return q.distances, q.neighbors

            t_icp, iters = gauss_newton_loop(
                points, valid, guess, max_distance, kernel_scale,
                query_fn=query_fn, linsys_fn=linsys.build_linear_system,
                max_iterations=max_iterations, convergence=convergence)

        pose = t_icp @ guess
        # Final correspondence count for diagnostics (one extra association).
        q = nn(se3.transform(pose, points))
        n_corr = torch.sum(q.found & (q.distances < max_distance), dtype=torch.int32)
        return pose, iters, n_corr, num_dropped_compact

    # JAX runs the loop on an empty map too and selects the guess after it;
    # a branch keeps frame 0 free of kernel launches.
    return AlignResult(*control.cond(hash_map.is_empty(m), empty, register,
                                     (initial_guess.to(torch.float32),)))
