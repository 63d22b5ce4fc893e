"""Robust point-to-point ICP (Gauss-Newton + Geman-McClure).

Port of `kiss_icp_tpu/ops/registration.py` (reference Registration.cpp:
52-167). The ICP loop is a `control.while_loop` over its carry, as JAX's
`lax.while_loop`: run live, one scalar read per loop trip (the convergence
test), a trip being `engine.gn_unroll` iterations; under `torch.export`, a
`torch.while_loop`. Each iteration runs an NN query (the fused NN kernel,
kernels/nn27.py, in most modes; see `align_points_to_map`) and the
normal-equation kernel (kernels/linsys.py) on CUDA tensors, or their plain
versions on CPU tensors.

Recentering for float32, as in the JAX package: the linear system is built
with lever arms about the current sensor position `c` (source - c), and the
increment exp(dx) is conjugated back as T(c) @ exp(dx) @ T(-c). Identical
fixed point in exact arithmetic, well conditioned in f32 at kilometer scale.

Geman-McClure weight, exactly as the reference (Registration.cpp:95-98):
    w(r2) = kernel_scale^2 / (kernel_scale + r2)^2.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from kiss_icp_tpu_torch import trace
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


@trace.spanned("kiss/solve")
def solve_increment(ls: LinearSystem) -> torch.Tensor:
    """dx = solve(JTJ, -JTr) by Cholesky (the reference uses LDLT), in the
    span `kiss/solve`.

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
    any_active_fn: Optional[Callable] = None,
    unroll: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ICP loop (reference Registration.cpp:151-164; JAX
    `registration.gauss_newton_loop`).

    query_fn(src) -> (distances (..., N), neighbors (..., N, 3));
    linsys_fn(src, neighbors, mask, kernel_scale, center) -> LinearSystem.
    The map-sharded programs (parallel/) return one answer per local shard
    row, hence the leading axes; their linsys_fn reduces over the rows.
    Runs until the world-frame increment norm is below `convergence` (the
    iteration that converges still applies its step and is counted) or
    `max_iterations`. Returns (t_icp (4, 4), iterations () int32) with final
    pose = t_icp @ guess.

    `unroll` (`engine.gn_unroll`; below 1 reads as 1, as in JAX): the
    iterations run per loop trip, the convergence test (live, the one host
    read) once a trip. An iteration that finds its solve converged or at
    `max_iterations` keeps its carry, so the trajectory and the iteration
    count are those of `unroll` = 1 bit for bit; a trip's frozen iterations
    still run the query and the normal equations (their launches on the
    card), and their results are dropped without a host read. A trip's
    first iteration needs no freeze on one process: at `unroll` 1 the body
    is the loop's plain iteration.

    `any_active_fn(running) -> running anywhere` (JAX's `any_active_fn`):
    when several processes share the loop's collectives, every one must run
    the same number of trips; a process whose own loop is done keeps its
    carry while the others run (the JAX body's freeze), the same `unroll`
    iterations a trip.
    """
    guess = initial_guess.to(torch.float32)
    src0 = se3.transform(guess, points)
    center = guess[:3, 3].contiguous()  # the K1 kernel reads it by pointer
    dev = points.device
    unroll = max(1, int(unroll))

    def running(it, done):
        return (it < max_iterations) & ~done

    def cond(src, t_icp, it, done):
        run = running(it, done)
        return run if any_active_fn is None else any_active_fn(run)

    def iteration(freeze, src, t_icp, it, done):
        dist, neighbors = query_fn(src)
        corr = torch.isfinite(dist) & valid & (dist < max_distance)
        dx = solve_increment(linsys_fn(src, neighbors, corr, kernel_scale, center))
        new_src, new_t, step = _apply_increment(dx, center, src, t_icp)
        if not freeze:
            return new_src, new_t, it + 1, step < convergence
        run = running(it, done)
        return (torch.where(run, new_src, src), torch.where(run, new_t, t_icp),
                it + run.to(torch.int32), done | (run & (step < convergence)))

    def body(*carry):
        # A trip's first iteration runs the solve: the test just read it
        # running (on one process; across processes, it may be another's).
        carry = iteration(any_active_fn is not None, *carry)
        for _ in range(unroll - 1):
            carry = iteration(True, *carry)
        return carry

    _, t_icp, it, _ = control.while_loop(cond, body, (
        src0, se3.identity(device=dev), torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.bool, device=dev)), "gn")
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
            moved > refresh_dist, regather, keep, (src, cand, cval, ref_src, n_regather),
            "regather")
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
        torch.zeros((), dtype=torch.float32, device=dev), src0, torch.zeros((), **i32)), "gn")
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
    gn_unroll: int = 1,
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

    `gn_unroll` goes to `gauss_newton_loop` (every mode but "cached", whose
    loop JAX does not unroll either). The final correspondence count goes
    through the mode's own query.
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
            with trace.span("kiss/compact_view"):
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
                max_iterations=max_iterations, convergence=convergence, unroll=gn_unroll)

        pose = t_icp @ guess
        # Final correspondence count for diagnostics (one extra association).
        q = nn(se3.transform(pose, points))
        n_corr = torch.sum(q.found & (q.distances < max_distance), dtype=torch.int32)
        return pose, iters, n_corr, num_dropped_compact

    # JAX runs the loop on an empty map too and selects the guess after it;
    # a branch keeps frame 0 free of kernel launches.
    return AlignResult(*control.cond(hash_map.is_empty(m), empty, register,
                                     (initial_guess.to(torch.float32),), "map_empty"))


# --- B sequences in lockstep (parallel/batch.py) ----------------------------


@trace.spanned("kiss/solve")
def solve_increments(ls: LinearSystem) -> torch.Tensor:
    """`solve_increment` over B systems at once: JTJ (B,6,6), JTr (B,6),
    count (B,) -> dx (B,6), with the same guards row by row (one batched
    Cholesky factorisation and solve), in the span `kiss/solve`."""
    jtj = ls.jtj
    scale = torch.amax(torch.abs(torch.diagonal(jtj, dim1=-2, dim2=-1)), dim=-1)
    eps = torch.where(scale > 0, scale * 1e-7, torch.ones_like(scale))
    jtj = jtj + eps[:, None, None] * torch.eye(6, dtype=jtj.dtype, device=jtj.device)
    chol, info = torch.linalg.cholesky_ex(jtj)
    dx = torch.cholesky_solve(-ls.jtr[..., None], chol)[..., 0]
    zero = torch.zeros_like(dx)
    ok = (info == 0) & torch.all(torch.isfinite(dx), dim=-1)
    dx = torch.where(ok[:, None], dx, zero)
    norm = torch.linalg.norm(dx, dim=-1, keepdim=True)
    dx = torch.where(norm > 10.0, dx * (10.0 / norm), dx)
    return torch.where((ls.num_correspondences > 0)[:, None], dx, zero)


def transform_rows(poses: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Row b's (4, 4) pose applied to row b's points: (B,4,4), (B,N,3) ->
    (B,N,3), as `se3.transform` does for one row."""
    r = poses[..., :3, :3]
    t = poses[..., :3, 3]
    return points @ r.transpose(-1, -2) + t[:, None, :]


def _apply_increments(dx: torch.Tensor, center: torch.Tensor, src: torch.Tensor,
                      t_icp: torch.Tensor):
    """`_apply_increment` for B rows: dx (B,6), center (B,3), src (B,N,3),
    t_icp (B,4,4) -> (src, t_icp, step (B,))."""
    est = se3.se3_exp(dx)
    est[:, :3, 3] += center - (est[:, :3, :3] @ center[..., None])[..., 0]
    v, w = dx[:, :3], dx[:, 3:]
    v_world = v - torch.linalg.cross(w, center, dim=-1)
    step = torch.sqrt(torch.sum(v_world * v_world, dim=-1) + torch.sum(w * w, dim=-1))
    return transform_rows(est, src), est @ t_icp, step


def gauss_newton_loop_lockstep(
    points: torch.Tensor,
    valid: torch.Tensor,
    initial_guess: torch.Tensor,
    max_distance: torch.Tensor,
    kernel_scale: torch.Tensor,
    active: torch.Tensor,
    *,
    query_fn: Callable,
    linsys_fn: Callable,
    max_iterations: int,
    convergence: float,
    any_active_fn: Optional[Callable] = None,
    unroll: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`gauss_newton_loop` for B rows in lockstep (JAX: the loop under
    `jax.vmap`): points (B,N,3), valid (B,N), initial_guess (B,4,4),
    max_distance and kernel_scale (B,), active (B,) bool (a row that starts
    inactive does no iteration).

    query_fn(src, active) -> (distances (B,N), neighbors (B,N,3));
    linsys_fn(src, neighbors, mask, kernel_scale, center, active) ->
    LinearSystem of B rows. Each iteration makes one call of each for all
    rows, solves the B systems in one batched factorisation and moves every
    row still running; a row that has converged or run `max_iterations`
    keeps its carry, as `vmap`'s frozen rows do, so its result is its own
    `gauss_newton_loop`. The loop ends once no row runs: one host read per
    trip of `unroll` iterations (as in `gauss_newton_loop`), whatever B.
    Each iteration passes its own running rows to query_fn and linsys_fn,
    so a row frozen within a trip costs the kernels no work. Returns
    (t_icp (B,4,4), iterations (B,) int32). `any_active_fn` as in
    `gauss_newton_loop`: the loop then runs while a row runs in any process
    that shares its collectives.
    """
    guess = initial_guess.to(torch.float32)
    src0 = transform_rows(guess, points)
    center = guess[:, :3, 3].contiguous()  # the K1 kernel reads it by pointer
    b, dev = points.shape[0], points.device
    unroll = max(1, int(unroll))

    def running(it, done):
        return (it < max_iterations) & ~done

    def cond(src, t_icp, it, done):
        run = torch.any(running(it, done))
        return run if any_active_fn is None else any_active_fn(run)

    def iteration(src, t_icp, it, done):
        run = running(it, done)
        dist, neighbors = query_fn(src, run)
        corr = torch.isfinite(dist) & valid & (dist < max_distance[:, None])
        dx = solve_increments(linsys_fn(src, neighbors, corr, kernel_scale, center, run))
        new_src, new_t, step = _apply_increments(dx, center, src, t_icp)
        return (torch.where(run[:, None, None], new_src, src),
                torch.where(run[:, None, None], new_t, t_icp),
                it + run.to(torch.int32),
                done | (run & (step < convergence)))

    def body(*carry):
        for _ in range(unroll):
            carry = iteration(*carry)
        return carry

    eye = se3.identity(device=dev).expand(b, 4, 4).contiguous()
    _, t_icp, it, _ = control.while_loop(cond, body, (
        src0, eye, torch.zeros(b, dtype=torch.int32, device=dev), ~active), "gn")
    return t_icp, it


class LockstepAlign(NamedTuple):
    pose: torch.Tensor  # (B, 4, 4) new world pose of each row's scan
    num_iterations: torch.Tensor  # (B,) int32
    num_correspondences: torch.Tensor  # (B,) int32 — after the last iteration


def align_lockstep(
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
    linsys_fn: Optional[Callable] = None,
    any_active_fn: Optional[Callable] = None,
    gn_unroll: int = 1,
) -> LockstepAlign:
    """`align_points_to_map` (nn_mode gather27 / pallas_fused) for B rows
    against their B stacked maps (every table of `m` with a leading B), with
    one batched K2 and one batched K1 launch per lockstep iteration
    (kernels/nn27.query_nearest_batched, kernels/linsys.build_linear_systems).
    A row whose map is empty keeps its guess with 0 iterations and 0
    correspondences, as the unbatched empty-map branch does. The final
    correspondence count is one more batched query, skipped (no launch) when
    every map is empty. `linsys_fn` (default: the batched K1,
    kernels/linsys.build_linear_systems), `any_active_fn` and `gn_unroll`
    (its `unroll`) as in `gauss_newton_loop_lockstep`: the "pts" axis of
    parallel/batch.py passes its block sums."""
    from kiss_icp_tpu_torch.kernels import linsys, nn27

    guess = initial_guess.to(torch.float32)
    present = ~hash_map.is_empty(m)

    def query_fn(src, run):
        q = nn27.query_nearest_batched(cfg, m, src, valid, run)
        return q.distances, q.neighbors

    t_icp, iters = gauss_newton_loop_lockstep(
        points, valid, guess, max_distance, kernel_scale, present,
        query_fn=query_fn, linsys_fn=linsys_fn or linsys.build_linear_systems,
        max_iterations=max_iterations, convergence=convergence, any_active_fn=any_active_fn,
        unroll=gn_unroll)
    pose = torch.where(present[:, None, None], t_icp @ guess, guess)
    if trace.read("map_empty", bool, torch.any(present)):
        q = nn27.query_nearest_batched(cfg, m, transform_rows(pose, points), valid, present)
        n_corr = torch.sum(q.found & (q.distances < max_distance[:, None]), dim=-1,
                           dtype=torch.int32)
    else:
        n_corr = torch.zeros(points.shape[0], dtype=torch.int32, device=points.device)
    return LockstepAlign(pose, iters, n_corr)
