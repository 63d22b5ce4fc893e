"""Robust point-to-point ICP (Gauss-Newton + Geman-McClure).

Port of `kiss_icp_tpu/ops/registration.py` (reference Registration.cpp:
52-167). The ICP loop is a host loop with one scalar read per iteration
(the convergence test); each iteration runs the fused NN kernel
(kernels/nn27.py) and the normal-equation kernel (kernels/linsys.py) on CUDA
tensors, or their plain versions on CPU tensors.

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

from kiss_icp_tpu_torch.config.schema import SUPPORTED_NN_MODES
from kiss_icp_tpu_torch.ops import hash_map, se3


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
    num_iterations: int  # ICP iterations run
    num_correspondences: torch.Tensor  # () int32 — after the last iteration


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
) -> Tuple[torch.Tensor, int]:
    """The ICP loop (reference Registration.cpp:151-164).

    query_fn(src) -> (distances (N,), neighbors (N, 3));
    linsys_fn(src, neighbors, mask, kernel_scale, center) -> LinearSystem.
    Runs until the world-frame increment norm is below `convergence` (the
    iteration that converges still applies its step) or `max_iterations`.
    Returns (t_icp (4, 4), iterations) with final pose = t_icp @ guess.
    """
    guess = initial_guess.to(torch.float32)
    src = se3.transform(guess, points)
    center = guess[:3, 3].contiguous()  # the K1 kernel reads it by pointer
    t_icp = se3.identity(device=points.device)
    it = 0
    while it < max_iterations:
        dist, neighbors = query_fn(src)
        corr = torch.isfinite(dist) & valid & (dist < max_distance)
        dx = solve_increment(linsys_fn(src, neighbors, corr, kernel_scale, center))
        est = se3.se3_exp(dx)
        # Conjugate the recentered increment back to the world frame.
        est[:3, 3] += center - est[:3, :3] @ center
        src = se3.transform(est, src)
        t_icp = est @ t_icp
        it += 1
        # Convergence on the increment expressed at the WORLD origin, like the
        # reference (`dx.norm() < criterion`, Registration.cpp:163).
        v, w = dx[:3], dx[3:]
        v_world = v - torch.linalg.cross(w, center, dim=-1)
        step = torch.sqrt(torch.sum(v_world * v_world) + torch.sum(w * w))
        if bool(step < convergence):
            break
    return t_icp, it


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
) -> AlignResult:
    """Register one body-frame source scan against the local map.

    Mirrors Registration::AlignPointsToMap (Registration.cpp:138-167): an
    empty map returns the guess with 0 iterations; otherwise iterate NN
    association + robust GN. Both supported `nn_mode`s run the fused NN
    kernel on CUDA tensors.
    """
    # The kernels' wrappers import this module for the plain versions.
    from kiss_icp_tpu_torch.kernels import linsys, nn27

    if nn_mode not in SUPPORTED_NN_MODES:
        raise NotImplementedError(
            f"nn_mode={nn_mode!r} is not ported yet (ROADMAP item 14)")
    guess = initial_guess.to(torch.float32)
    if bool(hash_map.is_empty(m)):
        return AlignResult(guess, 0, torch.zeros((), dtype=torch.int32,
                                                 device=points.device))

    def query_fn(src):
        q = nn27.query_nearest(cfg, m, src, valid)
        return q.distances, q.neighbors

    t_icp, iters = gauss_newton_loop(
        points, valid, guess, max_distance, kernel_scale,
        query_fn=query_fn, linsys_fn=linsys.build_linear_system,
        max_iterations=max_iterations, convergence=convergence)

    pose = t_icp @ guess
    # Final correspondence count for diagnostics (one extra association).
    q = nn27.query_nearest(cfg, m, se3.transform(pose, points), valid)
    n_corr = torch.sum(q.found & (q.distances < max_distance), dtype=torch.int32)
    return AlignResult(pose, iters, n_corr)
