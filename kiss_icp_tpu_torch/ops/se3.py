"""SE(3)/SO(3) Lie-group math on batched float32 tensors.

Port of `kiss_icp_tpu/ops/se3.py`. Everything is batched over leading
dimensions and branch-free (`torch.where` with Taylor fallbacks), so one call
serves a single pose or one pose per point.

Conventions (matching Sophus, as the JAX package does):
  * twists are 6-vectors [v(3), w(3)]: translation part first, rotation second.
  * poses are (4, 4) homogeneous matrices.
"""

from __future__ import annotations

import math

import torch

# Below this angle (radians) the sinc-like terms switch to Taylor series.
_SMALL = 1e-3


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w, batched: (..., 3) -> (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _sinc_terms(theta2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (1-A)/t^2), batched and NaN-safe."""
    theta = torch.sqrt(theta2)
    small = theta < _SMALL
    # Guard the denominators so the unused branch never produces NaN/Inf.
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / safe_t2)
    return a, b, c


def _eye3_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) rotation vector -> (..., 3, 3) matrix."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_terms(theta2)
    k = hat(w)
    k2 = k @ k
    return _eye3_like(k) + a[..., None, None] * k + b[..., None, None] * k2


def rotation_angle(r: torch.Tensor) -> torch.Tensor:
    """Rotation angle in [0, pi] of a rotation matrix (..., 3, 3).

    atan2(|skew(R)|, (tr-1)/2), not arccos((tr-1)/2): in float32 the cosine
    rounds to exactly 1.0 below ~3.5e-4 rad, and the adaptive threshold's
    rotation term (multiplied by 2*max_range) would silently vanish.
    """
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos = 0.5 * (tr - 1.0)
    sin = torch.linalg.norm(0.5 * vee(r - r.transpose(-1, -2)), dim=-1)
    return torch.atan2(sin, cos)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3), robust at 0 and pi."""
    theta = rotation_angle(r)
    theta2 = theta * theta
    a, _, _ = _sinc_terms(theta2)  # sin(theta)/theta
    skew = 0.5 * vee(r - r.transpose(-1, -2))  # = sin(theta) * axis
    # Generic branch: w = skew / sinc(theta). Valid away from pi.
    w_generic = skew / torch.clamp(a, min=1e-12)[..., None]
    # Near pi the skew part vanishes; recover the axis from the diagonal of
    # R ~= 2 aa^T - I  =>  a_i^2 = (R_ii + 1) / 2.
    diag = torch.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    # Largest component positive, the others signed from the symmetric
    # off-diagonals (R + R^T)/2 = a_i a_j * k.
    largest = torch.argmax(axis_abs, dim=-1)
    sym01 = r[..., 0, 1] + r[..., 1, 0]
    sym02 = r[..., 0, 2] + r[..., 2, 0]
    sym12 = r[..., 1, 2] + r[..., 2, 1]
    a0, a1, a2 = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    s0 = torch.where(largest == 0, a0,
                     torch.where(largest == 1, torch.sign(sym01) * a0,
                                 torch.sign(sym02) * a0))
    s1 = torch.where(largest == 0, torch.sign(sym01) * a1,
                     torch.where(largest == 1, a1, torch.sign(sym12) * a1))
    s2 = torch.where(largest == 0, torch.sign(sym02) * a2,
                     torch.where(largest == 1, torch.sign(sym12) * a2, a2))
    axis_pi = torch.stack([s0, s1, s2], dim=-1)
    norm = torch.linalg.norm(axis_pi, dim=-1, keepdim=True)
    axis_pi = axis_pi / torch.clamp(norm, min=1e-12)
    w_pi = theta[..., None] * axis_pi
    near_pi = theta > (math.pi - 1e-2)
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _v_matrix(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V(w) of SE(3) exp: integrates rotation into translation."""
    theta2 = torch.sum(w * w, dim=-1)
    _, b, c = _sinc_terms(theta2)
    k = hat(w)
    k2 = k @ k
    return _eye3_like(k) + b[..., None, None] * k + c[..., None, None] * k2


def _v_matrix_inv(w: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of the left Jacobian V(w)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < _SMALL
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    half = 0.5 * safe_t
    # coeff = (1 - theta/2 * cot(theta/2)) / theta^2
    cot_term = half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-12)
    coeff = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - cot_term) / safe_t2)
    k = hat(w)
    k2 = k @ k
    return _eye3_like(k) - 0.5 * k + coeff[..., None, None] * k2


def se3_exp(twist: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [v, w] -> homogeneous pose (..., 4, 4). Matches Sophus exp."""
    v, w = twist[..., :3], twist[..., 3:]
    r = so3_exp(w)
    t = (_v_matrix(w) @ v[..., None])[..., 0]
    return rt_to_matrix(r, t)


def se3_log(pose: torch.Tensor) -> torch.Tensor:
    """Homogeneous pose (..., 4, 4) -> twist (..., 6) [v, w]. Matches Sophus log."""
    r = pose[..., :3, :3]
    t = pose[..., :3, 3]
    w = so3_log(r)
    v = (_v_matrix_inv(w) @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def rt_to_matrix(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R (...,3,3), t (...,3)) -> (..., 4, 4) homogeneous matrix."""
    # [0, 0, 0, 1] from two fills: a scalar written into a tensor would be
    # a tensor constant, which an exported loop body cannot hold.
    like = dict(dtype=r.dtype, device=r.device)
    bottom = torch.cat([torch.zeros(r.shape[:-2] + (1, 3), **like),
                        torch.ones(r.shape[:-2] + (1, 1), **like)], dim=-1)
    top = torch.cat([r, t[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def inverse(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form rigid inverse (no general 4x4 inversion)."""
    r = pose[..., :3, :3]
    t = pose[..., :3, 3]
    rt = r.transpose(-1, -2)
    return rt_to_matrix(rt, -(rt @ t[..., None])[..., 0])


def orthonormalize(pose: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (Gram-Schmidt).

    Raw f32 3x3 matrices accumulate scale drift multiplicatively across the
    thousands of compositions of a long drive (Sophus renormalizes its
    quaternions instead); one projection per frame keeps the drift at the
    single-composition level.
    """
    r = pose[..., :3, :3]
    t = pose[..., :3, 3]
    c0 = r[..., :, 0]
    c1 = r[..., :, 1]
    eps = 1e-30
    c0 = c0 / torch.clamp(torch.linalg.norm(c0, dim=-1, keepdim=True), min=eps)
    c2 = torch.linalg.cross(c0, c1, dim=-1)
    c2 = c2 / torch.clamp(torch.linalg.norm(c2, dim=-1, keepdim=True), min=eps)
    c1 = torch.linalg.cross(c2, c0, dim=-1)
    r_on = torch.stack([c0, c1, c2], dim=-1)
    return rt_to_matrix(r_on, t)


def transform(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) pose to (..., 3) points (full f32: TF32 is off)."""
    r = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return points @ r.transpose(-1, -2) + t


def exp_scaled_batch(twist: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """exp(scales[i] * twist) for one twist and a batch of scalar scales.

    Motion deskewing's per-point pose exp((stamp - 1) * log(relative_motion))
    (reference Preprocessing.cpp:68-80). Returns (N, 4, 4).
    """
    return se3_exp(scales[..., None] * twist)
