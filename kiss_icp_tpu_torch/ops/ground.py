"""Ground-plane attitude stabilization (`engine.ground_align`, off by default).

Port of `kiss_icp_tpu/ops/ground.py`. Point-to-point ICP observes pitch and
roll only through vertical structure, so on ground-dominated scans they
drift. Each frame this fits the ground plane in the body frame (least
squares over the lowest band of an annulus) and rotates the pose about its
own position by a fraction of the measured tilt, so the ground normal stays
vertical; the translation is untouched. Mask-based tensor math on the
pose's device, with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kiss_icp_tpu_torch.ops.voxel import f32_scalar


def maybe_align(config, points: torch.Tensor, valid: torch.Tensor,
                pose: torch.Tensor) -> torch.Tensor:
    """Step 5d of register_frame: the configured stabilization, or the pose
    unchanged when engine.ground_align is 0."""
    lam = float(config.engine.ground_align)
    if lam <= 0.0:
        return pose
    return align_pose_to_ground(pose, estimate_ground_plane(points, valid), lam)


class GroundPlane(NamedTuple):
    normal_body: torch.Tensor  # (3,) unit normal of the ground in the body frame
    height: torch.Tensor  # () sensor height above the plane
    num_points: torch.Tensor  # () int32 points in the fitted band
    ok: torch.Tensor  # () bool enough support and a sane plane


def nanquantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated quantile of the non-NaN entries of a 1-D f32
    tensor, with `jnp.nanquantile`'s bits: rank q*(count-1) in f32, then
    low*(1-w) + high*w, where XLA fuses the second product and the sum into
    one FMA (here: the exact f64 product plus the rounded f32 first
    product, rounded once to f32). `torch.nanquantile` interpolates as a
    lerp, in another order, and can move the band edge by an ulp. NaN when
    every entry is NaN. The two ranks are read by `torch.take`: indexing by
    a 0-dim tensor reads the index back to the host."""
    s = torch.sort(x).values  # NaNs last
    qf = f32_scalar(q, x.device)
    count = torch.sum(~torch.isnan(s), dtype=torch.int32).to(torch.float32)
    rank = qf * (count - 1.0)
    low, high = torch.floor(rank), torch.ceil(rank)
    w_high = rank - low
    w_low = 1.0 - w_high
    top = count - 1.0
    lo_i = torch.clamp(torch.minimum(low, top), min=0.0).to(torch.int64)
    hi_i = torch.clamp(torch.minimum(high, top), min=0.0).to(torch.int64)
    fma = torch.take(s, hi_i).double() * w_high.double() + (torch.take(s, lo_i) * w_low).double()
    return fma.to(torch.float32)


def estimate_ground_plane(points: torch.Tensor, valid: torch.Tensor, *,
                          r_min: float = 3.0, r_max: float = 30.0, band: float = 0.3,
                          quantile: float = 0.15, min_points: int = 200) -> GroundPlane:
    """Fit z = ax + by + c to the points within `band` of the `quantile`
    lowest z in the annulus [r_min, r_max] (JAX
    `ground.estimate_ground_plane`). The quantile is taken over every 16th
    entry of the padded cloud, as in JAX. A fit with too few points, a
    singular system or a plane steeper than ~30 degrees reports ok=False."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r2 = x * x + y * y
    in_ring = valid & (r2 > r_min * r_min) & (r2 < r_max * r_max)

    z_masked = torch.where(in_ring, z, torch.full_like(z, float("nan")))
    z_lo = nanquantile(z_masked.reshape(-1)[::16], quantile)
    sel = in_ring & (z < z_lo + band) & (z > z_lo - band)
    w = sel.to(torch.float32)
    n = torch.sum(w).to(torch.int32)

    # Weighted normal equations for [a, b, c], centered for conditioning.
    sw = torch.clamp(torch.sum(w), min=1.0)
    mx, my, mz = torch.sum(w * x) / sw, torch.sum(w * y) / sw, torch.sum(w * z) / sw
    xc, yc, zc = x - mx, y - my, z - mz
    sxx = torch.sum(w * xc * xc)
    sxy = torch.sum(w * xc * yc)
    syy = torch.sum(w * yc * yc)
    sxz = torch.sum(w * xc * zc)
    syz = torch.sum(w * yc * zc)
    det = sxx * syy - sxy * sxy
    safe = torch.abs(det) > 1e-6
    det_s = torch.where(safe, det, torch.ones_like(det))
    a = (syy * sxz - sxy * syz) / det_s
    b = (sxx * syz - sxy * sxz) / det_s
    c = mz - a * mx - b * my  # plane z at the body origin

    normal = torch.stack([-a, -b, torch.ones_like(a)])
    normal = normal / torch.linalg.norm(normal)
    sane = normal[2] > 0.85
    height = -c * normal[2]
    ok = (n >= min_points) & safe & sane & torch.all(torch.isfinite(normal))
    return GroundPlane(normal, height, n, ok)


def align_pose_to_ground(pose: torch.Tensor, plane: GroundPlane, alignment: float, *,
                         max_correction_rad: float = 0.05) -> torch.Tensor:
    """Rotate `pose` about its own position so the measured ground normal
    moves toward the world +z by `alignment` (0..1) of the tilt, at most
    `max_correction_rad` a frame; the translation is untouched. A fit that
    is not ok, no tilt, or a non-finite correction leaves the pose as it
    was. Returns a new pose."""
    n_w = pose[:3, :3] @ plane.normal_body  # the measured normal, world frame
    # A row of a device identity: storing 1.0 into a CUDA tensor copies it
    # from pageable host memory, which blocks the host.
    e_z = torch.eye(3, dtype=pose.dtype, device=pose.device)[2]
    axis = torch.linalg.cross(n_w, e_z, dim=-1)
    s = torch.linalg.norm(axis)
    angle = torch.atan2(s, n_w[2])
    corr = torch.clamp(alignment * angle, 0.0, max_correction_rad)
    k = axis / torch.clamp(s, min=1e-9)

    # Rodrigues for the small correction rotation.
    zero = torch.zeros_like(k[0])
    kx, ky, kz = k[0], k[1], k[2]
    kmat = torch.stack([torch.stack([zero, -kz, ky]), torch.stack([kz, zero, -kx]),
                        torch.stack([-ky, kx, zero])])
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
    r_corr = eye + torch.sin(corr) * kmat + (1.0 - torch.cos(corr)) * (kmat @ kmat)

    apply = plane.ok & (s > 1e-9) & torch.all(torch.isfinite(r_corr))
    out = pose.clone()
    out[:3, :3] = torch.where(apply, r_corr @ pose[:3, :3], pose[:3, :3])
    return out
