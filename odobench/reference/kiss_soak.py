"""KISS-ICP with the long-drive options in plain PyTorch: a 16-bit
voxel-relative map and the ground-plane attitude fit.

The reference of a configuration that states `engine.map_storage` "u16" or
`engine.ground_align` above 0 (`"reference": "kiss_soak"`). It is
`kiss.py`, whose every choice it keeps, with two more meanings:

  * **u16 storage.** The map keeps each accepted point as its owning
    voxel's corner plus round((p - corner) * 65535 / v), clamped to
    0..65535, times v / 65535. The acceptance distance, the trim's first
    point and the nearest-neighbour query all read these decoded points.
  * **The ground fit.** After a frame is registered, the ground is fitted
    in the body frame on the half-voxel frame cloud: the points of the
    3-30 m annulus within 0.3 m of the 0.15 quantile of their z, at least
    200 of them, by least squares for z = ax + by + c; a fit whose normal
    leans more than ~30 degrees (its z below 0.85) is rejected. The pose is
    then rotated about its own position by `ground_align` of the measured
    tilt. The order is the program's: ground, then the threshold's model
    deviation, the insert and the trim.

Where the program fixes a choice the description leaves open, the
reference makes the same one:
  * a frame's candidates are tested against the voxel's stored points
    decoded and against the points accepted earlier in the same frame as
    they came (the program encodes a voxel's row once, after its last
    candidate);
  * the corner is the voxel's key times v, and a point is quantised in its
    own voxel, the one floor(p / v) names;
  * the quantile reads every 16th entry of the padded frame cloud, whose
    valid entries come first in the downsample's order (`kiss.downsample`),
    and interpolates linearly between ranks, at rank q (count - 1);
  * the annulus and the band are open intervals; the fit is centred on the
    band's mean and refused where the determinant of its 2x2 system is
    1e-6 or less;
  * the correction is at most 0.05 rad a frame, about the axis that takes
    the measured normal (in the world frame) to +z; a fit that is refused,
    or a normal already vertical (|n x z| at most 1e-9), leaves the pose;
  * the fit also corrects the pose of a frame registered against an empty
    map (the first), whose pose is the guess.

It computes in float64 (`follow`), where TF32 never applies, imports
nothing of the program under test, and builds on `kiss.py`.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from odobench.reference import kiss
from odobench.reference.kiss import Math, pose_gap  # noqa: F401  (the harness's names)

U16_MAX = 65535.0


class _AtLeastZero:
    """The values of a key that takes any number at or above 0."""

    def __contains__(self, value) -> bool:
        return (isinstance(value, (int, float)) and not isinstance(value, bool)
                and math.isfinite(value) and value >= 0)


# `kiss.MODELS` with the two meanings this reference adds.
MODELS = {**kiss.MODELS, "engine.map_storage": ("f32", "u16"),
          "engine.ground_align": _AtLeastZero()}

# The ground fit's fixed settings (the program's defaults).
RING_M = (3.0, 30.0)
QUANTILE = 0.15
BAND_M = 0.3
MIN_POINTS = 200
QUANTILE_STRIDE = 16
MIN_NORMAL_Z = 0.85
MAX_CORRECTION_RAD = 0.05


@dataclass(frozen=True)
class Params(kiss.Params):
    map_storage: str = "f32"
    ground_align: float = 0.0

    @classmethod
    def from_config(cls, kiss_config: dict) -> "Params":
        e = kiss_config.get("engine", {})
        return cls(**asdict(kiss.Params.from_config(kiss_config)),
                   map_storage=str(e.get("map_storage", "f32")),
                   ground_align=float(e.get("ground_align", 0.0)))


def _unpack(keys: torch.Tensor) -> torch.Tensor:
    """Voxel coords (V, 3) int64 of `kiss._pack`'s keys."""
    mask = (1 << 21) - 1
    return torch.stack([keys >> 42, (keys >> 21) & mask, keys & mask], dim=1) - kiss._KEY_OFF


def quantise(points: torch.Tensor, corners: torch.Tensor, voxel: float) -> torch.Tensor:
    """Points as a u16 map stores them, decoded: corner + q v / 65535 with
    q = round((p - corner) 65535 / v) clamped to 0..65535. A point already
    stored comes back as it was."""
    q = torch.clamp(torch.round((points - corners) * (U16_MAX / voxel)), 0.0, U16_MAX)
    return corners + q * (voxel / U16_MAX)


class VoxelMap(kiss.VoxelMap):
    """`kiss.VoxelMap`, with every stored point quantised after an insert
    when the map is u16."""

    def insert(self, world: torch.Tensor) -> None:
        super().insert(world)
        if self.p.map_storage == "u16" and self.keys.numel():
            v = self.p.voxel_size
            corners = (_unpack(self.keys).to(self.pts.dtype) * v)[:, None, :]
            self.pts = quantise(self.pts, corners, v)


def ground_normal(frame: torch.Tensor) -> Optional[torch.Tensor]:
    """The ground's unit normal (3,) in the body frame, fitted on the frame
    cloud (M, 3) as the module docstring says, or None where the fit is
    refused."""
    x, y, z = frame[:, 0], frame[:, 1], frame[:, 2]
    r2 = x * x + y * y
    ring = (r2 > RING_M[0] ** 2) & (r2 < RING_M[1] ** 2)
    sample = z[::QUANTILE_STRIDE][ring[::QUANTILE_STRIDE]]
    if sample.numel() == 0:
        return None
    z_lo = torch.quantile(sample, QUANTILE)
    sel = ring & (z < z_lo + BAND_M) & (z > z_lo - BAND_M)
    n = int(sel.sum())
    if n < MIN_POINTS:
        return None
    xs, ys, zs = x[sel], y[sel], z[sel]
    xc, yc, zc = xs - xs.mean(), ys - ys.mean(), zs - zs.mean()
    sxx, sxy, syy = torch.sum(xc * xc), torch.sum(xc * yc), torch.sum(yc * yc)
    sxz, syz = torch.sum(xc * zc), torch.sum(yc * zc)
    det = sxx * syy - sxy * sxy
    if not float(torch.abs(det)) > 1e-6:
        return None
    a = (syy * sxz - sxy * syz) / det
    b = (sxx * syz - sxy * sxz) / det
    normal = torch.stack([-a, -b, torch.ones_like(a)])
    normal = normal / torch.linalg.norm(normal)
    if not (bool(torch.all(torch.isfinite(normal))) and float(normal[2]) > MIN_NORMAL_Z):
        return None
    return normal


def level(mth: Math, pose: torch.Tensor, normal: Optional[torch.Tensor],
          alignment: float) -> torch.Tensor:
    """`pose` rotated about its own position by `alignment` of the tilt
    between the measured ground normal and +z, at most 0.05 rad."""
    if normal is None:
        return pose
    n_w = mth.mm(pose[:3, :3], normal[:, None])[:, 0]
    axis = torch.stack([n_w[1], -n_w[0], torch.zeros_like(n_w[0])])  # n_w x e_z
    s = torch.linalg.norm(axis)
    if not float(s) > 1e-9:
        return pose
    corr = min(max(alignment * float(torch.atan2(s, n_w[2])), 0.0), MAX_CORRECTION_RAD)
    twist = torch.cat([torch.zeros_like(axis), axis / s * corr])
    out = pose.clone()
    out[:3, :3] = mth.mm(mth.exp(twist)[:3, :3], pose[:3, :3])
    return out


class Odometry(kiss.Odometry):
    """`kiss.Odometry` on this module's map, with the ground fit applied to
    each registered pose."""

    def __init__(self, p: Params, mth: Math, record_work: bool = False):
        super().__init__(p, mth, record_work=record_work)
        self.map = VoxelMap(p, mth)
        self.frame = None

    def clouds(self, points: np.ndarray, stamps: np.ndarray):
        frame, source = super().clouds(points, stamps)
        self.frame = frame  # the cloud the ground fit reads
        return frame, source

    def register(self, source: torch.Tensor, guess: torch.Tensor, sigma: float):
        pose, iters, works = super().register(source, guess, sigma)
        if self.p.ground_align > 0:
            pose = level(self.m, pose, ground_normal(self.frame), self.p.ground_align)
        return pose, iters, works


def follow(p: Params, scans, poses: np.ndarray, check: List[int], device=None,
           record_work: bool = False) -> Dict[int, Tuple[np.ndarray, int, list]]:
    """`kiss.follow` with this module's odometry."""
    odo = Odometry(p, Math(torch.float64, "full", device), record_work=record_work)
    want = set(check)
    out = {}
    for k in range(max(want) + 1 if want else 0):
        pts, stamps = scans[k]
        found, iters, works = odo.step(pts, stamps, pose=poses[k], register=k in want)
        if k in want:
            out[k] = (found.cpu().numpy(), iters, works)
    return out
