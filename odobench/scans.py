"""LiDAR drives rendered on the card from a seed.

A PyTorch copy of the port's procedural sensor
(`kiss_icp_tpu_torch/datasets/synthetic.py`, itself a copy of the JAX
package's): the world (boxes on a terrain height field), the trajectory and
its suspension noise are drawn in NumPy from the seed, as there; the raycast
runs vectorised over rays x the boxes within reach, in float64 on the
device. A drive comes back as the host NumPy arrays a loader gives: points
(N, 3) float64 in the body frame and per-point stamps (N,) float64 (empty
when the scans are already motion-compensated, `distort=False`).

Per-ray noise and dropout: `noise_source="numpy"` draws them as the
original does (`np.random.default_rng(noise_seed + frame)`), bit for bit;
`"device"` draws the same distributions with a `torch.Generator` on the
device, which is what the benchmark uses (a NumPy draw of 2 x 131k values a
frame is the slowest part of a host render).

Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

SENSOR_OFFSET = (0.0, 0.0, 1.8)


def _hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def _se3_log(t):
    """4x4 -> twist [v, w] (closed form; as the original)."""
    r = t[:3, :3]
    cos_theta = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    skew = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    if theta < 1e-8:
        w = skew / 2.0
        v_inv = np.eye(3)
    else:
        # The drive turns by a few hundredths of a radian a frame: the
        # original's branch near pi is never taken.
        w = theta / (2.0 * np.sin(theta)) * skew
        half = theta / 2.0
        coeff = (1.0 - half * np.cos(half) / np.sin(half)) / (theta * theta)
        v_inv = np.eye(3) - 0.5 * _hat(w) + coeff * (_hat(w) @ _hat(w))
    return np.concatenate([v_inv @ t[:3, 3], w])


def _se3_exp_scaled(twists: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """exp(scale_k * twist_g) for G twists (G, 6) and R scales -> (G, R, 4, 4),
    Rodrigues in float64."""
    tw = scales[None, :, None] * twists[:, None, :]
    v, w = tw[..., :3], tw[..., 3:]
    theta = torch.linalg.norm(w, dim=-1)
    zero = torch.zeros_like(theta)
    k = torch.stack([zero, -w[..., 2], w[..., 1], w[..., 2], zero, -w[..., 0],
                     -w[..., 1], w[..., 0], zero], dim=-1).view(*theta.shape, 3, 3)
    big = theta > 1e-8
    safe = torch.where(big, theta, torch.ones_like(theta))
    a = torch.where(big, torch.sin(safe) / safe, 1.0 - theta**2 / 6)
    b = torch.where(big, (1 - torch.cos(safe)) / safe**2, torch.full_like(theta, 0.5))
    c = torch.where(big, (1 - a) / safe**2, torch.full_like(theta, 1.0 / 6.0))
    k2 = k @ k
    eye = torch.eye(3, dtype=tw.dtype, device=tw.device).expand(k.shape)
    rot = eye + a[..., None, None] * k + b[..., None, None] * k2
    vmat = eye + b[..., None, None] * k + c[..., None, None] * k2
    out = torch.eye(4, dtype=tw.dtype, device=tw.device).repeat(*theta.shape, 1, 1)
    out[..., :3, :3] = rot
    out[..., :3, 3] = (vmat @ v[..., None])[..., 0]
    return out


def terrain_height(x, y, lib=np):
    """The original's gentle terrain (slopes < ~0.1), for NumPy or torch."""
    sin, cos = lib.sin, lib.cos
    return (
        0.4 * sin(0.09 * x) * cos(0.075 * y)
        + 0.25 * sin(0.031 * x + 1.0)
        + 0.2 * cos(0.043 * y + 2.0)
        + 0.08 * sin(0.9 * x) * sin(0.83 * y + 0.5)
        + 0.05 * cos(1.7 * x + 0.3) * sin(1.3 * y)
        + 0.12 * sin(0.45 * x + 0.7) * cos(0.4 * y)
        + 0.06 * sin(2.2 * x + 1.1) * cos(1.9 * y + 0.4)
    )


def make_world(rng: np.random.Generator, trajectory_xy: np.ndarray) -> np.ndarray:
    """The original's stratified world along the path: buildings, poles,
    cars, curbs and verge clutter, drawn in the same order from `rng`.
    Returns (B, 2, 3) float64 box corners (lo, hi)."""
    deltas = np.diff(trajectory_xy, axis=0)
    seg_len = np.linalg.norm(deltas, axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = float(arc[-1])

    def frame_at(s):
        if len(deltas) == 0 or total < 1e-9:
            return trajectory_xy[0], np.array([1.0, 0.0]), np.array([0.0, 1.0])
        sc = float(np.clip(s, 0.0, total - 1e-9))
        i = int(np.clip(np.searchsorted(arc, sc) - 1, 0, len(deltas) - 1))
        t = deltas[i] / max(seg_len[i], 1e-9)
        frac = (sc - arc[i]) / max(seg_len[i], 1e-9)
        pos = trajectory_xy[i] + frac * deltas[i] + (s - sc) * t
        return pos, t, np.array([-t[1], t[0]])

    boxes = []

    def box(c, half, h, sink):
        z0 = terrain_height(np.array([c[0]]), np.array([c[1]]))[0]
        boxes.append(((c[0] - half[0], c[1] - half[1], z0 - sink),
                      (c[0] + half[0], c[1] + half[1], z0 + h)))

    s = -40.0
    while s < total + 40.0:
        for side in (-1.0, 1.0):
            pos, tang, norm = frame_at(s + rng.uniform(-3.0, 3.0))
            lateral = rng.uniform(8.0, 20.0)
            half = rng.uniform(4.0, 10.0, 2)
            c = pos + side * (lateral + float(np.max(half))) * norm
            box(c, half, rng.uniform(4.0, 18.0), sink=1.0)
        s += 6.0
    s, side = rng.uniform(0.0, 5.0), 1.0
    while s < total:
        pos, tang, norm = frame_at(s)
        c = pos + side * rng.uniform(4.0, 8.0) * norm
        box(c, rng.uniform(0.1, 0.3, 2), rng.uniform(2.5, 5.0), sink=0.5)
        side = -side
        s += rng.uniform(3.0, 5.0)
    s = rng.uniform(0.0, 7.0)
    while s < total:
        pos, tang, norm = frame_at(s)
        side = rng.choice([-1.0, 1.0])
        c = pos + side * rng.uniform(3.0, 6.0) * norm
        ext = np.abs(tang) * rng.uniform(1.0, 2.4) + np.abs(norm) * rng.uniform(0.7, 1.1)
        box(c, ext, rng.uniform(1.2, 1.9), sink=0.2)
        s += rng.uniform(4.0, 6.0)
    for side in (-1.0, 1.0):
        s = -10.0
        while s < total + 10.0:
            seg = rng.uniform(2.0, 4.0)
            pos, tang, norm = frame_at(s + seg / 2.0)
            c = pos + side * 3.5 * norm
            ext = np.abs(tang) * (seg / 2.0) + np.abs(norm) * 0.15
            box(c, ext, rng.uniform(0.1, 0.18), sink=0.3)
            s += seg + rng.uniform(0.0, 0.6)
    s = 0.0
    while s < total:
        pos, tang, norm = frame_at(s)
        side = rng.choice([-1.0, 1.0])
        c = pos + side * rng.uniform(2.5, 8.0) * norm + tang * rng.uniform(-1.0, 1.0)
        box(c, rng.uniform(0.12, 0.45, 2), rng.uniform(0.15, 0.7), sink=0.2)
        s += rng.uniform(1.0, 2.0)
    return np.array(boxes, np.float64).reshape(-1, 2, 3)


def make_trajectory(rng: np.random.Generator, n_scans: int, speed: float,
                    accel_frames: int, turn_rate: float) -> np.ndarray:
    """World-frame END-of-scan poses (n, 4, 4): the original's ramp from
    standstill, its slow wander, the terrain's height and the suspension's
    AR(1) pitch, roll and heave, drawn from `rng` in the same order."""
    poses = np.tile(np.eye(4), (n_scans, 1, 1))
    pose = np.eye(4)
    heading = 0.0
    for i in range(n_scans):
        poses[i] = pose
        v = speed * min(1.0, (i + 1) / max(accel_frames, 1))
        heading_rate = turn_rate * np.sin(i * 0.05) * (v / max(speed, 1e-9))
        heading += heading_rate
        yaw = np.array([[np.cos(heading_rate), -np.sin(heading_rate), 0],
                        [np.sin(heading_rate), np.cos(heading_rate), 0], [0, 0, 1]])
        new_pose = pose.copy()
        new_pose[:3, :3] = pose[:3, :3] @ yaw
        new_pose[:3, 3] = pose[:3, 3] + np.array([v * np.cos(heading), v * np.sin(heading), 0.0])
        pose = new_pose
    xy = poses[:, :2, 3]
    poses[:, 2, 3] = terrain_height(xy[:, 0], xy[:, 1])
    ar, state = 0.6, np.zeros(3)
    for i in range(n_scans):
        vfrac = min(1.0, (i + 1) / max(accel_frames, 1))
        state = ar * state + rng.normal(0.0, [0.004, 0.003, 0.015], 3) * vfrac
        cp, sp = np.cos(state[0]), np.sin(state[0])
        cr, sr = np.cos(state[1]), np.sin(state[1])
        r_pitch = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        r_roll = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        poses[i, :3, :3] = poses[i, :3, :3] @ (r_pitch @ r_roll)
        poses[i, 2, 3] += state[2]
    return poses


@dataclass
class Sensor:
    """A spinning multi-beam LiDAR: beams spread evenly over the elevation
    range, columns evenly over the turn, one turn a scan."""

    n_beams: int = 64
    n_azimuth: int = 1024
    elevation_deg: Tuple[float, float] = (-24.0, 2.0)
    max_range: float = 100.0
    distort: bool = True
    noise: float = 0.01
    dropout: float = 0.2


class Drive:
    """One procedural drive: `world_seed` draws the trajectory's noise and
    the world (the original's `1234 + sequence`), `noise_seed + frame` each
    frame's per-ray noise (the original's `5678 + sequence`).

    `render(frames)` returns a list of (points, stamps) host arrays.
    `gt_poses` are END-of-scan poses re-based to the first, as the
    original's."""

    # Azimuth sectors of a turn: each sector's rays are tested only against
    # the boxes its azimuths can reach.
    SECTORS = 32
    # Elements of one slab-test block: bounds the (rays x boxes x 3)
    # temporaries.
    SLAB_BLOCK = 1 << 25

    def __init__(self, sensor: Sensor, n_scans: int, *, world_seed: int, noise_seed: int,
                 speed: float = 1.0, accel_frames: int = 10, turn_rate: float = 0.02,
                 device=None, noise_source: str = "device"):
        if noise_source not in ("device", "numpy"):
            raise ValueError(f"noise_source must be 'device' or 'numpy', not {noise_source!r}")
        self.sensor = sensor
        self.n_scans = int(n_scans)
        self.noise_seed = int(noise_seed)
        self.noise_source = noise_source
        self.device = torch.device("cpu" if device is None else device)
        rng = np.random.default_rng(world_seed)
        self.render_poses = make_trajectory(rng, self.n_scans, speed, accel_frames, turn_rate)
        self.gt_poses = np.linalg.inv(self.render_poses[0]) @ self.render_poses
        self.boxes_np = make_world(rng, self.render_poses[:, :2, 3])
        f64 = dict(dtype=torch.float64, device=self.device)
        self.boxes = torch.as_tensor(self.boxes_np, **f64)
        az = np.linspace(0, 2 * np.pi, sensor.n_azimuth, endpoint=False)
        elev = np.deg2rad(np.linspace(sensor.elevation_deg[0], sensor.elevation_deg[1],
                                      sensor.n_beams))
        az_g, el_g = np.meshgrid(az, elev)
        az_f, el_f = az_g.ravel(), el_g.ravel()
        self.dirs_body = torch.as_tensor(np.stack(
            [np.cos(el_f) * np.cos(az_f), np.cos(el_f) * np.sin(az_f), np.sin(el_f)],
            axis=1), **f64)
        self.stamps = torch.as_tensor(az_f / (2 * np.pi), **f64)
        # Rays sector by sector, column-major; the last sector is padded with
        # copies of its last ray.
        per_col = -(-sensor.n_azimuth // self.SECTORS)
        cols = np.arange(self.SECTORS * per_col).reshape(self.SECTORS, per_col)
        cols = np.minimum(cols, sensor.n_azimuth - 1)
        rays = cols[:, :, None] + sensor.n_azimuth * np.arange(sensor.n_beams)[None, None, :]
        self._sector_rays = torch.as_tensor(rays.reshape(self.SECTORS, -1), device=self.device)
        self.offset = torch.tensor(SENSOR_OFFSET, **f64)
        self._gen = None

    @property
    def rays(self) -> int:
        return self.dirs_body.shape[0]

    # Rays rendered by one batch of tensor operations (a group of frames).
    GROUP_RAYS = 1 << 20

    def _poses_during_scan(self, frames: List[int]) -> torch.Tensor:
        """(G, R, 4, 4) sensor pose at each ray's stamp, T_i @ exp((t - 1)
        log(delta)), of each frame; T_i for the first frame and for scans
        without distortion (exp(0) is exactly I)."""
        f64 = dict(dtype=torch.float64, device=self.device)
        t_end = torch.as_tensor(self.render_poses[frames], **f64)
        omega = np.zeros((len(frames), 6))
        for g, idx in enumerate(frames):
            if idx > 0 and self.sensor.distort:
                omega[g] = _se3_log(np.linalg.inv(self.render_poses[idx - 1])
                                    @ self.render_poses[idx])
        local = _se3_exp_scaled(torch.as_tensor(omega, **f64), self.stamps - 1.0)
        return t_end[:, None] @ local

    def raycast(self, origins: torch.Tensor, dirs: torch.Tensor):
        """Per-ray (range, hit is ground) of G frames' rays (G, R, 3) against
        the terrain and the boxes within reach of each frame's first ray's
        origin, as the original."""
        max_range = self.sensor.max_range
        ox, oy, oz = origins[..., 0], origins[..., 1], origins[..., 2]
        dz = dirs[..., 2]
        t_ground = (terrain_height(ox, oy, torch) - oz) / dz
        for _ in range(6):
            gx = ox + t_ground * dirs[..., 0]
            gy = oy + t_ground * dirs[..., 1]
            t_ground = (terrain_height(gx, gy, torch) - oz) / dz
        ok = (dz < -1e-6) & (t_ground > 0.1) & torch.isfinite(t_ground)
        t_hit = torch.full_like(dz, max_range + 1.0)
        t_hit = torch.where(ok, torch.minimum(t_hit, t_ground), t_hit)
        ground_t = torch.where(ok, t_ground, torch.full_like(t_ground, float("inf")))

        t_box = torch.full_like(t_hit, float("inf"))
        t_box[:, self._sector_rays.reshape(-1)] = self._box_hits(origins, dirs).flatten(1)
        t_hit = torch.minimum(t_hit, t_box)
        return t_hit, t_hit >= ground_t - 1e-9

    def _box_hits(self, origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        """(G, sectors, rays) nearest box entry beyond 0.1 m (+inf where
        none) of each sector's rays, against the boxes within reach of the
        frame's first ray's origin (as the original) whose footprint the
        sector's azimuths can reach: a ray meets a box only if its
        horizontal direction lies within the footprint's angle seen from
        the ray's origin, which is within asin(move / distance) of the angle
        seen from the first origin. The nearest hit is the original's."""
        max_range = self.sensor.max_range
        o = origins[:, self._sector_rays]  # (G, S, n, 3)
        d = dirs[:, self._sector_rays]
        o0 = origins[:, 0]  # (G, 3)
        lo, hi = self.boxes[:, 0], self.boxes[:, 1]  # (B, 3)
        nearest = torch.maximum(lo[None], torch.minimum(o0[:, None], hi[None]))  # (G, B, 3)
        near = torch.linalg.norm(nearest - o0[:, None], dim=2) <= max_range + 8.0

        def wrap(a):
            return torch.remainder(a + math.pi, 2 * math.pi) - math.pi

        az = torch.atan2(d[..., 1], d[..., 0])  # (G, S, n)
        rel = wrap(az - az[..., :1])
        lo_rel, hi_rel = rel.amin(dim=2), rel.amax(dim=2)
        center = az[..., 0] + 0.5 * (lo_rel + hi_rel)  # (G, S)
        half = 0.5 * (hi_rel - lo_rel)
        corners = torch.stack([torch.stack([lo[:, 0], lo[:, 1]], 1),
                               torch.stack([hi[:, 0], lo[:, 1]], 1),
                               torch.stack([lo[:, 0], hi[:, 1]], 1),
                               torch.stack([hi[:, 0], hi[:, 1]], 1)], dim=1)  # (B, 4, 2)
        rel_c = corners[None] - o0[:, None, None, :2]  # (G, B, 4, 2)
        ang = torch.atan2(rel_c[..., 1], rel_c[..., 0])
        delta = wrap(ang[:, None] - center[..., None, None])  # (G, S, B, 4)
        dmin, dmax = delta.amin(dim=3), delta.amax(dim=3)  # (G, S, B)
        move = torch.linalg.norm(origins[..., :2] - o0[:, None, :2], dim=2).amax(dim=1)  # (G,)
        dist = torch.linalg.norm(nearest[..., :2] - o0[:, None, :2], dim=2)  # (G, B)
        close = dist <= move[:, None] + 1e-3
        pad = torch.asin(torch.clamp(move[:, None] / torch.where(close, torch.ones_like(dist),
                                                                  dist), max=1.0)) + 1e-6
        reach = ((dmin - pad[:, None] <= half[..., None]) & (dmax + pad[:, None] >= -half[..., None])
                 | (dmax - dmin > math.pi) | close[:, None])
        mask = (near[:, None] & reach).flatten(0, 1)  # (G * S, B)
        count = mask.sum(dim=1)
        width = max(1, int(count.max()))
        order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)[:, :width]
        used = torch.arange(width, device=self.device)[None] < count[:, None]  # (G * S, W)
        lo_s, hi_s = lo[order], hi[order]  # (G * S, W, 3)
        o, d = o.flatten(0, 1), d.flatten(0, 1)  # (G * S, n, 3)
        best = torch.full(o.shape[:2], float("inf"), dtype=o.dtype, device=o.device)
        n = o.shape[1]
        block = max(1, self.SLAB_BLOCK // (3 * width * n))
        for s0 in range(0, o.shape[0], block):
            sl = slice(s0, s0 + block)
            oo, dd = o[sl, :, None, :], d[sl, :, None, :]
            t1 = (lo_s[sl, None] - oo) / dd
            t2 = (hi_s[sl, None] - oo) / dd
            # NaN (0/0) lanes are ignored, as np.nanmax / np.nanmin do.
            tmin = torch.amax(torch.nan_to_num(torch.minimum(t1, t2), nan=-float("inf")), dim=3)
            tmax = torch.amin(torch.nan_to_num(torch.maximum(t1, t2), nan=float("inf")), dim=3)
            hit = (tmax >= tmin) & (tmin > 0.1) & used[sl, None, :]
            best[sl] = torch.amin(torch.where(hit, tmin, torch.full_like(tmin, float("inf"))),
                                  dim=2)
        return best.view(origins.shape[0], -1, n)

    def _noise(self, frames: List[int]):
        """(standard normal (G, R), uniform [0, 1) (G, R)) of each frame."""
        normal, uniform = [], []
        for idx in frames:
            if self.noise_source == "numpy":
                rng = np.random.default_rng(self.noise_seed + idx)
                normal.append(torch.as_tensor(rng.normal(0.0, 1.0, size=self.rays),
                                              device=self.device))
                uniform.append(torch.as_tensor(rng.random(self.rays), device=self.device))
                continue
            if self._gen is None:
                self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed((self.noise_seed + idx) % (1 << 63))
            f64 = dict(generator=self._gen, dtype=torch.float64, device=self.device)
            normal.append(torch.randn(self.rays, **f64))
            uniform.append(torch.rand(self.rays, **f64))
        return torch.stack(normal), torch.stack(uniform)

    def render_rays(self, frames):
        """(range (G, R), kept (G, R) bool) of the frames (an index or a
        list), before compaction."""
        frames = [frames] if isinstance(frames, int) else list(frames)
        poses = self._poses_during_scan(frames)
        origins = poses[..., :3, 3] + poses[..., :3, :3] @ self.offset
        dirs_world = (poses[..., :3, :3] @ self.dirs_body[:, :, None])[..., 0]
        t, on_ground = self.raycast(origins, dirs_world)
        hit_pt = origins + t[..., None] * dirs_world
        hx, hy, hz = hit_pt[..., 0], hit_pt[..., 1], hit_pt[..., 2]
        relief = (0.12 * torch.sin(3.1 * hx) * torch.sin(2.7 * hy) * torch.sin(2.3 * hz + 0.7)
                  + 0.06 * torch.sin(7.3 * hx + 1.3) * torch.sin(6.1 * hz))
        t = t + torch.where(on_ground, 0.4 * relief, relief)
        normal, uniform = self._noise(frames)
        grazing = torch.where(on_ground, torch.clamp(torch.abs(t) / 1.8, max=25.0),
                              torch.ones_like(t))
        t = t + normal * self.sensor.noise * grazing
        keep = uniform > self.sensor.dropout
        return t, (t < self.sensor.max_range) & keep

    def render(self, frames: Optional[List[int]] = None):
        """[(points (N, 3) float64, stamps (N,) float64)] on the host, one
        copy from the device for all the frames."""
        frames = list(range(self.n_scans)) if frames is None else list(frames)
        group = max(1, self.GROUP_RAYS // self.rays)
        pts, sts, counts = [], [], []
        for g0 in range(0, len(frames), group):
            t, hit = self.render_rays(frames[g0:g0 + group])
            pts.append((self.dirs_body[None] * t[..., None] + self.offset)[hit])
            sts.append(self.stamps.expand(hit.shape)[hit])
            counts += hit.sum(dim=1).tolist()
        all_pts = torch.cat(pts).cpu().numpy() if pts else np.zeros((0, 3))
        all_sts = torch.cat(sts).cpu().numpy() if sts else np.zeros(0)
        out, start = [], 0
        for n in counts:
            stamps = all_sts[start:start + n] if self.sensor.distort else np.array([])
            out.append((all_pts[start:start + n], stamps))
            start += n
        return out
