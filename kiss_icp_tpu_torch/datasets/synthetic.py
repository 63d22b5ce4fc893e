"""Procedural synthetic LiDAR sequences (no file dependencies).

No analog in the reference. A copy of `kiss_icp_tpu/datasets/synthetic.py`
(pure numpy), so the port can be driven without importing the JAX package:
it simulates a spinning multi-beam LiDAR moving through a procedurally
generated world (buildings + ground), with exact ground-truth poses and
per-point azimuth timestamps, so the full pipeline (deskew, ICP, metrics)
runs end-to-end without datasets on disk. Used by chip_smoke.py and the
port's tests.

The simulation is rolling-shutter correct: each azimuth column is raycast from
the sensor pose at that instant (constant-velocity interpolation along the
trajectory), and points are reported in the body frame at their capture time —
exactly the distortion the deskewing step (reference Preprocessing.cpp:58-84)
exists to undo. `gt_poses[i]` is the END-of-scan pose of scan i, matching the
deskew-toward-scan-end convention `exp((t-1)*omega)`.
"""

from __future__ import annotations

import numpy as np


def _hat(w):
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])


def _se3_log(t):
    """4x4 -> twist [v, w] (closed form, small-angle safe)."""
    r = t[:3, :3]
    cos_theta = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    skew = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    if theta < 1e-8:
        w = skew / 2.0
        v_inv = np.eye(3)
    elif theta > np.pi - 1e-4:
        # Near pi the skew vector vanishes (sin(theta) -> 0) and the generic
        # formula loses the axis entirely; recover it from the symmetric
        # part: R = I + 2 hat(u)^2 at theta = pi, so u^2 from the diagonal
        # and signs from the off-diagonals.
        a = np.sqrt(np.maximum(np.diag((r + np.eye(3)) / 2.0), 0.0))
        # Fix relative signs from the largest component.
        k = int(np.argmax(a))
        signs = np.ones(3)
        for j in range(3):
            if j != k and a[j] > 1e-8:
                signs[j] = np.sign((r[k, j] + r[j, k]) / 2.0)
        u = a * signs
        u /= max(np.linalg.norm(u), 1e-12)
        w = theta * u
        half = theta / 2.0
        coeff = (1.0 - half * np.cos(half) / np.sin(half)) / (theta * theta)
        v_inv = np.eye(3) - 0.5 * _hat(w) + coeff * (_hat(w) @ _hat(w))
    else:
        w = theta / (2.0 * np.sin(theta)) * skew
        half = theta / 2.0
        coeff = (1.0 - half * np.cos(half) / np.sin(half)) / (theta * theta)
        v_inv = np.eye(3) - 0.5 * _hat(w) + coeff * (_hat(w) @ _hat(w))
    v = v_inv @ t[:3, 3]
    return np.concatenate([v, w])


def _se3_exp_batch(twist: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """exp(scale_k * twist) for many scalar scales -> (K, 4, 4) (Rodrigues)."""
    tw = scales[:, None] * twist[None, :]
    v, w = tw[:, :3], tw[:, 3:]
    theta = np.linalg.norm(w, axis=1)
    k = np.zeros((len(tw), 3, 3))
    k[:, 0, 1], k[:, 0, 2] = -w[:, 2], w[:, 1]
    k[:, 1, 0], k[:, 1, 2] = w[:, 2], -w[:, 0]
    k[:, 2, 0], k[:, 2, 1] = -w[:, 1], w[:, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        a = np.where(theta > 1e-8, np.sin(theta) / theta, 1.0 - theta**2 / 6)
        b = np.where(theta > 1e-8, (1 - np.cos(theta)) / theta**2, 0.5)
        c = np.where(theta > 1e-8, (1 - a) / theta**2, 1.0 / 6.0)
    k2 = k @ k
    eye = np.tile(np.eye(3), (len(tw), 1, 1))
    rot = eye + a[:, None, None] * k + b[:, None, None] * k2
    vmat = eye + b[:, None, None] * k + c[:, None, None] * k2
    out = np.tile(np.eye(4), (len(tw), 1, 1))
    out[:, :3, :3] = rot
    out[:, :3, 3] = np.einsum("kij,kj->ki", vmat, v)
    return out


def _terrain_height(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Gentle terrain height field (slopes < ~0.1). A perfectly flat plane
    would let the scan's ground rings re-match themselves at zero motion and
    cancel the walls' pull ("ring lock") — real roads always have crown,
    curvature, and texture, and this models that."""
    return (
        0.4 * np.sin(0.09 * x) * np.cos(0.075 * y)
        + 0.25 * np.sin(0.031 * x + 1.0)
        + 0.2 * np.cos(0.043 * y + 2.0)
        # Fine-scale roughness (asphalt/grass): breaks the coherence of the
        # scan's ground rings, which on smooth ground drag the estimate back
        # toward zero motion by ~half the ground mass.
        + 0.08 * np.sin(0.9 * x) * np.sin(0.83 * y + 0.5)
        + 0.05 * np.cos(1.7 * x + 0.3) * np.sin(1.3 * y)
        + 0.12 * np.sin(0.45 * x + 0.7) * np.cos(0.4 * y)
        + 0.06 * np.sin(2.2 * x + 1.1) * np.cos(1.9 * y + 0.4)
    )


def _make_world(rng: np.random.Generator, trajectory_xy: np.ndarray):
    """Stratified scattered-structure world: every stretch of the path gets
    buildings on both sides plus poles and car-sized clutter, so there is no
    featureless stretch anywhere along the drive.

    Random (non-stratified) anchoring leaves occasional 10-20 m gaps with only
    ground in view; there, scan ground rings can alias onto the previous
    frame's rings one spacing over and launch the constant-velocity feedback
    into a runaway — a real point-to-point ICP failure mode that real urban
    data never triggers because structure is continuous. The float64 oracle of
    the reference algorithm (tests/oracle.py) is the tracking yardstick for
    these scenes."""
    deltas = np.diff(trajectory_xy, axis=0)
    seg_len = np.linalg.norm(deltas, axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = float(arc[-1])

    def frame_at(s):
        """(position, unit tangent, unit left-normal) at arc length s."""
        if len(deltas) == 0 or total < 1e-9:
            return trajectory_xy[0], np.array([1.0, 0.0]), np.array([0.0, 1.0])
        sc = float(np.clip(s, 0.0, total - 1e-9))
        i = int(np.clip(np.searchsorted(arc, sc) - 1, 0, len(deltas) - 1))
        t = deltas[i] / max(seg_len[i], 1e-9)
        frac = (sc - arc[i]) / max(seg_len[i], 1e-9)
        pos = trajectory_xy[i] + frac * deltas[i] + (s - sc) * t
        return pos, t, np.array([-t[1], t[0]])

    boxes = []

    def _box(c, half, h, sink):
        z0 = _terrain_height(np.array([c[0]]), np.array([c[1]]))[0]
        boxes.append(
            (
                np.array([c[0] - half[0], c[1] - half[1], z0 - sink]),
                np.array([c[0] + half[0], c[1] + half[1], z0 + h]),
            )
        )

    # Buildings: one per side per ~9 m of path (padded 40 m past both ends),
    # 12-30 m lateral, jittered along-path so facades overlap into broken
    # rows with corners everywhere.
    s = -40.0
    while s < total + 40.0:
        for side in (-1.0, 1.0):
            pos, tang, norm = frame_at(s + rng.uniform(-3.0, 3.0))
            lateral = rng.uniform(8.0, 20.0)
            half = rng.uniform(4.0, 10.0, 2)
            c = pos + side * (lateral + float(np.max(half))) * norm
            _box(c, half, rng.uniform(4.0, 18.0), sink=1.0)
        s += 6.0

    # Poles every ~5 m, alternating sides, 4-8 m lateral.
    s, side = rng.uniform(0.0, 5.0), 1.0
    while s < total:
        pos, tang, norm = frame_at(s)
        c = pos + side * rng.uniform(4.0, 8.0) * norm
        _box(c, rng.uniform(0.1, 0.3, 2), rng.uniform(2.5, 5.0), sink=0.5)
        side = -side
        s += rng.uniform(3.0, 5.0)

    # Parked cars / bushes every ~7 m, random side, 3-6 m lateral.
    s = rng.uniform(0.0, 7.0)
    while s < total:
        pos, tang, norm = frame_at(s)
        side = rng.choice([-1.0, 1.0])
        c = pos + side * rng.uniform(3.0, 6.0) * norm
        ext = np.abs(tang) * rng.uniform(1.0, 2.4) + np.abs(norm) * rng.uniform(0.7, 1.1)
        _box(c, ext, rng.uniform(1.2, 1.9), sink=0.2)
        s += rng.uniform(4.0, 6.0)

    # Curbs: segmented low walls at +-3.5 m lateral, and verge clutter (grass
    # tufts / curb debris) every 1-2 m at 2.5-8 m lateral. These break the
    # coherence of the scan's ground rings exactly in the radius band where
    # ring spacing matches the per-frame motion — on smooth open ground there,
    # consecutive scans' rings alias onto each other one spacing over and
    # point-to-point ICP locks onto the shifted match.
    for side in (-1.0, 1.0):
        s = -10.0
        while s < total + 10.0:
            seg = rng.uniform(2.0, 4.0)
            pos, tang, norm = frame_at(s + seg / 2.0)
            c = pos + side * 3.5 * norm
            ext = np.abs(tang) * (seg / 2.0) + np.abs(norm) * 0.15
            _box(c, ext, rng.uniform(0.1, 0.18), sink=0.3)
            s += seg + rng.uniform(0.0, 0.6)
    s = 0.0
    while s < total:
        pos, tang, norm = frame_at(s)
        side = rng.choice([-1.0, 1.0])
        c = pos + side * rng.uniform(2.5, 8.0) * norm + tang * rng.uniform(-1.0, 1.0)
        _box(c, rng.uniform(0.12, 0.45, 2), rng.uniform(0.15, 0.7), sink=0.2)
        s += rng.uniform(1.0, 2.0)

    return boxes


class SyntheticDataset:
    """Spinning LiDAR through a procedural city block, motion-distorted.

    `data_dir` is ignored (factory compatibility); `sequence` seeds world and
    trajectory. `distort=False` renders idealized static snapshots with no
    per-point timestamps (like KITTI odometry's pre-deskewed scans).
    """

    def __init__(
        self,
        data_dir=None,
        sequence=0,
        *_,
        n_scans: int = 100,
        n_beams: int = 64,
        n_azimuth: int = 1024,
        max_range: float = 100.0,
        speed: float = 1.0,
        accel_frames: int = 10,
        turn_rate: float = 0.02,
        distort: bool = True,
        noise: float = 0.01,
        dropout: float = 0.2,
        **__,
    ):
        seq = int(sequence) if str(sequence).isdigit() else 0
        self.sequence_id = f"synthetic_{seq:02d}"
        self._n_scans = n_scans
        self._n_beams = n_beams
        self._n_azimuth = n_azimuth
        self._max_range = max_range
        self._distort = distort
        self._noise = noise
        self._dropout = float(dropout)
        rng = np.random.default_rng(1234 + seq)
        self._noise_seed = 5678 + seq

        # Smooth wandering trajectory; gt_poses[i] = END-of-scan-i pose.
        # The vehicle accelerates from standstill (like every real benchmark
        # sequence): voxel-hash NN search reaches only adjacent voxels, so a
        # cold-start jump of a full cruise-speed frame could never latch —
        # in the reference either (VoxelHashMap.cpp:46-70 neighborhood).
        self.gt_poses = np.tile(np.eye(4), (n_scans, 1, 1))
        pose = np.eye(4)
        heading = 0.0
        for i in range(n_scans):
            self.gt_poses[i] = pose
            v = speed * min(1.0, (i + 1) / max(accel_frames, 1))
            heading_rate = turn_rate * np.sin(i * 0.05) * (v / max(speed, 1e-9))
            heading += heading_rate
            yaw = np.array(
                [
                    [np.cos(heading_rate), -np.sin(heading_rate), 0],
                    [np.sin(heading_rate), np.cos(heading_rate), 0],
                    [0, 0, 1],
                ]
            )
            step = np.array([v * np.cos(heading), v * np.sin(heading), 0.0])
            new_pose = pose.copy()
            new_pose[:3, :3] = pose[:3, :3] @ yaw
            new_pose[:3, 3] = pose[:3, 3] + step
            pose = new_pose
        # Suspension-induced attitude vibration: smooth (AR(1)) pitch/roll of
        # a few tenths of a degree plus cm-level heave, scaled by speed. Real
        # vehicles always have it, and it radially scrambles the scan's ground
        # rings frame to frame (delta_r ~ r^2 * delta_pitch / h ~ 0.5 m at
        # 15 m) — without it, perfectly repeatable rings lock/alias ICP in a
        # way no real dataset does.
        # Vehicle follows the terrain height FIRST (z is assigned wholesale
        # from the xy track), THEN the suspension adds its perturbation on
        # top — the previous order silently overwrote the heave (round-3
        # review finding), so the cm-level z-excitation the comment above
        # promises never reached the rendered scans.
        xy = self.gt_poses[:, :2, 3]
        self.gt_poses[:, 2, 3] = _terrain_height(xy[:, 0], xy[:, 1])
        ar, state = 0.6, np.zeros(3)  # [pitch, roll, heave]
        for i in range(n_scans):
            vfrac = min(1.0, (i + 1) / max(accel_frames, 1))
            state = ar * state + rng.normal(0.0, [0.004, 0.003, 0.015], 3) * vfrac
            cp, sp = np.cos(state[0]), np.sin(state[0])
            cr, sr = np.cos(state[1]), np.sin(state[1])
            r_pitch = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            r_roll = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
            self.gt_poses[i, :3, :3] = self.gt_poses[i, :3, :3] @ (r_pitch @ r_roll)
            self.gt_poses[i, 2, 3] += state[2]
        # Rendering uses the world-frame poses; the exposed gt_poses are
        # re-based to the first pose (every reference loader does the same,
        # e.g. mulran.py:80-81).
        self._render_poses = self.gt_poses
        self.gt_poses = np.linalg.inv(self._render_poses[0]) @ self._render_poses

        self._boxes = _make_world(rng, trajectory_xy=xy)

        # Precompute the body-frame ray directions (beams x azimuth).
        az = np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)
        elev = np.deg2rad(np.linspace(-24.0, 2.0, n_beams))
        az_g, el_g = np.meshgrid(az, elev)
        az_f, el_f = az_g.ravel(), el_g.ravel()
        self._dirs_body = np.stack(
            [np.cos(el_f) * np.cos(az_f), np.cos(el_f) * np.sin(az_f), np.sin(el_f)],
            axis=1,
        )
        self._stamps = az_f / (2 * np.pi)  # azimuth time in [0, 1)

    def __len__(self):
        return self._n_scans

    def _raycast(self, origins: np.ndarray, dirs: np.ndarray):
        """Per-ray (range, hit_is_ground) against terrain + building AABBs."""
        n = dirs.shape[0]
        t_hit = np.full(n, self._max_range + 1.0)

        # Terrain: fixed-point iteration of o_z + t d_z = h(o_xy + t d_xy);
        # converges in a few steps for |grad h| << |d_z/d_xy| slopes.
        dz = dirs[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_ground = (_terrain_height(origins[:, 0], origins[:, 1]) - origins[:, 2]) / dz
            for _ in range(6):
                gx = origins[:, 0] + t_ground * dirs[:, 0]
                gy = origins[:, 1] + t_ground * dirs[:, 1]
                t_ground = (_terrain_height(gx, gy) - origins[:, 2]) / dz
        ok = (dz < -1e-6) & (t_ground > 0.1) & np.isfinite(t_ground)
        t_hit = np.where(ok, np.minimum(t_hit, t_ground), t_hit)
        ground_t = np.where(ok, t_ground, np.inf)

        # Distance-cull the world: only boxes whose AABB comes within
        # max_range (+ margin for intra-scan origin spread, relief, and
        # noise tails) of the scan can contribute an ACCEPTED hit
        # (t < max_range). World size grows with trajectory length, the
        # visible set does not — this keeps per-frame render cost flat
        # instead of O(total boxes).
        o0 = origins[0]
        reach = self._max_range + 8.0
        for lo, hi in self._boxes:
            nearest = np.maximum(lo, np.minimum(o0, hi))
            if np.linalg.norm(nearest - o0) > reach:
                continue
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (lo[None, :] - origins) / dirs
                t2 = (hi[None, :] - origins) / dirs
            tmin = np.nanmax(np.minimum(t1, t2), axis=1)
            tmax = np.nanmin(np.maximum(t1, t2), axis=1)
            hit = (tmax >= tmin) & (tmin > 0.1)
            t_hit = np.where(hit, np.minimum(t_hit, tmin), t_hit)
        return t_hit, t_hit >= ground_t - 1e-9

    def _poses_during_scan(self, idx: int) -> np.ndarray:
        """Sensor pose at each azimuth stamp: T_i @ exp((t-1) * log(delta))."""
        t_end = self._render_poses[idx]
        if idx == 0 or not self._distort:
            return np.tile(t_end, (len(self._stamps), 1, 1))
        delta = np.linalg.inv(self._render_poses[idx - 1]) @ t_end
        omega = _se3_log(delta)
        local = _se3_exp_batch(omega, self._stamps - 1.0)
        return t_end[None, :, :] @ local

    def __getitem__(self, idx):
        poses = self._poses_during_scan(idx)  # (R, 4, 4) world_T_body(t)
        sensor_off = np.array([0.0, 0.0, 1.8])
        origins = poses[:, :3, 3] + poses[:, :3, :3] @ sensor_off
        dirs_world = np.einsum("rij,rj->ri", poses[:, :3, :3], self._dirs_body)

        t, on_ground = self._raycast(origins, dirs_world)
        # World-anchored surface micro-relief: real facades, cars, and roads
        # carry decimeter-scale geometric texture (bricks, frames, trim) that
        # is FIXED in the world and re-observed identically from every pose.
        # Perfectly smooth boxes/planes are sliding-ambiguous along their
        # faces, which no real surface is; this texture is what lets ICP lock
        # all 6 DoF the way it does on real data.
        hit_pt = origins + t[:, None] * dirs_world
        relief = (
            0.12 * np.sin(3.1 * hit_pt[:, 0]) * np.sin(2.7 * hit_pt[:, 1])
            * np.sin(2.3 * hit_pt[:, 2] + 0.7)
            + 0.06 * np.sin(7.3 * hit_pt[:, 0] + 1.3) * np.sin(6.1 * hit_pt[:, 2])
        )
        t = t + np.where(on_ground, 0.4 * relief, relief)
        rng = np.random.default_rng(self._noise_seed + idx)
        # Range noise grows with grazing incidence: a ground return at range r
        # from sensor height h has an along-ray footprint ~ r/h times the
        # surface roughness, so distant ground rings are several cm fuzzy on
        # real roads. This decorrelates consecutive scans' ground rings in the
        # radius band where ring spacing matches per-frame motion (otherwise
        # rings alias one spacing over and drag/launch the estimate).
        grazing = np.where(on_ground, np.minimum(np.abs(t) / 1.8, 25.0), 1.0)
        t = t + rng.normal(0.0, 1.0, size=t.shape) * self._noise * grazing
        # Real sensors drop 10-30% of returns (absorption, specular surfaces).
        keep = rng.random(t.shape) > self._dropout
        hit = (t < self._max_range) & keep

        # Report each point in the BODY frame at its capture time, sensor
        # offset included — exactly what a real driver outputs.
        points_body = self._dirs_body[hit] * t[hit, None] + sensor_off
        if not self._distort:
            return points_body.astype(np.float64), np.array([])
        return points_body.astype(np.float64), self._stamps[hit].astype(np.float64)
