"""KISS-ICP odometry in plain PyTorch: the benchmark's reference.

A straightforward implementation of the semantics the configuration states
(KISS-ICP, Vizzo et al., RA-L 2023; reference C++ core `Preprocessing.cpp`,
`VoxelUtils.cpp`, `VoxelHashMap.cpp`, `Registration.cpp`, `Threshold.cpp`),
started from the repository's float64 oracle (`tests/oracle.py`) and
vectorised so that it runs at a deployment's size. It imports nothing of the
program under test and is given only the scans and the configuration.

Where the program fixes a choice the paper leaves open, the reference makes
the same one, so that the two answer the same question:
  * a downsample keeps, per voxel, the point of lowest index, and emits the
    voxels in the order of a fixed integer hash of their key (the order
    decides which voxels a capacity cut drops and which point of the
    frame cloud the second downsample keeps);
  * the map takes at most `group_capacity` candidates of a frame per voxel,
    in index order, each accepted while the voxel holds fewer than
    `max_points_per_voxel` points and none nearer than sqrt(v^2 / P);
  * the correspondence distance is 3 sigma and the Geman-McClure scale
    sigma; the normal equations use lever arms about the initial guess's
    position and the increment is applied about it; the loop stops once
    the increment's norm at the world origin is below the criterion; a
    relative 1e-7 Tikhonov floor, a step capped at norm 10;
  * each pose's rotation is re-orthonormalised (Gram-Schmidt).
The map is a sorted array of voxel keys, not a hash table: no slot layout,
no probe window, no capacity.

`dtype` float64 is the reference. `precision="tf32"` computes every matrix
product on operands rounded to TF32 (10-bit mantissa, round to nearest
even), in float32: the control that the comparison must reject.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# 27 neighbour offsets, own voxel first: each axis in (0, 1, -1) order.
_SHIFTS = [(dx, dy, dz) for dx in (0, 1, -1) for dy in (0, 1, -1) for dz in (0, 1, -1)]
_U32 = 0xFFFFFFFF
_KEY_OFF = 1 << 20

# The configuration's `kiss` keys this reference answers for, as
# "section.key", each with the values it accepts (None: any). The harness
# refuses a configuration that states any other key or value before a run
# (odobench/harness.py `unmodelled`).
MODELS = {
    # Keys whose meaning it implements. The engine options' other values
    # mean what it does not compute: a u16 map, deskew refinement, the
    # ground fit.
    **{f"data.{k}": None for k in ("max_range", "min_range", "deskew")},
    **{f"mapping.{k}": None for k in ("voxel_size", "max_points_per_voxel")},
    **{f"adaptive_threshold.{k}": None
       for k in ("fixed_threshold", "initial_threshold", "min_motion_th")},
    **{f"registration.{k}": None
       for k in ("max_num_iterations", "convergence_criterion", "max_num_threads")},
    **{f"engine.{k}": None for k in ("max_points_per_frame", "frame_capacity",
                                     "source_capacity", "group_capacity")},
    "engine.map_storage": ("f32",),
    "engine.deskew_refine": (0,),
    "engine.deskew_refine_map": (False,),
    "engine.ground_align": (0.0,),
    # Keys that change only the program's layout or speed, not its answers;
    # `nn_mode` "cached" (with its `assoc_*` keys) answers otherwise.
    **{f"engine.{k}": None for k in (
        "map_capacity_log2", "probe_length", "nn_live_capacity_log2", "nn_probe_length",
        "donate_state", "pipeline_chunk", "gn_unroll", "rebase_trigger_voxels", "map_shards",
        "use_pallas")},
    "engine.nn_mode": ("gather27", "pallas_fused", "loop27", "compact", "compact_loop"),
}


@dataclass(frozen=True)
class Params:
    """The configuration's odometry settings (its `kiss` section)."""

    max_range: float = 100.0
    min_range: float = 0.0
    deskew: bool = True
    voxel_size: float = 1.0
    max_points_per_voxel: int = 20
    initial_threshold: float = 2.0
    min_motion_th: float = 0.1
    fixed_threshold: Optional[float] = None
    max_iterations: int = 500
    convergence: float = 1e-4
    max_points_per_frame: int = 131072
    frame_capacity: int = 65536
    source_capacity: int = 8192
    group_capacity: int = 16

    @classmethod
    def from_config(cls, kiss: dict) -> "Params":
        d, m = kiss.get("data", {}), kiss.get("mapping", {})
        a, r, e = (kiss.get("adaptive_threshold", {}), kiss.get("registration", {}),
                   kiss.get("engine", {}))
        max_range = float(d.get("max_range", 100.0))
        voxel = m.get("voxel_size")
        return cls(
            max_range=max_range, min_range=float(d.get("min_range", 0.0)),
            deskew=bool(d.get("deskew", True)),
            voxel_size=float(max_range / 100.0 if voxel is None else voxel),
            max_points_per_voxel=int(m.get("max_points_per_voxel", 20)),
            initial_threshold=float(a.get("initial_threshold", 2.0)),
            min_motion_th=float(a.get("min_motion_th", 0.1)),
            fixed_threshold=(None if a.get("fixed_threshold") is None
                             else float(a["fixed_threshold"])),
            max_iterations=int(r.get("max_num_iterations", 500)),
            convergence=float(r.get("convergence_criterion", 1e-4)),
            max_points_per_frame=int(e.get("max_points_per_frame", 131072)),
            frame_capacity=int(e.get("frame_capacity", 65536)),
            source_capacity=int(e.get("source_capacity", 8192)),
            group_capacity=int(e.get("group_capacity", 16)),
        )


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, nearest even)."""
    bits = x.to(torch.float32).view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x.to(torch.float32))


class Math:
    """Matrix products and SE(3) algebra in one dtype and precision."""

    def __init__(self, dtype=torch.float64, precision: str = "full", device=None):
        if precision not in ("full", "tf32"):
            raise ValueError(f"precision must be 'full' or 'tf32', not {precision!r}")
        self.dtype = torch.float32 if precision == "tf32" else dtype
        self.tf32 = precision == "tf32"
        self.device = torch.device("cpu" if device is None else device)

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return round_tf32(a) @ round_tf32(b)
        return a @ b

    def eye(self, n: int) -> torch.Tensor:
        return torch.eye(n, dtype=self.dtype, device=self.device)

    @staticmethod
    def hat(w: torch.Tensor) -> torch.Tensor:
        z = torch.zeros_like(w[..., 0])
        return torch.stack([z, -w[..., 2], w[..., 1], w[..., 2], z, -w[..., 0],
                            -w[..., 1], w[..., 0], z], dim=-1).view(*w.shape[:-1], 3, 3)

    def exp(self, twist: torch.Tensor) -> torch.Tensor:
        """Twists (..., 6) [v, w] -> poses (..., 4, 4), Rodrigues."""
        v, w = twist[..., :3], twist[..., 3:]
        theta2 = torch.sum(w * w, dim=-1)
        theta = torch.sqrt(theta2)
        small = theta < 1e-6
        safe = torch.where(small, torch.ones_like(theta), theta)
        a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
        b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / safe**2)
        c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (safe - torch.sin(safe)) / safe**3)
        k = self.hat(w)
        k2 = k @ k
        eye = self.eye(3).expand(k.shape)
        rot = eye + a[..., None, None] * k + b[..., None, None] * k2
        vmat = eye + b[..., None, None] * k + c[..., None, None] * k2
        out = self.eye(4).expand(*twist.shape[:-1], 4, 4).clone()
        out[..., :3, :3] = rot
        out[..., :3, 3] = (vmat @ v[..., None])[..., 0]
        return out

    @staticmethod
    def angle(r: torch.Tensor) -> torch.Tensor:
        tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
        skew = 0.5 * torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                                  r[..., 1, 0] - r[..., 0, 1]], dim=-1)
        return torch.atan2(torch.linalg.norm(skew, dim=-1), 0.5 * (tr - 1.0)), skew

    def log(self, pose: torch.Tensor) -> torch.Tensor:
        """Pose (4, 4) -> twist [v, w] (rotations well below pi)."""
        theta, skew = self.angle(pose[:3, :3])
        small = theta < 1e-6
        safe = torch.where(small, torch.ones_like(theta), theta)
        w = skew * torch.where(small, 1.0 + theta**2 / 6.0, safe / torch.sin(safe))
        coeff = torch.where(small, 1.0 / 12.0 + theta**2 / 720.0,
                            (1.0 - safe * torch.sin(safe) / (2.0 * (1.0 - torch.cos(safe))))
                            / safe**2)
        k = self.hat(w)
        vinv = self.eye(3) - 0.5 * k + coeff * (k @ k)
        return torch.cat([(vinv @ pose[:3, 3:])[:, 0], w])

    def inverse(self, pose: torch.Tensor) -> torch.Tensor:
        r, t = pose[..., :3, :3], pose[..., :3, 3:]
        out = self.eye(4).expand(pose.shape).clone()
        rt = r.transpose(-1, -2)
        out[..., :3, :3] = rt
        out[..., :3, 3:] = -self.mm(rt, t)
        return out

    @staticmethod
    def orthonormalize(pose: torch.Tensor) -> torch.Tensor:
        r = pose[:3, :3]
        c0 = r[:, 0] / torch.clamp(torch.linalg.norm(r[:, 0]), min=1e-30)
        c2 = torch.linalg.cross(c0, r[:, 1])
        c2 = c2 / torch.clamp(torch.linalg.norm(c2), min=1e-30)
        c1 = torch.linalg.cross(c2, c0)
        out = pose.clone()
        out[:3, :3] = torch.stack([c0, c1, c2], dim=-1)
        out[3] = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype, device=pose.device)
        return out

    def transform(self, pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        return self.mm(points, pose[:3, :3].T) + pose[:3, 3]

    def model_error(self, deviation: torch.Tensor, max_range: float) -> torch.Tensor:
        """|t| + 2 max_range sin(theta / 2): the adaptive threshold's model
        error, and the gap between two poses in metres at the sensor's
        range."""
        theta, _ = self.angle(deviation[:3, :3])
        return torch.linalg.norm(deviation[:3, 3]) + 2.0 * max_range * torch.sin(theta / 2.0)


def _voxel_hash(x, y, z) -> torch.Tensor:
    """The downsample's emission order: a 32-bit mix of the voxel's packed
    15-bit axis keys (uint32 arithmetic in int64)."""
    off, mask = 1 << 14, (1 << 15) - 1
    hi = (((x + off) & mask) << 15) | ((y + off) & mask)
    lo = (z + off) & mask
    h = ((hi * 0x9E3779B1) & _U32) ^ ((lo * 0x85EBCA77) & _U32)
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _U32
    h = h ^ (h >> 15)
    return torch.where(h == _U32, torch.full_like(h, _U32 - 1), h), (hi << 15) | lo


def downsample(points: torch.Tensor, voxel: float, capacity: int) -> torch.Tensor:
    """One point per voxel (the lowest index), voxels in hash order, the
    first `capacity` of them."""
    if points.shape[0] == 0:
        return points
    c = torch.floor(points / voxel).to(torch.int64)
    inside = torch.all((c >= -(1 << 14)) & (c < (1 << 14)), dim=1)
    points, c = points[inside], c[inside]
    h, key = _voxel_hash(c[:, 0], c[:, 1], c[:, 2])
    order = torch.sort(key, stable=True).indices
    ks = key[order]
    head = torch.ones_like(ks, dtype=torch.bool)
    head[1:] = ks[1:] != ks[:-1]
    first = order[head]  # lowest index of each voxel, voxels in key order
    emit = first[torch.sort(h[first], stable=True).indices]
    return points[emit[:capacity]]


def _pack(c: torch.Tensor) -> torch.Tensor:
    """Sortable int64 key of int64 voxel coords (..., 3)."""
    c = c + _KEY_OFF
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


class VoxelMap:
    """The local map: voxels as a sorted key array with up to P points each."""

    def __init__(self, p: Params, mth: Math):
        self.p, self.m = p, mth
        dev, dt = mth.device, mth.dtype
        self.keys = torch.zeros(0, dtype=torch.int64, device=dev)
        self.pts = torch.zeros((0, p.max_points_per_voxel, 3), dtype=dt, device=dev)
        self.cnt = torch.zeros(0, dtype=torch.int64, device=dev)
        self.shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=dev)

    def empty(self) -> bool:
        return self.keys.numel() == 0

    def _candidates(self, q: torch.Tensor):
        """(slot (S, 27) int64, present (S, 27) bool) of each query's 27
        neighbour voxels."""
        vox = torch.floor(q / self.p.voxel_size).to(torch.int64)
        codes = _pack(vox[:, None, :] + self.shifts[None])
        slot = torch.clamp(torch.searchsorted(self.keys, codes), max=self.keys.numel() - 1)
        return slot, self.keys[slot] == codes

    def nearest(self, q: torch.Tensor):
        """(neighbour (S, 3), distance (S,), slots, present) over the 27
        voxels around each query; ties go to the first (voxel, point)."""
        slot, present = self._candidates(q)
        cand = self.pts[slot]  # (S, 27, P, 3)
        lanes = torch.arange(self.p.max_points_per_voxel, device=q.device)
        usable = (lanes < self.cnt[slot][..., None]) & present[..., None]
        diff = q[:, None, None, :] - cand
        sq = diff * diff
        d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
        d2 = torch.where(usable, d2, torch.full_like(d2, float("inf"))).flatten(1)
        best = torch.argmin(d2, dim=1)
        rows = torch.arange(q.shape[0], device=q.device)
        return cand.flatten(1, 2)[rows, best], torch.sqrt(d2[rows, best]), slot, present

    def insert(self, world: torch.Tensor) -> None:
        p, g = self.p.max_points_per_voxel, self.p.group_capacity
        if world.shape[0] == 0:
            return
        codes = _pack(torch.floor(world / self.p.voxel_size).to(torch.int64))
        order = torch.sort(codes, stable=True).indices
        cs = codes[order]
        head = torch.ones_like(cs, dtype=torch.bool)
        head[1:] = cs[1:] != cs[:-1]
        gid = torch.cumsum(head.to(torch.int64), 0) - 1
        pos = torch.arange(cs.numel(), device=cs.device)
        start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)), 0).values
        rank = pos - start
        n_groups = int(gid[-1]) + 1
        gkeys = cs[head]
        cand = torch.zeros((n_groups, g, 3), dtype=world.dtype, device=world.device)
        ok = torch.zeros((n_groups, g), dtype=torch.bool, device=world.device)
        keep = rank < g
        cand[gid[keep], rank[keep]] = world[order[keep]]
        ok[gid[keep], rank[keep]] = True

        # New voxels join the sorted key array.
        if self.keys.numel():
            at = torch.clamp(torch.searchsorted(self.keys, gkeys), max=self.keys.numel() - 1)
            new = self.keys[at] != gkeys
        else:
            new = torch.ones_like(gkeys, dtype=torch.bool)
        if bool(new.any()):
            keys = torch.cat([self.keys, gkeys[new]])
            srt = torch.sort(keys).indices
            self.keys = keys[srt]
            n_new = int(new.sum())
            self.pts = torch.cat([self.pts, self.pts.new_zeros((n_new, p, 3))])[srt]
            self.cnt = torch.cat([self.cnt, self.cnt.new_zeros(n_new)])[srt]
        slot = torch.searchsorted(self.keys, gkeys)

        stored, cnt = self.pts[slot], self.cnt[slot]
        res_sq = self.p.voxel_size ** 2 / p
        lanes = torch.arange(p, device=world.device)
        for j in range(g):
            c = cand[:, j]
            diff = stored - c[:, None, :]
            sq = diff * diff
            d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
            d2 = torch.where(lanes < cnt[:, None], d2, torch.full_like(d2, float("inf")))
            accept = ok[:, j] & (cnt < p) & (torch.amin(d2, dim=1) >= res_sq)
            write = (lanes == cnt[:, None]) & accept[:, None]
            stored = torch.where(write[..., None], c[:, None, :], stored)
            cnt = cnt + accept.to(cnt.dtype)
        self.pts[slot] = stored
        self.cnt[slot] = cnt

    def trim(self, origin: torch.Tensor) -> None:
        """Drop voxels whose first point is max_range or farther."""
        d = self.pts[:, 0] - origin
        keep = torch.sum(d * d, dim=1) < self.p.max_range ** 2
        self.keys, self.pts, self.cnt = self.keys[keep], self.pts[keep], self.cnt[keep]


class Odometry:
    """KISS-ICP over host scans. `step(points, stamps)` registers a frame
    and returns its pose; `step(..., pose=P, register=False)` only takes the
    frame into the map at the pose given (following another system's
    trajectory)."""

    def __init__(self, p: Params, mth: Math, record_work: bool = False):
        self.p, self.m = p, mth
        self.map = VoxelMap(p, mth)
        self.pose = mth.eye(4)
        self.delta = mth.eye(4)
        self.model_sse = p.initial_threshold ** 2
        self.num_samples = 1
        self.record_work = record_work

    def sigma(self) -> float:
        if self.p.fixed_threshold is not None:
            return float(self.p.fixed_threshold)
        return math.sqrt(self.model_sse / self.num_samples)

    def clouds(self, points: np.ndarray, stamps: np.ndarray):
        """(frame cloud, ICP source) of a host scan, deskewed with the
        constant-velocity motion."""
        p, mth = self.p, self.m
        n = points.shape[0]
        if n > p.max_points_per_frame:
            sel = np.linspace(0, n - 1, p.max_points_per_frame).astype(np.int64)
            points = points[sel]
            stamps = stamps[sel] if len(stamps) == n else stamps
        pts = mth.tensor(points[:, :3])
        if p.deskew and len(stamps) == pts.shape[0] and pts.shape[0]:
            st = mth.tensor(stamps)
            span = st.max() - st.min()
            if float(span) > 0:
                s01 = (st - st.min()) / span
                poses = mth.exp((s01 - 1.0)[:, None] * mth.log(self.delta)[None, :])
                pts = self.m.mm(poses[:, :3, :3], pts[:, :, None])[:, :, 0] + poses[:, :3, 3]
        rng = torch.linalg.norm(pts, dim=1)
        pts = pts[(rng < p.max_range) & (rng > p.min_range)]
        frame = downsample(pts, p.voxel_size * 0.5, p.frame_capacity)
        source = downsample(frame, p.voxel_size * 1.5, p.source_capacity)
        return frame, source

    def register(self, source: torch.Tensor, guess: torch.Tensor, sigma: float):
        """(pose, iterations, [work of each iteration]) of robust ICP."""
        mth, p = self.m, self.p
        if self.map.empty():
            return guess, 0, []
        center = guess[:3, 3]
        src = mth.transform(guess, source)
        t_icp = mth.eye(4)
        max_dist, k = 3.0 * sigma, sigma
        eye3 = mth.eye(3).expand(src.shape[0], 3, 3)
        works = []
        it = 0
        while it < p.max_iterations:
            nn, dist, slot, present = self.map.nearest(src)
            corr = torch.isfinite(dist) & (dist < max_dist)
            if self.record_work:
                works.append(self._work(slot, present, corr))
            s, r = src[corr] - center, src[corr] - nn[corr]
            w = (k * k) / (k + torch.sum(r * r, dim=1)) ** 2
            jac = torch.cat([eye3[:s.shape[0]], -Math.hat(s)], dim=2)  # (n, 3, 6)
            wjac = (jac * w[:, None, None]).reshape(-1, 6)
            jtj = mth.mm(wjac.T, jac.reshape(-1, 6))
            jtr = mth.mm(wjac.T, r.reshape(-1, 1))[:, 0]
            scale = torch.max(torch.abs(torch.diagonal(jtj)))
            eps = scale * 1e-7 if float(scale) > 0 else 1.0
            dx = torch.linalg.solve(jtj + eps * mth.eye(6), -jtr)
            if not bool(torch.all(torch.isfinite(dx))) or int(corr.sum()) == 0:
                dx = torch.zeros_like(dx)
            norm = float(torch.linalg.norm(dx))
            if norm > 10.0:
                dx = dx * (10.0 / norm)
            est = mth.exp(dx)
            est[:3, 3] += center - mth.mm(est[:3, :3], center[:, None])[:, 0]
            src = mth.transform(est, src)
            t_icp = mth.mm(est, t_icp)
            v_world = dx[:3] - torch.linalg.cross(dx[3:], center)
            step = math.sqrt(float(torch.sum(v_world ** 2) + torch.sum(dx[3:] ** 2)))
            it += 1
            if step < p.convergence:
                break
        pose = mth.mm(t_icp, guess)
        if not bool(torch.all(torch.isfinite(pose))):
            return guess, it, works
        return Math.orthonormalize(pose), it, works

    def _work(self, slot, present, corr) -> dict:
        """What one K2 query and one K1 build need, counted from the inputs
        (odobench/work.py): queries, the distinct occupied voxels of their
        neighbourhoods and those voxels' points, the candidate points each
        query scores, the correspondences."""
        used = torch.unique(slot[present])
        return {"queries": int(slot.shape[0]), "voxels": int(used.numel()),
                "voxel_points": int(self.map.cnt[used].sum()),
                "candidates": int(torch.where(present, self.map.cnt[slot],
                                              torch.zeros_like(slot)).sum()),
                "correspondences": int(corr.sum())}

    def step(self, points: np.ndarray, stamps: np.ndarray, *, pose: Optional[np.ndarray] = None,
             register: bool = True):
        """Advance one frame. Returns (pose registered or None, iterations,
        work records)."""
        mth = self.m
        frame, source = self.clouds(points, stamps)
        guess = mth.mm(self.pose, self.delta)
        sigma = self.sigma()
        found, iters, works = None, 0, []
        if register:
            found, iters, works = self.register(source, guess, sigma)
        new = mth.tensor(pose) if pose is not None else found
        deviation = mth.mm(mth.inverse(guess), new)
        err = float(mth.model_error(deviation, self.p.max_range))
        if not math.isfinite(err):
            err = 1e3
        err = min(err, 1e3)
        if err > self.p.min_motion_th:
            self.model_sse += err * err
            self.num_samples += 1
        self.map.insert(mth.transform(new, frame))
        self.map.trim(new[:3, 3])
        self.delta = mth.mm(mth.inverse(self.pose), new)
        self.pose = new
        return found, iters, works


def follow(p: Params, scans, poses: np.ndarray, check: List[int], device=None,
           record_work: bool = False) -> Dict[int, Tuple[np.ndarray, int, list]]:
    """Follow a trajectory from its first frame: each frame goes into the
    map at the pose given, and the frames in `check` are registered first,
    from the constant-velocity guess of the poses before them. Returns
    {frame: (registered pose, iterations, work)} in float64."""
    mth = Math(torch.float64, "full", device)
    odo = Odometry(p, mth, record_work=record_work)
    want = set(check)
    out = {}
    for k in range(max(want) + 1 if want else 0):
        pts, stamps = scans[k]
        found, iters, works = odo.step(pts, stamps, pose=poses[k], register=k in want)
        if k in want:
            out[k] = (found.cpu().numpy(), iters, works)
    return out


def pose_gap(p: Params, a: np.ndarray, b: np.ndarray) -> float:
    """Model error between two poses, in metres (float64)."""
    mth = Math(torch.float64)
    dev = mth.mm(mth.inverse(mth.tensor(a)), mth.tensor(b))
    return float(mth.model_error(dev, p.max_range))
