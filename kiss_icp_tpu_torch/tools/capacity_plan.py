"""Capacity planner: size the engine's static shapes from dataset statistics.

Port of the JAX package's `tools/capacity_plan.py`: host-side numpy with the
pipeline's voxel semantics (floor(p/v) keys, ops/voxel.py; the 0.5 x / 1.5 x
double downsample of odometry.register_frame), so the same frames give the
same plan in both packages. The reference never plans capacity (its
containers grow on demand); the port, like the JAX package, pads every
buffer to a fixed capacity, and every padded row of the ICP source pays the
27-voxel query in each Gauss-Newton iteration, while an undersized buffer
drops voxels (counted, surfaced by the pipeline's overflow warnings). This
tool measures what the scans occupy and recommends power-of-two capacities
with explicit headroom:

    python -m kiss_icp_tpu_torch.tools.capacity_plan <data> --dataloader kitti \
        --sequence 0 [--samples 16] [--headroom 1.5] [--config cfg.yaml]

Library API: ``measure_frames`` + ``plan`` + ``plan_for_dataset``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np


def assoc_bytes_per_iteration(source_capacity: int, max_points_per_voxel: int,
                              probe_length: int, map_storage: str) -> int:
    """The naive memory traffic of ONE Gauss-Newton iteration's exact-NN
    association: per source row and each of its 27 neighbour voxels, the
    point-row slab, the bucket-aligned fingerprint probe window and the
    count word (the JAX package's model, kept so that both plans agree; the
    port's K2 reads only the present rows' points, so it needs less)."""
    row_bytes = 6 if str(map_storage) == "u16" else 12
    return source_capacity * 27 * (
        max_points_per_voxel * row_bytes + probe_length * 4 + 4)


def _unique_voxel_count(points: np.ndarray, voxel_size: float) -> int:
    if len(points) == 0:
        return 0
    keys = np.floor(points / voxel_size).astype(np.int64)
    return len(np.unique(keys, axis=0))


def _downsample_first_wins(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """First-point-wins voxel filter (lowest original index per voxel),
    matching ops/voxel.voxel_downsample's deterministic semantics and the
    reference's order-dependent VoxelDownsample (VoxelUtils.cpp:7-21)."""
    if len(points) == 0:
        return points
    keys = np.floor(points / voxel_size).astype(np.int64)
    # np.unique picks the first occurrence index per key only after a stable
    # sort; return_index gives the first occurrence in the original order.
    _, first = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(first)]


@dataclass
class FrameStats:
    """Per-frame occupancy measurements (all counts, not capacities)."""

    raw: int  # points as delivered by the loader
    cropped: int  # after min/max-range crop (finite points only)
    frame_ds: int  # voxels at 0.5 * voxel_size (the map-insert cloud)
    source_ds: int  # voxels at 1.5 * voxel_size (the ICP source)


@dataclass
class Plan:
    """Recommended engine capacities + the evidence they rest on."""

    max_points_per_frame: int
    frame_capacity: int
    source_capacity: int
    map_capacity_log2: Optional[int]  # None when no GT poses were available
    headroom: float
    stats: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "max_points_per_frame": self.max_points_per_frame,
            "frame_capacity": self.frame_capacity,
            "source_capacity": self.source_capacity,
            "map_capacity_log2": self.map_capacity_log2,
            "headroom": self.headroom,
            "stats": self.stats,
        }


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, n))))


def measure_frames(
    frames: Iterable[np.ndarray],
    voxel_size: float,
    min_range: float,
    max_range: float,
) -> list:
    """Measure occupancy for each frame with the pipeline's crop and
    double-downsample semantics. ``frames`` yields (N, 3) arrays."""
    out = []
    for pts in frames:
        pts = np.asarray(pts, np.float64).reshape(-1, 3)
        raw = len(pts)
        finite = np.isfinite(pts).all(axis=1)
        pts = pts[finite]
        r = np.linalg.norm(pts, axis=1)
        pts = pts[(r > min_range) & (r < max_range)]
        frame_cloud = _downsample_first_wins(pts, 0.5 * voxel_size)
        out.append(FrameStats(
            raw=raw,
            cropped=len(pts),
            frame_ds=len(frame_cloud),
            source_ds=_unique_voxel_count(frame_cloud, 1.5 * voxel_size),
        ))
    return out


def estimate_map_voxels(
    frames: Sequence[np.ndarray],
    poses: Sequence[np.ndarray],
    voxel_size: float,
    min_range: float,
    max_range: float,
) -> int:
    """LOWER BOUND on steady-state local-map voxel occupancy: unique
    world-frame voxels (at the map's 1.0 * voxel_size) of the sampled
    frames' map-insert clouds, trimmed to ``max_range`` of the LAST
    sampled pose — the same trailing-window semantics as VoxelHashMap trim
    (hash_map.py, reference VoxelHashMap.cpp:121-132). The live map also
    accumulates voxels from the unsampled frames in the window, so
    ``plan`` applies a coverage margin on top of this number."""
    world = []
    for pts, pose in zip(frames, poses):
        pts = np.asarray(pts, np.float64).reshape(-1, 3)
        pts = pts[np.isfinite(pts).all(axis=1)]
        r = np.linalg.norm(pts, axis=1)
        pts = pts[(r > min_range) & (r < max_range)]
        pts = _downsample_first_wins(pts, 0.5 * voxel_size)
        world.append(pts @ np.asarray(pose)[:3, :3].T + np.asarray(pose)[:3, 3])
    if not world:
        return 0
    allpts = np.concatenate(world, axis=0)
    origin = np.asarray(poses[-1])[:3, 3]
    allpts = allpts[np.linalg.norm(allpts - origin, axis=1) < max_range]
    return _unique_voxel_count(allpts, voxel_size)


def plan(
    stats: Sequence[FrameStats],
    headroom: float = 1.5,
    map_voxels: Optional[int] = None,
    max_points_per_voxel: int = 20,
    probe_length: int = 16,
    map_storage: str = "f32",
) -> Plan:
    """Turn measured occupancies into power-of-two capacities.

    Capacities cover the MAX observed occupancy times ``headroom`` (not a
    percentile: a single over-capacity frame drops voxels, which the
    pipeline surfaces as a warning but which changes results). The map
    table is open-addressed with bucket-aligned probe windows
    (ops/hash_map.py), so its capacity targets a <= 0.25 load factor —
    beyond that, probe-window overflow drops become likely."""
    if not stats:
        raise ValueError("no frames measured")
    raw = max(s.raw for s in stats)
    cropped = max(s.cropped for s in stats)
    frame_ds = max(s.frame_ds for s in stats)
    source_ds = max(s.source_ds for s in stats)

    map_log2 = None
    if map_voxels:
        # `map_voxels` is a LOWER bound: it unions only the sampled frames'
        # clouds, while the live map accumulates every frame in the
        # trailing max_range window (parallax keeps adding voxels between
        # samples). Size for <= 0.25 load on TWICE the bound — the 2x
        # window-coverage margin absorbs the frames the sample missed; the
        # pipeline's dropped-voxel counters surface any residual shortfall
        # loudly at runtime.
        map_log2 = max(10, math.ceil(math.log2(map_voxels * 2.0 * 4.0)))

    src_cap = _pow2_at_least(int(source_ds * headroom))
    return Plan(
        max_points_per_frame=_pow2_at_least(int(raw * headroom)),
        frame_capacity=_pow2_at_least(int(frame_ds * headroom)),
        source_capacity=src_cap,
        map_capacity_log2=map_log2,
        headroom=headroom,
        stats={
            "frames_sampled": len(stats),
            "raw_max": raw,
            "cropped_max": cropped,
            "frame_ds_max": frame_ds,
            "source_ds_max": source_ds,
            "source_ds_p50": int(np.median([s.source_ds for s in stats])),
            "map_voxels_est": map_voxels,
            "assoc_bytes_per_iteration": assoc_bytes_per_iteration(
                src_cap, max_points_per_voxel, probe_length, map_storage),
        },
    )


def plan_for_dataset(dataset, cfg, samples: int = 16,
                     headroom: float = 1.5) -> Plan:
    """Sample ``samples`` frames evenly from a dataset object (the loaders'
    (points, stamps) contract) and plan against ``cfg``'s data/mapping
    parameters. Uses GT poses for the map estimate when the loader has
    them."""
    n = len(dataset)
    idxs = sorted(set(np.linspace(0, n - 1, min(samples, n)).astype(int)))
    frames = []
    for i in idxs:
        item = dataset[i]
        pts = item[0] if isinstance(item, tuple) else item
        frames.append(np.asarray(pts, np.float64).reshape(-1, 3))
    vsize = cfg.mapping.voxel_size or cfg.data.max_range / 100.0
    stats = measure_frames(frames, vsize, cfg.data.min_range,
                           cfg.data.max_range)
    map_voxels = None
    gt = getattr(dataset, "gt_poses", None)
    if gt is not None and len(gt) >= max(idxs) + 1:
        map_voxels = estimate_map_voxels(
            frames, [gt[i] for i in idxs], vsize, cfg.data.min_range,
            cfg.data.max_range)
    return plan(
        stats, headroom=headroom, map_voxels=map_voxels,
        max_points_per_voxel=cfg.mapping.max_points_per_voxel,
        probe_length=cfg.engine.probe_length,
        map_storage=str(cfg.engine.map_storage),
    )


def main(argv=None) -> int:
    from kiss_icp_tpu_torch.config.parser import load_config
    from kiss_icp_tpu_torch.datasets import dataset_factory

    ap = argparse.ArgumentParser(
        description="Recommend engine capacities from dataset statistics")
    ap.add_argument("data", help="dataset root")
    ap.add_argument("--dataloader", default="generic")
    ap.add_argument("--sequence", default=None)
    ap.add_argument("--topic", default=None)
    ap.add_argument("--config", default=None, help="YAML config to plan for")
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--headroom", type=float, default=1.5)
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    ds = dataset_factory(args.dataloader, args.data, sequence=args.sequence,
                         topic=args.topic)
    p = plan_for_dataset(ds, cfg, samples=args.samples,
                         headroom=args.headroom)
    print(json.dumps(p.as_dict(), indent=2))
    cur = cfg.engine
    changed = []
    for fld in ("max_points_per_frame", "frame_capacity", "source_capacity"):
        rec, now = getattr(p, fld), getattr(cur, fld)
        if rec != now:
            changed.append(f"engine.{fld}: {now} -> {rec}")
    if p.map_capacity_log2 and p.map_capacity_log2 != cur.map_capacity_log2:
        changed.append(f"engine.map_capacity_log2: {cur.map_capacity_log2} "
                       f"-> {p.map_capacity_log2}")
    for line in changed or ["configured capacities already match the plan"]:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
