"""Hand-made maps that pin the NN query's rules (K2 and its plain version).

Each case returns plain numpy arrays, so that a test can hand the same map to
this package and to the JAX package: `arrays` (vkeys, fprints, counts,
points of an f32 map, slot for slot), the config's keyword arguments, the
queries, and the neighbour, distance and `found` the query must return.
`to_map` turns the arrays into this package's VoxelMap.

  * cross_voxel_tie: two stored points at the same distance from the query
    in two neighbour voxels; the lower neighbour index j wins.
  * fingerprint_collision: the query voxel's probe window holds, before the
    voxel's real slot, a slot with the same fingerprint and another key. The
    first fingerprint match decides: its key differs, so the voxel counts as
    absent (no scan onward), and the nearest point comes from a neighbour.
  * nan_point: a stored point with a NaN coordinate among the candidates.
    The argmin takes the NaN as the minimum: the distance is NaN and
    nothing is found, though a finite point is nearby.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kiss_icp_tpu_torch.ops import hash_map


class Case(NamedTuple):
    config: dict  # MapConfig keyword arguments
    arrays: dict  # vkeys (C,3) i32, fprints (C,) i32, counts (C,) i32, points (C,P,3) f32
    queries: np.ndarray  # (N, 3) f32
    valid: np.ndarray  # (N,) bool
    neighbors: np.ndarray  # (N, 3) f32, the expected answer
    distances: np.ndarray  # (N,) f32
    found: np.ndarray  # (N,) bool


def _empty(config: dict) -> dict:
    cfg = hash_map.MapConfig(**config)
    c, p = cfg.capacity, cfg.max_points_per_voxel
    return dict(vkeys=np.zeros((c, 3), np.int32), fprints=np.zeros(c, np.int32),
                counts=np.zeros(c, np.int32), points=np.zeros((c, p, 3), np.float32))


def _place(config: dict, arrays: dict, voxel, points, stored_key=None) -> int:
    """Store `points` in the first free slot of `voxel`'s probe window, with
    `voxel`'s fingerprint and `stored_key` (default: `voxel`) as its key."""
    cfg = hash_map.MapConfig(**config)
    k = cfg.probe_length
    v = torch.tensor([voxel], dtype=torch.int32)
    base = int(hash_map.window_row(v, cfg.capacity_log2, k)[0]) * k
    slot = base + int(np.flatnonzero(arrays["fprints"][base:base + k] == 0)[0])
    arrays["fprints"][slot] = int(hash_map.fingerprint(v)[0])
    arrays["vkeys"][slot] = voxel if stored_key is None else stored_key
    arrays["counts"][slot] = len(points)
    arrays["points"][slot, :len(points)] = points
    return slot


_CONFIG = dict(voxel_size=1.0, max_distance=30.0, max_points_per_voxel=4,
               capacity_log2=10, probe_length=16)


def cross_voxel_tie() -> Case:
    """Query (0.5, 0.5, 0.5): (0.5, 0.5, -0.25) in voxel (0, 0, -1), j = 2, and
    (0.5, 0.5, 1.25) in voxel (0, 0, 1), j = 1, are both 0.75 away (exact in
    f32). The lower j wins, whichever slot each voxel occupies."""
    arrays = _empty(_CONFIG)
    _place(_CONFIG, arrays, (0, 0, -1), [[0.5, 0.5, -0.25]])
    _place(_CONFIG, arrays, (0, 0, 1), [[0.5, 0.5, 1.25]])
    return Case(_CONFIG, arrays, np.array([[0.5, 0.5, 0.5]], np.float32),
                np.ones(1, bool), np.array([[0.5, 0.5, 1.25]], np.float32),
                np.array([0.75], np.float32), np.ones(1, bool))


def fingerprint_collision() -> Case:
    """Query (0.5, 0.5, 0.5) in voxel V = (0, 0, 0). V's window holds first a
    slot with V's fingerprint but key (5, 5, 5) and a point 0.1 away, then
    V's real slot with a point 0.4 away. Neither may be returned: the first
    match's key differs, so V is absent. The answer is the point 0.7 away in
    voxel (0, 0, 1)."""
    arrays = _empty(_CONFIG)
    decoy = _place(_CONFIG, arrays, (0, 0, 0), [[0.5, 0.5, 0.6]], stored_key=(5, 5, 5))
    real = _place(_CONFIG, arrays, (0, 0, 0), [[0.5, 0.5, 0.9]])
    assert decoy < real
    _place(_CONFIG, arrays, (0, 0, 1), [[0.5, 0.5, 1.2]])
    d = np.float32(1.2) - np.float32(0.5)
    return Case(_CONFIG, arrays, np.array([[0.5, 0.5, 0.5]], np.float32),
                np.ones(1, bool), np.array([[0.5, 0.5, 1.2]], np.float32),
                np.array([np.sqrt(d * d)], np.float32), np.ones(1, bool))


def nan_point() -> Case:
    """Query (0.5, 0.5, 0.5): voxel (0, 0, 0) holds (0.5, 0.5, 0.6) and then
    (nan, 0.5, 0.5); the NaN distance wins the argmin, so the answer is a
    zero neighbour, a NaN distance and not found."""
    arrays = _empty(_CONFIG)
    _place(_CONFIG, arrays, (0, 0, 0), [[0.5, 0.5, 0.6], [np.nan, 0.5, 0.5]])
    _place(_CONFIG, arrays, (0, 0, 1), [[0.5, 0.5, 1.2]])
    return Case(_CONFIG, arrays, np.array([[0.5, 0.5, 0.5]], np.float32),
                np.ones(1, bool), np.zeros((1, 3), np.float32),
                np.array([np.nan], np.float32), np.zeros(1, bool))


CASES = {"cross_voxel_tie": cross_voxel_tie,
         "fingerprint_collision": fingerprint_collision,
         "nan_point": nan_point}


def to_map(case: Case, device=None):
    """(MapConfig, VoxelMap) of this package holding the case's arrays."""
    cfg = hash_map.MapConfig(**case.config)
    t = {name: torch.from_numpy(a).to(device) for name, a in case.arrays.items()}
    zero = torch.zeros((), dtype=torch.int32, device=device)
    total = torch.sum(t["counts"], dtype=torch.int32)
    return cfg, hash_map.VoxelMap(t["vkeys"], t["fprints"], t["counts"], t["points"],
                                  total, zero, zero.clone())
