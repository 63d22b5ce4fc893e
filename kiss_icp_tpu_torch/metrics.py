"""Trajectory evaluation metrics: KITTI relative error and Umeyama-aligned ATE.

Equivalent of the reference metrics layer (cpp/kiss_icp/metrics/Metrics.cpp:48-189
and its numpy wrapper python/kiss_icp/metrics.py:30-39). These run once per
sequence on the host, so they are plain numpy float64 (a copy of the JAX
package's `metrics.py`).

KITTI protocol (Metrics.cpp:48-156, a port of the KITTI odometry devkit):
trajectory lengths are accumulated from consecutive GT poses; for every 10th
frame and every segment length in {100,...,800} m, find the frame that closes
that arc length and measure the relative-pose error between estimate and GT
over the segment; report mean translational error (%) and rotational error
(deg/m).

ATE (Metrics.cpp:158-189): Umeyama-align estimated translations to GT, then
RMSE of per-pose rotation / translation deltas.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_SEGMENT_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
_FRAME_STEP = 10


def _trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative arc length of the trajectory, one entry per pose."""
    deltas = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(deltas)])


def _last_frame_from_segment_length(dist: np.ndarray, first: int, length: float) -> int:
    target = dist[first] + length
    # side="right": first index with dist STRICTLY greater than the target,
    # matching the devkit loop `if (dist[i] > dist[first] + len)`
    # (Metrics.cpp:75-82) on exact-boundary arc lengths.
    idx = np.searchsorted(dist, target, side="right")
    return int(idx) if idx < len(dist) else -1


def _rotation_error(r: np.ndarray) -> float:
    """Angle of a relative rotation (Metrics.cpp:66-73 formula)."""
    tr = np.trace(r[:3, :3])
    return float(np.arccos(np.clip(0.5 * (tr - 1.0), -1.0, 1.0)))


def seq_error(gt_poses: np.ndarray, poses: np.ndarray) -> Tuple[float, float]:
    """KITTI sequence error: (avg translational error %, avg rotational error deg/m).

    Mirrors SeqError/CalcSequenceErrors (Metrics.cpp:75-156).
    """
    avg_t, avg_r, _ = seq_error_stats(gt_poses, poses)
    return avg_t, avg_r


def seq_error_stats(
    gt_poses: np.ndarray, poses: np.ndarray
) -> Tuple[float, float, int]:
    """`seq_error` plus the number of valid segments evaluated.

    The two-tuple API returns exact 0.0 both when the drive is too short for
    any 100 m segment AND when the estimate is perfect over valid segments —
    consumers that must distinguish "no evidence" from "zero error" (e.g. the
    bench artifact) use the segment count as the explicit validity signal.
    """
    gt_poses = np.asarray(gt_poses, np.float64)
    poses = np.asarray(poses, np.float64)
    assert gt_poses.shape == poses.shape, (gt_poses.shape, poses.shape)
    dist = _trajectory_distances(gt_poses)

    t_errs: List[float] = []
    r_errs: List[float] = []
    for first in range(0, len(poses), _FRAME_STEP):
        for length in _SEGMENT_LENGTHS:
            last = _last_frame_from_segment_length(dist, first, length)
            if last < 0:
                continue
            # Relative pose over the segment, error between GT and estimate.
            pose_delta_gt = np.linalg.inv(gt_poses[first]) @ gt_poses[last]
            pose_delta = np.linalg.inv(poses[first]) @ poses[last]
            error = np.linalg.inv(pose_delta) @ pose_delta_gt
            t_errs.append(float(np.linalg.norm(error[:3, 3])) / length)
            r_errs.append(_rotation_error(error) / length)
    if not t_errs:
        return 0.0, 0.0, 0
    avg_t = 100.0 * float(np.mean(t_errs))  # percent
    avg_r = float(np.mean(r_errs)) * 180.0 / np.pi  # deg per meter
    return avg_t, avg_r, len(t_errs)


def _umeyama_alignment(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Rigid alignment (no scale) of point sets x -> y, both (3, N).

    Umeyama, IEEE TPAMI 1991 — same algorithm as Metrics.cpp:158-176.
    """
    mu_x = x.mean(axis=1, keepdims=True)
    mu_y = y.mean(axis=1, keepdims=True)
    cov = (y - mu_y) @ (x - mu_x).T / x.shape[1]
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    r = u @ s @ vt
    t = mu_y - r @ mu_x
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = t[:, 0]
    return out


def absolute_trajectory_error(
    gt_poses: np.ndarray, poses: np.ndarray
) -> Tuple[float, float]:
    """(ATE rotation RMSE rad, ATE translation RMSE m), Umeyama-aligned
    (Metrics.cpp:158-189)."""
    gt_poses = np.asarray(gt_poses, np.float64)
    poses = np.asarray(poses, np.float64)
    if len(poses) == 0 or len(gt_poses) == 0:
        # An empty run has no trajectory error; the Umeyama SVD on empty
        # arrays would raise LinAlgError long after the run completed.
        return 0.0, 0.0
    align = _umeyama_alignment(poses[:, :3, 3].T, gt_poses[:, :3, 3].T)

    rot_sse = 0.0
    trans_sse = 0.0
    for gt, est in zip(gt_poses, poses):
        est_aligned = align @ est
        delta = np.linalg.inv(gt) @ est_aligned
        rot_sse += _rotation_error(delta) ** 2
        trans_sse += float(np.sum(delta[:3, 3] ** 2))
    n = len(poses)
    return float(np.sqrt(rot_sse / n)), float(np.sqrt(trans_sse / n))


def sequence_error(gt_poses: np.ndarray, poses: np.ndarray) -> Tuple[float, float]:
    """Alias matching the reference Python API (python/kiss_icp/metrics.py:30-33)."""
    return seq_error(gt_poses, poses)
