"""Long-horizon f32-vs-f64 drift bound, run by the port: tests/
test_long_horizon.py with the port's KissICP (`device="cpu"`) in place of the
JAX package's, on the same frames, config and bounds.

The committed golden (tests/golden/long_horizon.npz, made by
tests/make_goldens.py) holds the float64 oracle trajectory and per-frame ICP
iteration counts over a 200-frame deskew-on drive. The port runs the same
200 frames through `register_frames_chunked`, 25 a call, and is held to the
JAX test's bounds: no capacity drops; Umeyama ATE and the KITTI segment
metric of the f32 trajectory against the oracle as pseudo ground truth; the
per-step relative pose error and its trend; the iteration tail against the
oracle's loop; and the end point against the simulator's ground truth.
"""

import os

import numpy as np
import pytest
import torch

from make_goldens import LONG_HORIZON, long_horizon_scenario
from kiss_icp_tpu_torch import metrics
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.odometry import KissICP

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "long_horizon.npz")


@pytest.fixture(scope="module")
def impl_run():
    g = np.load(GOLDEN)
    ds = long_horizon_scenario()
    n = LONG_HORIZON["n_scans"]

    cfg = KISSConfig()
    cfg.data.min_range = 1.0
    cfg.engine.max_points_per_frame = 16384
    cfg.engine.frame_capacity = 8192
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 17
    cfg.mapping.voxel_size = 1.0

    icp = KissICP(cfg, device="cpu")
    k = 25
    poses, iters, drops = [], [], 0
    for c in range(n // k):
        frames, stamps = [], []
        for j in range(c * k, (c + 1) * k):
            f, t = ds[j]
            frames.append(f)
            stamps.append(t)
        poses.append(icp.register_frames_chunked(frames, stamps))
        s = icp.last_chunk_summary
        iters.append(s.num_iterations.numpy())
        drops += int(s.num_dropped_downsample.sum())
        drops += int(s.num_dropped_map_voxels.sum())
    return {
        "poses": np.concatenate(poses),
        "iters": np.concatenate(iters),
        "drops": drops,
        "oracle_poses": g["poses"],
        "oracle_iters": g["iters"],
        "gt_poses": g["gt_poses"],
    }


def test_no_capacity_drops(impl_run):
    assert impl_run["drops"] == 0


def test_drift_growth_bounded_vs_oracle(impl_run):
    """ATE of the f32 trajectory against the f64 oracle over 200 frames
    (~180 m of travel) stays at the centimeter level."""
    ate_rot, ate_trans = metrics.absolute_trajectory_error(
        impl_run["oracle_poses"], impl_run["poses"])
    assert ate_trans < 0.15, f"ATE_trans={ate_trans:.3f} m"
    assert ate_rot < 0.02, f"ATE_rot={ate_rot:.4f} rad"

    err = np.linalg.norm(
        impl_run["poses"][:, :3, 3] - impl_run["oracle_poses"][:, :3, 3], axis=1)
    assert err.max() < 0.8, f"max abs divergence {err.max():.3f} m"


def test_kitti_segment_metric_vs_oracle(impl_run):
    """KITTI relative error (segments 100-800 m, every 10th frame) with the
    oracle as pseudo-GT sits far below the 0.55 % accuracy target."""
    seg_t, seg_r = metrics.seq_error(impl_run["oracle_poses"], impl_run["poses"])
    assert seg_t < 0.35, f"seg trans err {seg_t:.3f}%"
    assert seg_r < 0.01, f"seg rot err {seg_r:.5f} deg/m"


def test_relative_pose_error_per_step(impl_run):
    """Per-step deltas match the oracle's: errors stay local, they do not
    trend."""
    poses, op = impl_run["poses"], impl_run["oracle_poses"]
    rpe = []
    for i in range(1, len(poses)):
        d_impl = np.linalg.inv(poses[i - 1]) @ poses[i]
        d_or = np.linalg.inv(op[i - 1]) @ op[i]
        rpe.append(np.linalg.norm((np.linalg.inv(d_or) @ d_impl)[:3, 3]))
    rpe = np.asarray(rpe)
    assert np.percentile(rpe, 99) < 0.15, f"RPE p99 {np.percentile(rpe, 99):.3f} m"
    # No trend: the last quarter's median RPE stays within 3x the first's.
    q = len(rpe) // 4
    assert np.median(rpe[-q:]) < 3.0 * max(np.median(rpe[:q]), 0.01)


def test_iteration_tail_matches_oracle(impl_run):
    """The f32 convergence check does not spin the loop materially longer
    than the oracle's f64 loop."""
    it_impl, it_or = impl_run["iters"], impl_run["oracle_iters"]
    assert np.percentile(it_impl, 50) <= 2.0 * np.percentile(it_or, 50)
    assert np.percentile(it_impl, 95) <= 2.0 * np.percentile(it_or, 95)
    assert it_impl.max() <= 3.0 * it_or.max()


def test_comparable_accuracy_vs_simulator_gt(impl_run):
    """Against the simulator's exact ground truth, the port ends within the
    oracle's own envelope."""
    gt = impl_run["gt_poses"]
    e_impl = np.linalg.norm(impl_run["poses"][-1, :3, 3] - gt[-1, :3, 3])
    e_or = np.linalg.norm(impl_run["oracle_poses"][-1, :3, 3] - gt[-1, :3, 3])
    assert e_impl < 1.5 * e_or + 0.5, (e_impl, e_or)
