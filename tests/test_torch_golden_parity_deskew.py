"""Long-run golden parity with deskew, run by the port: tests/
test_golden_parity_deskew.py with the port's KissICP (`device="cpu"`) in
place of the JAX package's, on the same drives, oracle and bounds.

50 rolling-shutter frames (24 x 384 beams, 0.2 m a frame) through
`register_frame_lazy` against the float64 oracle of the reference algorithm,
then a harsher drive past the algorithm's stability margin whose poses must
stay finite. The bounds and what they catch are the JAX test's (its
docstring): no systematic deskew-path break (per-frame motion deltas within
the oracle's chaos band), accuracy against ground truth no worse than the
oracle's, a bounded absolute envelope, finite poses throughout.
"""

import numpy as np
import torch

import scenario_helpers as sh
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.odometry import KissICP

torch.set_num_threads(1)

N_FRAMES = 50


def _config():
    cfg = KISSConfig()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.data.deskew = True
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 16384
    cfg.engine.frame_capacity = 16384
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 15
    cfg.engine.donate_state = False
    return cfg


def test_fifty_frame_deskewed_parity():
    ds = sh.make_drive(
        N_FRAMES, seq=5, n_beams=24, n_azimuth=384, max_range=50.0,
        speed=0.2, distort=True,
    )
    cfg = _config()
    icp = KissICP(cfg, device="cpu")

    frames = []
    ours = []
    for i in range(N_FRAMES):
        pts, ts = ds[i]
        frames.append((pts, ts))
        icp.register_frame_lazy(pts, ts)
        ours.append(np.asarray(icp.last_pose, np.float64))
    ours = np.stack(ours)

    golden = sh.run_oracle_pipeline(frames, cfg)
    gt = ds.gt_poses[:N_FRAMES]

    # Per-frame motion deltas (pose_{i-1}^-1 @ pose_i): each is a fresh
    # registration, no accumulation.
    delta_diff, rot_diff, our_err, gold_err = [], [], [], []
    for i in range(1, N_FRAMES):
        d_ours = np.linalg.inv(ours[i - 1]) @ ours[i]
        d_gold = np.linalg.inv(golden[i - 1]) @ golden[i]
        d_gt = np.linalg.inv(gt[i - 1]) @ gt[i]
        delta_diff.append(np.abs(d_ours[:3, 3] - d_gold[:3, 3]).max())
        rot_diff.append(np.abs(d_ours[:3, :3] - d_gold[:3, :3]).max())
        our_err.append(np.linalg.norm(d_ours[:3, 3] - d_gt[:3, 3]))
        gold_err.append(np.linalg.norm(d_gold[:3, 3] - d_gt[:3, 3]))
    assert np.max(delta_diff) < 0.13, (
        f"max per-frame delta diff {np.max(delta_diff):.3f} m — "
        "systematic deskew divergence from the oracle"
    )
    assert np.median(delta_diff) < 0.06
    assert np.max(rot_diff) < 6e-3

    # Accuracy parity: the mean per-frame motion error against ground truth
    # is no worse than the float64 oracle's.
    assert np.mean(our_err) <= np.mean(gold_err) + 0.01, (
        f"mean delta error vs GT: ours {np.mean(our_err):.4f} m, "
        f"oracle {np.mean(gold_err):.4f} m"
    )
    assert np.max(our_err) < 0.25

    # Absolute trajectory envelope after 50 frames.
    err = np.linalg.norm(ours[:, :3, 3] - golden[:, :3, 3], axis=1)
    assert err.max() < 0.5, f"absolute divergence {err.max():.3f} m"
    assert np.all(np.isfinite(ours))


def test_poses_stay_finite_past_stability_margin():
    """A harsh rolling-shutter drive across the algorithm's stability margin
    (the float64 oracle diverges on it too): the pose stream stays finite,
    through the solver step cap and the constant-velocity fallback."""
    n = 40
    ds = sh.make_drive(n, seq=5, n_beams=16, n_azimuth=256, max_range=50.0,
                       speed=0.4, distort=True)
    cfg = _config()
    cfg.engine.max_points_per_frame = 8192
    cfg.engine.frame_capacity = 8192
    icp = KissICP(cfg, device="cpu")
    for i in range(n):
        pts, ts = ds[i]
        icp.register_frame_lazy(pts, ts)
        pose = np.asarray(icp.last_pose)
        assert np.all(np.isfinite(pose)), f"non-finite pose at frame {i}"
    assert np.all(np.isfinite(icp.state.threshold.model_sse.numpy()))
