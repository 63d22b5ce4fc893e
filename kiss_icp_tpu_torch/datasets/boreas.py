"""Boreas dataset loader (reference datasets/boreas.py:31-89): float32 (N,6)
.bin scans, azimuth pseudo-timestamps, GT from the applanix lidar_poses.csv."""

from __future__ import annotations

import glob
import os

import numpy as np

from kiss_icp_tpu_torch.io.cloud_io import natural_sort


def azimuth_timestamps(points: np.ndarray) -> np.ndarray:
    """Pseudo per-point stamps from scan azimuth: t = 0.5(-atan2(y,x)/pi + 1)
    in [0, 1) (reference boreas.py:63-68, kitti_raw.py:102-108)."""
    yaw = -np.arctan2(points[:, 1], points[:, 0])
    return 0.5 * (yaw / np.pi + 1.0)


def _pose_from_applanix(x, y, z, yaw, pitch, roll) -> np.ndarray:
    """T_enu_sensor from applanix Euler angles (boreas.py:71-89 convention:
    C_enu_sensor = R_roll @ R_pitch @ R_yaw with transposed-style matrices)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    r_yaw = np.array([[cy, sy, 0], [-sy, cy, 0], [0, 0, 1]])
    r_pitch = np.array([[cp, 0, -sp], [0, 1, 0], [sp, 0, cp]])
    r_roll = np.array([[1, 0, 0], [0, cr, sr], [0, -sr, cr]])
    t = np.eye(4)
    t[:3, :3] = r_roll @ r_pitch @ r_yaw
    t[:3, 3] = [x, y, z]
    return t


class BoreasDataset:
    def __init__(self, data_dir, *_, **__):
        self.root_dir = os.path.realpath(str(data_dir))
        self.scan_files = natural_sort(glob.glob(os.path.join(self.root_dir, "lidar", "*.bin")))
        if not self.scan_files:
            raise FileNotFoundError(f"No lidar/*.bin under {data_dir}")
        gt_file = os.path.join(self.root_dir, "applanix", "lidar_poses.csv")
        if os.path.exists(gt_file):
            self.gt_poses = self.load_poses(gt_file)
            assert len(self.scan_files) == self.gt_poses.shape[0]
        self.sequence_id = os.path.basename(str(data_dir))

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points = np.fromfile(self.scan_files[idx], dtype=np.float32).reshape(-1, 6)[:, :3]
        points = points.astype(np.float64)
        return points, azimuth_timestamps(points)

    @staticmethod
    def load_poses(poses_file: str) -> np.ndarray:
        """CSV rows: t, x, y, z, vx, vy, vz, roll, pitch, yaw, wz, wy, wx;
        poses re-based to the first (boreas.py:49-60)."""
        data = np.loadtxt(poses_file, delimiter=",", skiprows=1, ndmin=2)
        n = data.shape[0]
        poses = np.empty((n, 4, 4))
        first = None
        for i in range(n):
            _, x, y, z, _, _, _, roll, pitch, yaw, _, _, _ = data[i]
            pose = _pose_from_applanix(x, y, z, yaw, pitch, roll)
            if first is None:
                first = np.linalg.inv(pose)
            poses[i] = first @ pose
        return poses
