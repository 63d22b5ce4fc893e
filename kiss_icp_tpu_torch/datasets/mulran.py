"""MulRan dataset loader (behavioral twin of reference datasets/mulran.py:30-102).

Ouster-64 .bin scans (float32 N x 4), fixed 64x1024 column-major pseudo
timestamps, GT from global_pose.csv matched to scan stamps by nearest
timestamp, re-based to the first pose and conjugated by the base<->lidar
extrinsic from calib_base2ouster.txt.
"""

from __future__ import annotations

import glob
import os

import numpy as np

# From MulRan's calib_base2ouster.txt: translation (1.7042, -0.021, 1.8047),
# rotation euler xyz (0.0001, 0.0003, 179.6654) degrees.
_T_LIDAR_TO_BASE = np.array(
    [
        [-9.9998295e-01, -5.8398386e-03, -5.2257060e-06, 1.7042000e00],
        [5.8398386e-03, -9.9998295e-01, 1.7758769e-06, -2.1000000e-02],
        [-5.2359878e-06, 1.7453292e-06, 1.0000000e00, 1.8047000e00],
        [0.0000000e00, 0.0000000e00, 0.0000000e00, 1.0000000e00],
    ]
)


class MulranDataset:
    H = 64
    W = 1024
    _STAMPS = None  # cached constant (rebuilt 65k-elem array per frame otherwise)

    def __init__(self, data_dir, *_, **__):
        self.sequence_id = os.path.basename(os.path.realpath(str(data_dir)))
        self.sequence_dir = os.path.realpath(str(data_dir))
        self.velodyne_dir = os.path.join(self.sequence_dir, "Ouster")
        self.scan_files = sorted(glob.glob(os.path.join(self.velodyne_dir, "*.bin")))
        if not self.scan_files:
            raise FileNotFoundError(f"No Ouster .bin scans under {self.velodyne_dir}")
        self.scan_timestamps = [
            int(os.path.basename(f).split(".")[0]) for f in self.scan_files
        ]
        gt_file = os.path.join(self.sequence_dir, "global_pose.csv")
        if os.path.exists(gt_file):
            self.gt_poses = self._load_gt_poses(gt_file)

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points = np.fromfile(self.scan_files[idx], dtype=np.float32).reshape(-1, 4)[:, :3]
        timestamps = self.get_timestamps()
        if points.shape[0] != timestamps.shape[0]:
            # Broken clouds fall back to no per-point stamps (mulran.py:49-51).
            return points.astype(np.float64), np.array([])
        return points.astype(np.float64), timestamps

    @classmethod
    def get_timestamps(cls) -> np.ndarray:
        """Column-major pseudo stamps floor(i/H)/W in [0, 1) (mulran.py:54-58)."""
        if cls._STAMPS is None:
            cls._STAMPS = np.floor(np.arange(cls.H * cls.W) / cls.H) / cls.W
        return cls._STAMPS

    def _load_gt_poses(self, poses_file: str) -> np.ndarray:
        data = np.loadtxt(poses_file, delimiter=",")
        timestamps, rows = data[:, 0], data[:, 1:]
        n = rows.shape[0]
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, :3, :4] = rows.reshape(n, 3, 4)
        # One pose per scan: nearest GT timestamp (mulran.py:76-79).
        idx = [int(np.argmin(np.abs(timestamps - t))) for t in self.scan_timestamps]
        poses = poses[idx]
        poses = np.linalg.inv(poses[0]) @ poses
        t_l2b = _T_LIDAR_TO_BASE
        return t_l2b @ poses @ np.linalg.inv(t_l2b)
