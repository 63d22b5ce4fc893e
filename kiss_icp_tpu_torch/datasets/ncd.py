"""Newer College dataset loader (reference datasets/ncd.py:32-106), backed by
this framework's numpy PCD reader instead of PyntCloud."""

from __future__ import annotations

import os
import re

import numpy as np
from scipy.spatial.transform import Rotation

from kiss_icp_tpu_torch.io.cloud_io import read_pcd


class NewerCollegeDataset:
    H = 64
    W = 1024
    _STAMPS = None  # cached constant (rebuilt 65k-elem array per frame otherwise)

    def __init__(self, data_dir, *_, **__):
        self.data_source = str(data_dir)
        self.scan_folder = os.path.join(self.data_source, "raw_format", "ouster_scan")
        self.pose_file = os.path.join(
            self.data_source, "ground_truth", "registered_poses.csv"
        )
        self.sequence_id = os.path.basename(str(data_dir))
        self.scan_files = self.get_pcd_filenames(self.scan_folder)
        if os.path.exists(self.pose_file):
            self.gt_poses = self.load_gt_poses(self.pose_file)
        self.use_global_visualizer = True

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points, _ = read_pcd(os.path.join(self.scan_folder, self.scan_files[idx]))
        timestamps = self.get_timestamps()
        if points.shape[0] != timestamps.shape[0]:
            return points.astype(np.float64), np.array([])  # broken cloud fallback
        return points.astype(np.float64), timestamps

    @classmethod
    def get_timestamps(cls) -> np.ndarray:
        if cls._STAMPS is None:
            cls._STAMPS = np.floor(np.arange(cls.H * cls.W) / cls.H) / cls.W
        return cls._STAMPS

    @staticmethod
    def get_pcd_filenames(scans_folder):
        """Sort cloud_<secs>_<nsecs>.pcd files by their embedded timestamp."""
        regex = re.compile(r"^cloud_(\d+)_(\d+)")

        def stamp(name):
            m = regex.search(name)
            if m is None:
                return 0
            secs, nsecs = m.groups()
            return int(secs) * 1_000_000_000 + int(nsecs)

        return sorted(os.listdir(scans_folder), key=stamp)

    @staticmethod
    def load_gt_poses(file_path: str) -> np.ndarray:
        """GT csv: [sec, nsec, x, y, z, qx, qy, qz, qw]; poses composed with the
        camera<->lidar extrinsic T_CL, re-based to the first pose
        (ncd.py:84-106)."""
        gt = np.genfromtxt(file_path, delimiter=",", dtype=np.float64)
        xyz = gt[:, 2:5]
        quat_xyzw = gt[:, 5:9]
        rot = Rotation.from_quat(quat_xyzw).as_matrix()
        n = rot.shape[0]
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, :3, :3] = rot
        poses[:, :3, 3] = xyz

        t_cl = np.eye(4)
        t_cl[:3, :3] = Rotation.from_quat([0.0, 0.0, 0.924, 0.383]).as_matrix()
        t_cl[:3, 3] = [-0.084, -0.025, 0.050]
        poses = poses @ t_cl
        return np.linalg.inv(poses[0]) @ poses
