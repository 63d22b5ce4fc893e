"""Apollo dataset loader (reference datasets/apollo.py:34-71), using the numpy
PCD reader and scipy rotations instead of open3d/pyquaternion."""

from __future__ import annotations

import glob
import os

import numpy as np
from scipy.spatial.transform import Rotation

from kiss_icp_tpu_torch.io.cloud_io import natural_sort, read_pcd


class ApolloDataset:
    def __init__(self, data_dir, *_, **__):
        self.scan_files = natural_sort(glob.glob(os.path.join(str(data_dir), "pcds", "*.pcd")))
        if not self.scan_files:
            raise FileNotFoundError(f"No pcds/*.pcd under {data_dir}")
        gt_file = os.path.join(str(data_dir), "poses", "gt_poses.txt")
        if os.path.exists(gt_file):
            self.gt_poses = self.read_poses(gt_file)
        self.sequence_id = os.path.basename(str(data_dir))

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points, _ = read_pcd(self.scan_files[idx])
        return points.astype(np.float64), np.array([])

    @staticmethod
    def read_poses(file: str) -> np.ndarray:
        """gt_poses.txt rows: [idx, stamp, x, y, z, qx, qy, qz, qw], re-based
        to the first pose (apollo.py:58-71)."""
        data = np.loadtxt(file)
        translations = data[:, 2:5]
        quat_xyzw = data[:, 5:9]
        n = data.shape[0]
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, :3, :3] = Rotation.from_quat(quat_xyzw).as_matrix()
        poses[:, :3, 3] = translations
        return np.linalg.inv(poses[0]) @ poses
