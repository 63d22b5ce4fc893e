"""NCLT dataset loader (reference datasets/nclt.py:30-143): velodyne_hits
int16-scaled binary decode, GT interpolated to scan timestamps, axis flips."""

from __future__ import annotations

import os

import numpy as np

_FLIP = np.array(
    [[1.0, 0, 0, 0], [0, -1.0, 0, 0], [0, 0, -1.0, 0], [0, 0, 0, 1.0]]
)


def read_nclt_scan(file_path: str) -> np.ndarray:
    """velodyne_sync .bin: interleaved int16 x,y,z,(l) with scaling 0.005 and
    offset -100 (nclt.py:61-83; decode documented at
    robots.engin.umich.edu/nclt read_vel_sync)."""
    binary = np.fromfile(file_path, dtype=np.int16)
    binary = binary[: (len(binary) // 4) * 4]  # floor a truncated tail
    x = binary[0::4].astype(np.float32) * 0.005 - 100.0
    y = binary[1::4].astype(np.float32) * 0.005 - 100.0
    z = binary[2::4].astype(np.float32) * 0.005 - 100.0
    # Flip to z-up (nclt.py:80-82).
    return np.stack([x, -y, -z], axis=1).astype(np.float64)


class NCLTDataset:
    def __init__(self, data_dir, *_, **__):
        self.sequence_id = os.path.basename(str(data_dir))
        self.sequence_dir = os.path.realpath(str(data_dir))
        self.scans_dir = os.path.join(self.sequence_dir, "velodyne_sync")
        scan_files = np.array(sorted(os.listdir(self.scans_dir)), dtype=str)
        if scan_files.size == 0:
            raise FileNotFoundError(f"No scans under {self.scans_dir}")
        poses_file = os.path.realpath(
            os.path.join(
                self.sequence_dir, "..", f"ground_truth/groundtruth_{self.sequence_id}.csv"
            )
        )
        if os.path.exists(poses_file):
            gt_data = np.loadtxt(poses_file, delimiter=",")
            self.timestamps, keep = self._valid_timestamps(gt_data, scan_files)
            self.scan_files = scan_files[keep]
            self.gt_poses = self._load_gt_poses(gt_data)
        else:
            self.scan_files = scan_files
        self.use_global_visualizer = True

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        path = os.path.join(self.scans_dir, str(self.scan_files[idx]))
        return read_nclt_scan(path), np.array([])

    @staticmethod
    def _valid_timestamps(gt_data, scan_files):
        """Keep scans whose stamp lies inside the GT time span (nclt.py:85-92)."""
        gt_t = gt_data[:, 0]
        stamps = np.array([f.split(".")[0] for f in scan_files], dtype=np.int64)
        keep = (stamps > gt_t.min()) & (stamps < gt_t.max())
        return stamps[keep], keep

    def _load_gt_poses(self, gt_data) -> np.ndarray:
        """Nearest-neighbor interpolate GT [t, x, y, z, r, p, y] to the scan
        stamps; euler ZYX; conjugate by the z-down flip (nclt.py:94-143)."""
        from scipy import interpolate
        from scipy.spatial.transform import Rotation

        inter = interpolate.interp1d(gt_data[:, 0], gt_data[:, 1:], kind="nearest", axis=0)
        gt = inter(self.timestamps)
        rot = Rotation.from_euler("ZYX", gt[:, 3:][:, [2, 1, 0]]).as_matrix()
        poses = np.tile(np.eye(4), (gt.shape[0], 1, 1))
        poses[:, :3, :3] = rot
        poses[:, :3, 3] = gt[:, :3]
        return _FLIP @ poses @ _FLIP
