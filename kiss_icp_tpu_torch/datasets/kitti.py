"""KITTI odometry benchmark loader.

Behavioral twin of the reference loader (python/kiss_icp/datasets/kitti.py:29-108):
.bin float32 (N,4) scans, the 0.205-degree vertical-angle scan correction
(reference pybind kiss_icp_pybind.cpp:127-138, here vectorized numpy), GT poses
re-expressed in the LiDAR frame through the calib Tr, and `apply_calibration`
mapping estimated poses back to the camera frame for result writing. Per-point
timestamps are empty: KITTI odometry scans are pre-deskewed, so deskewing is a
no-op (kitti.py:57).
"""

from __future__ import annotations

import glob
import os
import numpy as np

_VERTICAL_ANGLE_OFFSET = np.deg2rad(0.205)


def correct_kitti_scan(frame: np.ndarray) -> np.ndarray:
    """Rotate each point by 0.205 deg about axis p x z_hat (the KITTI intrinsic
    vertical-angle calibration from CT-ICP/IMLS-SLAM; reference
    kiss_icp_pybind.cpp:127-138), vectorized with the Rodrigues formula."""
    pts = np.asarray(frame, np.float64)
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(pts, z)
    norm = np.linalg.norm(axis, axis=1, keepdims=True)
    axis = np.divide(axis, norm, out=np.zeros_like(axis), where=norm > 0)
    c, s = np.cos(_VERTICAL_ANGLE_OFFSET), np.sin(_VERTICAL_ANGLE_OFFSET)
    # Rodrigues: p' = p c + (k x p) s + k (k.p)(1-c)
    kxp = np.cross(axis, pts)
    kdotp = np.sum(axis * pts, axis=1, keepdims=True)
    return pts * c + kxp * s + axis * kdotp * (1.0 - c)


class KITTIOdometryDataset:
    def __init__(self, data_dir, sequence, *_, **__):
        self.sequence_id = str(sequence).zfill(2)
        self.sequence_dir = os.path.join(str(data_dir), "sequences", self.sequence_id)
        self.velodyne_dir = os.path.join(self.sequence_dir, "velodyne")
        self.scan_files = sorted(glob.glob(os.path.join(self.velodyne_dir, "*.bin")))
        if not self.scan_files:
            raise FileNotFoundError(f"No .bin scans under {self.velodyne_dir}")
        self.calibration = self._read_calib(os.path.join(self.sequence_dir, "calib.txt"))

        # GT poses ship for sequences 00-10 only (kitti.py:38-41).
        try:
            seq_num = int(sequence)
        except ValueError:
            seq_num = 99
        poses_file = os.path.join(str(data_dir), "poses", f"{self.sequence_id}.txt")
        if seq_num < 11 and os.path.exists(poses_file):
            self.gt_poses = self._load_poses(poses_file)

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        from kiss_icp_tpu_torch.io import native

        if native.available():
            pts = native.read_scan(self.scan_files[idx], native.FORMAT_F32X4)
        else:
            # Same decoder the prefetcher falls back to: identical NaN /
            # truncation semantics whether or not `make native` ran.
            pts = native._numpy_decode(self.scan_files[idx],
                                       native.FORMAT_F32X4, 1 << 20)
        return correct_kitti_scan(pts), np.array([])

    def _tr(self) -> np.ndarray:
        tr = np.eye(4, dtype=np.float64)
        tr[:3, :4] = self.calibration["Tr"].reshape(3, 4)
        return tr

    def apply_calibration(self, poses: np.ndarray) -> np.ndarray:
        """Velodyne frame -> camera frame (kitti.py:59-63)."""
        tr = self._tr()
        return tr @ poses @ np.linalg.inv(tr)

    def _load_poses(self, poses_file) -> np.ndarray:
        """camera-frame 3x4 rows -> 4x4 LiDAR-frame poses (kitti.py:71-86)."""
        raw = np.loadtxt(poses_file).reshape(-1, 3, 4)
        n = raw.shape[0]
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, :3, :4] = raw
        tr = self._tr()
        return np.linalg.inv(tr) @ poses @ tr

    def get_frames_timestamps(self) -> np.ndarray:
        return np.loadtxt(os.path.join(self.sequence_dir, "times.txt")).reshape(-1, 1)

    @staticmethod
    def _read_calib(file_path) -> dict:
        calib = {}
        with open(file_path) as f:
            for line in f:
                tokens = line.split()
                if not tokens or tokens[0] == "calib_time:":
                    continue
                try:
                    values = np.array([float(t) for t in tokens[1:]], dtype=np.float64)
                except ValueError:
                    continue
                calib[tokens[0].rstrip(":")] = values
        return calib
