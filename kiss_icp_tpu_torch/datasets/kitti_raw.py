"""KITTI raw dataset loader (reference datasets/kitti_raw.py:44-392).

Raw drives mapped to odometry benchmark sequences, GT poses integrated from
OXTS GPS/IMU packets (Mercator projection, the pykitti algorithm) expressed in
the velodyne frame, the 0.205-degree scan correction, and azimuth pseudo
per-point timestamps so motion deskewing is exercised (the odometry-benchmark
scans are pre-deskewed; the raw ones are not).

Simplification vs the reference: only the IMU->velodyne rigid calibration is
loaded (cameras are irrelevant to LiDAR odometry; the reference loads the full
camera calibration it never uses, kitti_raw.py:157-260).
"""

from __future__ import annotations

import glob
import os
import numpy as np

from kiss_icp_tpu_torch.datasets.kitti import correct_kitti_scan

RAW_TO_ODOMETRY_MAPPING = {
    "00": "2011_10_03/2011_10_03_drive_0027_sync/",
    "01": "2011_10_03/2011_10_03_drive_0042_sync/",
    "02": "2011_10_03/2011_10_03_drive_0034_sync/",
    "04": "2011_09_30/2011_09_30_drive_0016_sync/",
    "05": "2011_09_30/2011_09_30_drive_0018_sync/",
    "06": "2011_09_30/2011_09_30_drive_0020_sync/",
    "07": "2011_09_30/2011_09_30_drive_0027_sync/",
    "08": "2011_09_30/2011_09_30_drive_0028_sync/",
    "09": "2011_09_30/2011_09_30_drive_0033_sync/",
    "10": "2011_09_30/2011_09_30_drive_0034_sync/",
}

RAW_TO_BENCHMARK_INDICES = {
    "00": (0, 4540),
    "01": (0, 1100),
    "02": (0, 4660),
    "04": (0, 270),
    "05": (0, 2760),
    "06": (0, 1100),
    "07": (0, 1100),
    "08": (1100, 5170),
    "09": (0, 1590),
    "10": (0, 1200),
}

EARTH_RADIUS = 6378137.0  # meters


# Shared pseudo-stamp convention (reference kitti_raw.py:102-108 and
# boreas.py:63-68 use the identical formula): one definition.
from kiss_icp_tpu_torch.datasets.boreas import azimuth_timestamps  # noqa: F401,E402


def pose_from_oxts(lat, lon, alt, roll, pitch, yaw, scale) -> np.ndarray:
    """SE(3) pose from one OXTS packet via Mercator projection (pykitti
    algorithm, kitti_raw.py:254-331)."""
    tx = scale * lon * np.pi * EARTH_RADIUS / 180.0
    ty = scale * EARTH_RADIUS * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    tz = alt
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, :3] = rz @ ry @ rx
    pose[:3, 3] = [tx, ty, tz]
    return pose


class KITTIRawDataset:
    def __init__(self, data_dir, sequence, *_, **__):
        self.sequence_id = str(sequence).zfill(2)
        if self.sequence_id not in RAW_TO_ODOMETRY_MAPPING:
            raise ValueError(
                f"Sequence {self.sequence_id} has no raw-drive mapping "
                f"(available: {sorted(RAW_TO_ODOMETRY_MAPPING)})"
            )
        self.root_dir = os.path.realpath(
            os.path.join(str(data_dir), RAW_TO_ODOMETRY_MAPPING[self.sequence_id])
        )
        self.date_id = self.root_dir.split("/")[-2]
        first, last = RAW_TO_BENCHMARK_INDICES[self.sequence_id]

        self.velodyne_dir = os.path.join(self.root_dir, "velodyne_points", "data")
        scan_files = sorted(glob.glob(os.path.join(self.velodyne_dir, "*.bin")))
        self.scan_files = scan_files[first : last + 1]
        if not self.scan_files:
            raise FileNotFoundError(f"No .bin scans under {self.velodyne_dir}")

        self.calib_path = os.path.join(str(data_dir), self.date_id)
        self.t_velo_imu = self._load_rigid_calib("calib_imu_to_velo.txt")

        oxts_dir = os.path.join(self.root_dir, "oxts", "data")
        oxts_files = sorted(glob.glob(os.path.join(oxts_dir, "*.txt")))[first : last + 1]
        if oxts_files:
            imu_poses = self._poses_from_oxts(oxts_files)
            self.gt_poses = self.t_velo_imu @ imu_poses @ np.linalg.inv(self.t_velo_imu)

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points = np.fromfile(self.scan_files[idx], dtype=np.float32).reshape(-1, 4)[:, :3]
        points = correct_kitti_scan(points.astype(np.float64))
        return points, azimuth_timestamps(points)

    def _load_rigid_calib(self, filename: str) -> np.ndarray:
        data = {}
        with open(os.path.join(self.calib_path, filename)) as f:
            for line in f:
                key, _, value = line.partition(":")
                try:
                    data[key] = np.array([float(x) for x in value.split()])
                except ValueError:
                    continue
        t = np.eye(4)
        t[:3, :3] = data["R"].reshape(3, 3)
        t[:3, 3] = data["T"]
        return t

    @staticmethod
    def _poses_from_oxts(oxts_files) -> np.ndarray:
        poses = []
        scale = None
        origin_inv = None
        for path in oxts_files:
            vals = np.loadtxt(path)
            lat, lon, alt, roll, pitch, yaw = vals[:6]
            if scale is None:
                scale = np.cos(lat * np.pi / 180.0)
            pose = pose_from_oxts(lat, lon, alt, roll, pitch, yaw, scale)
            if origin_inv is None:
                origin_inv = np.linalg.inv(pose)
            poses.append(origin_inv @ pose)
        return np.stack(poses)
