"""TUM RGB-D dataset loader (reference datasets/tum.py:31-96).

Depth PNGs are back-projected to clouds with the PrimeSense pinhole intrinsics
directly in numpy (the reference routes through open3d's RGBDImage; the
geometry is identical). GT poses are matched to depth frames by nearest
timestamp.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

# PrimeSense default pinhole model (open3d PinholeCameraIntrinsicParameters).
_FX, _FY, _CX, _CY = 525.0, 525.0, 319.5, 239.5
_DEPTH_SCALE = 5000.0  # TUM depth PNGs store depth * 5000
_DEPTH_TRUNC = 4.0  # meters; open3d create_from_tum_format default truncation


class TUMDataset:
    def __init__(self, data_dir, *_, **__):
        try:
            from PIL import Image  # noqa: F401
        except ImportError as e:
            raise ImportError("TUM loader needs PIL (pillow) for depth PNGs") from e
        self.data_dir = Path(str(data_dir))
        self.sequence_id = os.path.basename(str(data_dir))
        self.depth_frames = np.loadtxt(self.data_dir / "depth.txt", dtype=str)
        gt_file = self.data_dir / "groundtruth.txt"
        if gt_file.exists():
            gt_list = np.loadtxt(gt_file, dtype=str)
            self.gt_poses = self._load_poses(gt_list)

    def __len__(self):
        return len(self.depth_frames)

    def _load_poses(self, gt_list) -> np.ndarray:
        """One GT pose per depth frame by nearest timestamp (tum.py:60-79)."""
        gt_t = gt_list[:, 0].astype(np.float64)
        frame_t = self.depth_frames[:, 0].astype(np.float64)
        # One GT row per frame, duplicates KEPT: the reference's np.unique
        # (tum.py:63) collapses frames that share a nearest GT row (mocap
        # gaps), making len(gt_poses) < len(dataset) — which silently
        # disables the pipeline's evaluation and misaligns the written GT
        # file. Nearest-index per frame preserves the documented 1:1
        # contract.
        indices = np.abs(np.subtract.outer(gt_t, frame_t)).argmin(0)
        xyz = gt_list[indices][:, 1:4].astype(np.float64)
        quat_xyzw = gt_list[indices][:, 4:8].astype(np.float64)
        rot = Rotation.from_quat(quat_xyzw).as_matrix()
        poses = np.tile(np.eye(4), (rot.shape[0], 1, 1))
        poses[:, :3, :3] = rot
        poses[:, :3, 3] = xyz
        return poses

    def get_frames_timestamps(self):
        return self.depth_frames[:, 0].astype(np.float64)

    def __getitem__(self, idx):
        from PIL import Image

        depth_path = self.data_dir / self.depth_frames[idx][-1]
        depth = np.asarray(Image.open(depth_path), dtype=np.float64) / _DEPTH_SCALE
        h, w = depth.shape
        u, v = np.meshgrid(np.arange(w), np.arange(h))
        valid = (depth > 0) & (depth < _DEPTH_TRUNC)
        z = depth[valid]
        x = (u[valid] - _CX) * z / _FX
        y = (v[valid] - _CY) * z / _FY
        return np.stack([x, y, z], axis=1), np.array([])
