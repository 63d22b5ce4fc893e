"""HeLiPR dataset loader (reference datasets/helipr.py:32-117).

Per-LiDAR binary record layouts (Avia/Aeva/Ouster/Velodyne) decoded with numpy
structured dtypes in one shot — the reference struct-unpacks record by record
in Python (helipr.py:95-108), which is orders of magnitude slower for
million-point scans.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

# numpy equivalents of the reference's struct format strings (helipr.py:46-65).
_LAYOUTS = {
    # NOTE on field widths: the reference formats are '='-prefixed
    # (standard sizes, no padding), so 'L' and 'l' are FOUR bytes — Avia
    # records are 19 bytes ('=fffBBBL') and Aeva 29/25 ('=ffffflB[f]');
    # 8-byte time fields would misalign every record after the first.
    "Avia": dict(
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("r", "u1"), ("g", "u1"), ("b", "u1"), ("t", "<u4")],
        time_field="t",
    ),
    "Aeva": dict(
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("reflectivity", "<f4"),
               ("velocity", "<f4"), ("t", "<i4"), ("line", "u1"), ("intensity", "<f4")],
        dtype_no_intensity=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                            ("reflectivity", "<f4"), ("velocity", "<f4"),
                            ("t", "<i4"), ("line", "u1")],
        time_field="t",
    ),
    "Ouster": dict(
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
               ("t", "<u4"), ("reflectivity", "<u2"), ("ring", "<u2"), ("ambient", "<u2")],
        time_field="t",
    ),
    "Velodyne": dict(
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"),
               ("ring", "<u2"), ("t", "<f4")],
        time_field="t",
    ),
}

# Early Aeva scans carry no intensity field (helipr.py:92-97).
_AEVA_NO_INTENSITY_CUTOFF = 1691936557946849179


class HeLiPRDataset:
    def __init__(self, data_dir, sequence, *_, **__):
        self.sequence_id = str(sequence)
        if self.sequence_id not in _LAYOUTS:
            raise ValueError(
                f"Unsupported HeLiPR LiDAR type '{sequence}' "
                f"(supported: {sorted(_LAYOUTS)})"
            )
        self.sequence_dir = os.path.join(str(data_dir), "LiDAR", self.sequence_id)
        self.scan_files = sorted(glob.glob(os.path.join(self.sequence_dir, "*.bin")))
        if not self.scan_files:
            raise ValueError(f"No point cloud files found in {self.sequence_dir}")
        gt_file = os.path.join(
            str(data_dir), "LiDAR_GT", f"global_{self.sequence_id}_gt.txt"
        )
        if os.path.exists(gt_file):
            self.gt_poses = self._load_poses(gt_file)

    def __len__(self):
        return len(self.scan_files)

    def _dtype_for(self, file_path: str) -> np.dtype:
        layout = _LAYOUTS[self.sequence_id]
        if (
            self.sequence_id == "Aeva"
            and int(Path(file_path).stem) <= _AEVA_NO_INTENSITY_CUTOFF
        ):
            return np.dtype(layout["dtype_no_intensity"])
        return np.dtype(layout["dtype"])

    def __getitem__(self, idx):
        path = self.scan_files[idx]
        dtype = self._dtype_for(path)
        rec = np.fromfile(path, dtype=dtype)
        points = np.stack(
            [rec["x"], rec["y"], rec["z"]], axis=1
        ).astype(np.float64)
        if len(rec) == 0:
            # Zero-record scan (truncated file): an empty frame the pipeline
            # already tolerates, not a numpy reduction crash.
            return points, np.zeros((0,), np.float64)
        t = rec[_LAYOUTS[self.sequence_id]["time_field"]].astype(np.float64)
        span = t.max() - t.min()
        stamps = (t - t.min()) / span if span > 0 else np.zeros_like(t)
        return points, stamps

    def _load_poses(self, poses_file: str) -> np.ndarray:
        """GT rows: [stamp, x, y, z, qx, qy, qz, qw] (helipr.py:75-89)."""
        raw = np.loadtxt(poses_file, delimiter=" ", ndmin=2)
        xyz = raw[:, 1:4]
        rot = Rotation.from_quat(raw[:, 4:8]).as_matrix()
        n = min(len(self), rot.shape[0])
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, :3, :3] = rot[:n]
        poses[:, :3, 3] = xyz[:n]
        return poses
