"""Generic directory-of-clouds loader.

Equivalent of the reference GenericDataset (python/kiss_icp/datasets/generic.py:33-151)
but backed by this framework's own numpy readers (kiss_icp_tpu_torch.io.cloud_io)
instead of the open3d/trimesh/pyntcloud cascade. Scans are natural-sorted;
per-point timestamps are sniffed from cloud fields named t/timestamp/.../stamps
and normalized by the odometry preprocessing.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from kiss_icp_tpu_torch.io.cloud_io import natural_sort, read_point_cloud


class GenericDataset:
    def __init__(self, data_dir, *_, **__):
        self.data_dir = Path(data_dir)
        from kiss_icp_tpu_torch.datasets import SUPPORTED_FILE_EXTENSIONS

        files = [
            p
            for p in self.data_dir.glob("*")
            if p.is_file() and p.suffix.lower().lstrip(".") in SUPPORTED_FILE_EXTENSIONS
        ]
        self.scan_files = natural_sort(files)
        if not self.scan_files:
            print(f"[ERROR] No supported point cloud files in {data_dir}", file=sys.stderr)
            raise FileNotFoundError(data_dir)
        self.sequence_id = self.data_dir.name

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, idx):
        points, timestamps = read_point_cloud(self.scan_files[idx])
        if timestamps is None:
            return points.astype(np.float64), np.array([])
        return points.astype(np.float64), timestamps.astype(np.float64)
