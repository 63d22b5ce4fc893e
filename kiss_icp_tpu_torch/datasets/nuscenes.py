"""nuScenes dataset loader (reference datasets/nuscenes.py:32-138).

Requires the optional `nuscenes-devkit`; the import is gated with an
actionable error. GT poses come from ego_pose x calibrated_sensor per LiDAR
sample, re-based to the first pose.
"""

from __future__ import annotations

import importlib
import os
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation


def _quat_wxyz_to_matrix(q) -> np.ndarray:
    w, x, y, z = q
    return Rotation.from_quat([x, y, z, w]).as_matrix()


class NuScenesDataset:
    def __init__(self, data_dir, sequence, *_, **__):
        try:
            self.nusc_mod = importlib.import_module("nuscenes")
        except ImportError as e:
            raise ImportError(
                'nuScenes loader requires the devkit: "pip install nuscenes-devkit"'
            ) from e
        from nuscenes.nuscenes import NuScenes

        self.sequence_id = str(int(sequence)).zfill(4)
        self.data_dir = Path(str(data_dir))
        version = "v1.0-trainval" if (self.data_dir / "v1.0-trainval").exists() else "v1.0-mini"
        self.nusc = NuScenes(dataroot=str(data_dir), version=version)
        self.scene_name = f"scene-{self.sequence_id}"
        scene_names = [s["name"] for s in self.nusc.scene]
        if self.scene_name not in scene_names:
            raise ValueError(
                f"{self.scene_name} not found; available: {sorted(scene_names)}"
            )
        scene = self.nusc.scene[scene_names.index(self.scene_name)]
        self.lidar_tokens = self._get_lidar_tokens(scene)
        self.gt_poses = self._load_poses()

    def __len__(self):
        return len(self.lidar_tokens)

    def __getitem__(self, idx):
        sd = self.nusc.get("sample_data", self.lidar_tokens[idx])
        path = os.path.join(self.nusc.dataroot, sd["filename"])
        # nuScenes .pcd.bin: float32 (N, 5) [x y z intensity ring]
        points = np.fromfile(path, dtype=np.float32).reshape(-1, 5)[:, :3]
        return points.astype(np.float64), np.array([])

    def _get_lidar_tokens(self, scene):
        tokens = []
        sample = self.nusc.get("sample", scene["first_sample_token"])
        sd = self.nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        while sd is not None:
            tokens.append(sd["token"])
            sd = (
                self.nusc.get("sample_data", sd["next"]) if sd["next"] else None
            )
        return tokens

    def _load_poses(self) -> np.ndarray:
        poses = []
        for token in self.lidar_tokens:
            sd = self.nusc.get("sample_data", token)
            ego = self.nusc.get("ego_pose", sd["ego_pose_token"])
            calib = self.nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
            t_ego = np.eye(4)
            t_ego[:3, :3] = _quat_wxyz_to_matrix(ego["rotation"])
            t_ego[:3, 3] = ego["translation"]
            t_sensor = np.eye(4)
            t_sensor[:3, :3] = _quat_wxyz_to_matrix(calib["rotation"])
            t_sensor[:3, 3] = calib["translation"]
            poses.append(t_ego @ t_sensor)
        poses = np.stack(poses)
        return np.linalg.inv(poses[0]) @ poses
