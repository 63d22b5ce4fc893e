"""rclpy-free core of the ROS 2 odometry node.

All the node's decision logic — parameter→config mapping, base-frame
re-expression through a TF lookup, odometry/TF payload construction, TF
inversion — lives here as plain numpy against abstract interfaces, so it is
unit-testable without a ROS installation (the reference's equivalent logic is
compiled into the rclcpp component, ros/src/OdometryServer.cpp:105-217, and
only testable in a ROS container). The thin rclpy shell in
`odometry_server.py` adapts messages to these calls.

The port of `kiss_icp_tpu/ros/core.py`: the same parameters, defaults and
payloads, plus one node parameter, `device` (default "cuda", the GPU; "cpu"
runs the engine's plain PyTorch path), as the CLI's `--device`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np

from kiss_icp_tpu_torch.config.parser import load_config
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.ros.utils import odometry_covariance, reexpress_in_base_frame

# Parameter set mirroring the reference node's declarations
# (OdometryServer.cpp:105-154), with the engine's options on top.
DEFAULT_PARAMETERS = {
    "pointcloud_topic": "pointcloud_topic",
    "base_frame": "",
    "lidar_odom_frame": "odom_lidar",
    "publish_odom_tf": True,
    "invert_odom_tf": False,
    "publish_debug_clouds": False,
    "max_range": 100.0,
    "min_range": 0.0,
    "deskew": True,
    "voxel_size": -1.0,  # <=0 -> derived max_range / 100
    "max_points_per_voxel": 20,
    "initial_threshold": 2.0,
    "min_motion_th": 0.1,
    "fixed_threshold": -1.0,  # <=0 -> adaptive
    "max_num_iterations": 500,
    "convergence_criterion": 1e-4,
    "position_covariance": 0.1,
    "orientation_covariance": 0.1,
    # Engine scale-out: shard the voxel map over this many devices. The
    # map-sharded engine is not ported yet: > 1 raises NotImplementedError
    # (ROADMAP item 16b). No reference analog — the rclcpp node's map is one
    # robin_map on one host.
    "map_shards": 1,
    # Ground-plane attitude stabilization strength (engine.ground_align,
    # ops/ground.py; 0 = off, reference semantics). A STREAMING node is
    # exactly where the long-horizon pitch drift this fixes accumulates.
    "ground_align": 0.0,
    # Node-level (not part of KISSConfig): warm-start from / persist to an
    # odometry checkpoint (io/checkpoint.py). Empty = disabled. No reference
    # analog — the rclcpp node always starts from an empty map.
    "load_checkpoint": "",
    "save_checkpoint_path": "",
    # Node-level: the torch device the engine runs on. The default needs a
    # GPU and raises without one; the node never falls back to the CPU.
    "device": "cuda",
}


def config_from_params(params: dict) -> KISSConfig:
    """KISSConfig from the ROS parameter dict (defaults as the reference,
    OdometryServer.cpp:105-154, incl. derived voxel_size)."""
    g = lambda n: params.get(n, DEFAULT_PARAMETERS[n])
    cfg = load_config(None)
    cfg.data.max_range = float(g("max_range"))
    cfg.data.min_range = float(g("min_range"))
    cfg.data.deskew = bool(g("deskew"))
    if float(g("voxel_size")) > 0:
        cfg.mapping.voxel_size = float(g("voxel_size"))
    else:
        cfg.mapping.voxel_size = cfg.data.max_range / 100.0
    cfg.mapping.max_points_per_voxel = int(g("max_points_per_voxel"))
    cfg.adaptive_threshold.initial_threshold = float(g("initial_threshold"))
    cfg.adaptive_threshold.min_motion_th = float(g("min_motion_th"))
    if float(g("fixed_threshold")) > 0:
        cfg.adaptive_threshold.fixed_threshold = float(g("fixed_threshold"))
    cfg.registration.max_num_iterations = int(g("max_num_iterations"))
    cfg.registration.convergence_criterion = float(g("convergence_criterion"))
    cfg.engine.map_shards = int(g("map_shards"))
    cfg.engine.ground_align = float(g("ground_align"))
    return cfg


@dataclass
class TransformPayload:
    parent_frame: str
    child_frame: str
    pose: np.ndarray  # (4, 4)


@dataclass
class OdometryPayload:
    frame_id: str
    child_frame_id: str
    pose: np.ndarray  # (4, 4)
    covariance: np.ndarray  # (6, 6)
    tf: Optional[TransformPayload] = None


# tf_lookup(target_frame, source_frame) -> (4,4) T_target_source, or None if
# the transform is not (yet) available.
TfLookup = Callable[[str, str], Optional[np.ndarray]]


@dataclass
class OdometryPublisher:
    """Turns a raw LiDAR-frame pose into the odometry + TF payloads.

    Mirrors OdometryServer::PublishOdometry (OdometryServer.cpp:175-217):
    when `base_frame` is set, the pose is re-expressed through the
    cloud<-base extrinsic obtained from the TF tree (`tf_lookup`), cached
    after the first successful lookup (the extrinsic is static); lookup
    failures fall back to identity ONCE with `extrinsic_warning` set so the
    shell can log it — never silently (reference: tf2 would throw).
    """

    odom_frame: str = "odom_lidar"
    base_frame: str = ""
    publish_odom_tf: bool = True
    invert_odom_tf: bool = False
    position_covariance: float = 0.1
    orientation_covariance: float = 0.1
    tf_lookup: Optional[TfLookup] = None
    _cached_extrinsic: Optional[np.ndarray] = field(default=None, repr=False)
    extrinsic_warning: Optional[str] = field(default=None, repr=False)

    def _cloud_to_base(self, cloud_frame: str) -> np.ndarray:
        if self._cached_extrinsic is not None:
            return self._cached_extrinsic
        t_cb = None
        if self.tf_lookup is not None:
            t_cb = self.tf_lookup(self.base_frame, cloud_frame)
        if t_cb is None:
            if self.extrinsic_warning is None:
                self.extrinsic_warning = (
                    f"TF {self.base_frame} <- {cloud_frame} unavailable; "
                    "publishing odometry WITHOUT base_frame re-expression"
                )
            return np.eye(4)
        self._cached_extrinsic = np.asarray(t_cb, dtype=np.float64)
        return self._cached_extrinsic

    def build(self, pose: np.ndarray, cloud_frame: str) -> OdometryPayload:
        pose = np.asarray(pose, dtype=np.float64)
        # Egocentric when no base_frame or it IS the cloud frame
        # (OdometryServer.cpp:179-186).
        egocentric = (not self.base_frame) or self.base_frame == cloud_frame
        if not egocentric:
            pose = reexpress_in_base_frame(pose, self._cloud_to_base(cloud_frame))
        child = cloud_frame if egocentric else self.base_frame

        tf = None
        if self.publish_odom_tf:
            if self.invert_odom_tf:
                tf = TransformPayload(child, self.odom_frame, np.linalg.inv(pose))
            else:
                tf = TransformPayload(self.odom_frame, child, pose)

        return OdometryPayload(
            frame_id=self.odom_frame,
            child_frame_id=child,
            pose=pose,
            covariance=odometry_covariance(
                self.position_covariance, self.orientation_covariance
            ),
            tf=tf,
        )


def transform_to_matrix(translation_xyz, quat_xyzw) -> np.ndarray:
    """geometry_msgs Transform fields -> (4,4) (for TF2 lookup adaptation)."""
    from kiss_icp_tpu_torch.ros.utils import quat_trans_to_pose

    return quat_trans_to_pose(quat_xyzw, translation_xyz)


def publisher_from_params(params: dict, tf_lookup: Optional[TfLookup] = None
                          ) -> Tuple[KISSConfig, OdometryPublisher]:
    """One-call construction of (engine config, publisher) from parameters."""
    g = lambda n: params.get(n, DEFAULT_PARAMETERS[n])
    pub = OdometryPublisher(
        odom_frame=str(g("lidar_odom_frame")),
        base_frame=str(g("base_frame")),
        publish_odom_tf=bool(g("publish_odom_tf")),
        invert_odom_tf=bool(g("invert_odom_tf")),
        position_covariance=float(g("position_covariance")),
        orientation_covariance=float(g("orientation_covariance")),
        tf_lookup=tf_lookup,
    )
    return config_from_params(params), pub
