"""Pure-numpy helpers for the ROS 2 odometry node.

Equivalent of the reference's ros/src/Utils.hpp:44-226 message<->Eigen
conversion layer, kept free of rclpy imports so the geometry is unit-testable
anywhere.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Fixed odometry covariance used by the reference node
# (OdometryServer.cpp:175-217 fills position/orientation covariance diagonals).
DEFAULT_POSITION_COVARIANCE = 0.1
DEFAULT_ORIENTATION_COVARIANCE = 0.1


def pose_to_quat_trans(pose: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(4,4) -> (quaternion xyzw, translation)."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(pose[:3, :3]).as_quat()
    return q, pose[:3, 3].copy()


def quat_trans_to_pose(quat_xyzw, trans) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    pose = np.eye(4)
    pose[:3, :3] = Rotation.from_quat(np.asarray(quat_xyzw)).as_matrix()
    pose[:3, 3] = trans
    return pose


def reexpress_in_base_frame(pose: np.ndarray, t_base_cloud: np.ndarray) -> np.ndarray:
    """T' = T_bc . T . T_bc^-1: express the LiDAR-frame odometry in a base
    frame given the base<-cloud extrinsic `T_bc` — i.e. the cloud-to-base
    transform a TF lookup(target=base, source=cloud) returns, the matrix
    the reference names `cloud2base` (`cloud2base * pose *
    cloud2base.inverse()`, OdometryServer.cpp:181-186). The node publishes
    the conjugated pose when `base_frame` is set. (The parameter was
    previously named/documented as the INVERSE extrinsic — a caller
    supplying that matrix would re-express in the wrong frame.)"""
    inv = np.linalg.inv(t_base_cloud)
    return t_base_cloud @ pose @ inv


def odometry_covariance(
    position_cov: float = DEFAULT_POSITION_COVARIANCE,
    orientation_cov: float = DEFAULT_ORIENTATION_COVARIANCE,
) -> np.ndarray:
    """6x6 pose covariance, diagonal (x, y, z, roll, pitch, yaw)."""
    cov = np.zeros((6, 6))
    cov[0, 0] = cov[1, 1] = cov[2, 2] = position_cov
    cov[3, 3] = cov[4, 4] = cov[5, 5] = orientation_cov
    return cov
