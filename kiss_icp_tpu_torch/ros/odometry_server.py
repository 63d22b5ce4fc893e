"""ROS 2 odometry node backed by the port's GPU odometry engine.

Equivalent of the reference's C++ OdometryServer component
(ros/src/OdometryServer.{hpp:41-92,cpp:74-231}): subscribes to one PointCloud2
topic, runs register_frame per message, publishes nav_msgs/Odometry, an
optional TF (optionally inverted, optionally re-expressed in a base frame via
the TF2-resolved cloud<-base extrinsic), and optional debug clouds (deskewed
frame, keypoints, local map).

The reference writes this node in C++ because its whole compute core is C++;
here the per-frame compute is the port's step on the GPU (the CUDA kernels
K1 and K2 in each ICP iteration), and the node shell is rclpy (message
plumbing at sensor rate, ~10 Hz, which Python handles with margin). The
engine runs on the device named by the node parameter `device` (default
"cuda"; "cpu" for the plain PyTorch path); without a GPU the default raises.
ALL decision logic lives rclpy-free in `ros/core.py`
(parameter mapping, base-frame conjugation, TF payload construction) so it is
unit-tested without a ROS installation; this module only adapts messages.

Composition: the reference node is an rclcpp *component* loadable into a
shared-process container (OdometryServer.cpp:74, RCLCPP_COMPONENTS_REGISTER_
NODE). rclcpp containers cannot host Python nodes, so the rclpy analog is
process-level composition on one executor: `get_node_class()` exposes the
node as a composable class and `kiss_icp_tpu_torch.ros.container` spins it together
with any other rclpy nodes in a single process (one DDS participant, intra-
process delivery where rclpy supports it). See container.py.

Run inside a ROS 2 environment:
    python -m kiss_icp_tpu_torch.ros.odometry_server
or composed:  python -m kiss_icp_tpu_torch.ros.container [extra node factories]
"""

from __future__ import annotations

import numpy as np

from kiss_icp_tpu_torch.ros import core

_NODE_CLASS = None


def get_node_class():
    """Build (once) and return the OdometryServer rclpy Node class.

    A factory rather than a module-level class so importing this module
    never requires rclpy (the rest of the package is ROS-free)."""
    global _NODE_CLASS
    if _NODE_CLASS is not None:
        return _NODE_CLASS
    try:
        import rclpy
        from rclpy.node import Node
        from rclpy.qos import (
            QoSDurabilityPolicy, QoSProfile, QoSReliabilityPolicy,
        )
        from geometry_msgs.msg import TransformStamped
        from nav_msgs.msg import Odometry
        from sensor_msgs.msg import PointCloud2, PointField
        from tf2_ros import TransformBroadcaster
        from tf2_ros.buffer import Buffer
        from tf2_ros.transform_listener import TransformListener
    except ImportError as e:
        raise ImportError(
            "ROS 2 (rclpy + common msgs + tf2_ros) is required for the node"
        ) from e

    from kiss_icp_tpu_torch.odometry import create_odometry
    from kiss_icp_tpu_torch.ros.utils import pose_to_quat_trans
    from kiss_icp_tpu_torch.tools.point_cloud2 import read_point_cloud

    class OdometryServer(Node):
        def __init__(self):
            super().__init__("kiss_icp_tpu_node")
            for name, default in core.DEFAULT_PARAMETERS.items():
                self.declare_parameter(name, default)
            params = {
                name: self.get_parameter(name).value
                for name in core.DEFAULT_PARAMETERS
            }

            # TF2 buffer for the base_frame extrinsic, exactly like the
            # reference's LookupTransform (OdometryServer.cpp:175-186).
            self.tf_buffer = Buffer()
            self.tf_listener = TransformListener(self.tf_buffer, self)

            def tf_lookup(target: str, source: str):
                try:
                    t = self.tf_buffer.lookup_transform(
                        target, source, rclpy.time.Time()
                    )
                except Exception:
                    return None
                tr, q = t.transform.translation, t.transform.rotation
                return core.transform_to_matrix(
                    (tr.x, tr.y, tr.z), (q.x, q.y, q.z, q.w)
                )

            cfg, self.publisher_core = core.publisher_from_params(params, tf_lookup)
            self.odometry = create_odometry(cfg, device=str(params["device"]))
            if str(params["load_checkpoint"]):
                self.odometry.load_checkpoint(str(params["load_checkpoint"]))
                self.get_logger().info(
                    f"warm-started from checkpoint {params['load_checkpoint']}"
                )
            self._save_checkpoint_path = str(params["save_checkpoint_path"])
            self.publish_debug_clouds = bool(params["publish_debug_clouds"])

            qos = QoSProfile(
                depth=10,
                reliability=QoSReliabilityPolicy.RELIABLE,
                durability=QoSDurabilityPolicy.VOLATILE,
            )
            self.odom_pub = self.create_publisher(Odometry, "kiss/odometry", qos)
            self.tf_broadcaster = TransformBroadcaster(self)
            if self.publish_debug_clouds:
                self.frame_pub = self.create_publisher(PointCloud2, "kiss/frame", qos)
                self.kpoints_pub = self.create_publisher(
                    PointCloud2, "kiss/keypoints", qos
                )
                self.map_pub = self.create_publisher(PointCloud2, "kiss/local_map", qos)
            self.create_subscription(
                PointCloud2, str(params["pointcloud_topic"]),
                self.register_frame, qos,
            )
            self.get_logger().info("kiss_icp_tpu odometry node ready")

        # --- per-message callback (reference OdometryServer.cpp:156-173) ---
        def register_frame(self, msg):
            points, timestamps = read_point_cloud(msg)
            self.odometry.register_frame_lazy(points, timestamps)
            pose = self.odometry.last_pose
            # Rolling-origin envelope check (the pose was just materialized,
            # so it's read-free): a streaming node is exactly the unbounded-
            # drive deployment the re-base exists for. Published world poses
            # are continuous across the roll (last_pose = origin + local).
            self.odometry.maybe_rebase(pose[:3, 3])
            # Loud-counter contract: surface capacity overflow once, like
            # the pipeline driver does.
            drops = self.odometry.last_overflow()
            if any(drops) and not getattr(self, "_warned_overflow", False):
                self._warned_overflow = True
                self.get_logger().warning(
                    f"capacity overflow: downsample={drops[0]} map={drops[1]}"
                    f" input={drops[2]} out-of-envelope={drops[3]} points/"
                    "voxels dropped this frame — raise the engine "
                    "capacities (see EngineConfig)"
                )
            payload = self.publisher_core.build(pose, msg.header.frame_id)
            if self.publisher_core.extrinsic_warning:
                self.get_logger().warning(self.publisher_core.extrinsic_warning)
                self.publisher_core.extrinsic_warning = None
            self.publish_odometry(payload, msg.header)
            if self.publish_debug_clouds:
                self.publish_clouds(msg.header)

        def publish_odometry(self, payload: core.OdometryPayload, header):
            q, t = pose_to_quat_trans(payload.pose)
            odom = Odometry()
            odom.header.stamp = header.stamp
            odom.header.frame_id = payload.frame_id
            odom.child_frame_id = payload.child_frame_id
            odom.pose.pose.position.x, odom.pose.pose.position.y, odom.pose.pose.position.z = t
            (odom.pose.pose.orientation.x, odom.pose.pose.orientation.y,
             odom.pose.pose.orientation.z, odom.pose.pose.orientation.w) = q
            odom.pose.covariance = list(payload.covariance.ravel())
            self.odom_pub.publish(odom)

            if payload.tf is not None:
                tfm = TransformStamped()
                tfm.header.stamp = header.stamp
                tfm.header.frame_id = payload.tf.parent_frame
                tfm.child_frame_id = payload.tf.child_frame
                q, t = pose_to_quat_trans(payload.tf.pose)
                tfm.transform.translation.x, tfm.transform.translation.y, tfm.transform.translation.z = t
                (tfm.transform.rotation.x, tfm.transform.rotation.y,
                 tfm.transform.rotation.z, tfm.transform.rotation.w) = q
                self.tf_broadcaster.sendTransform(tfm)

        def publish_clouds(self, header):
            self.frame_pub.publish(self._to_pc2(self.odometry.last_frame(), header))
            self.kpoints_pub.publish(self._to_pc2(self.odometry.last_source(), header))
            map_header = type(header)()
            map_header.stamp = header.stamp
            map_header.frame_id = self.publisher_core.odom_frame
            self.map_pub.publish(
                self._to_pc2(self.odometry.local_map_points(), map_header)
            )

        def save_checkpoint_if_configured(self):
            if self._save_checkpoint_path:
                self.odometry.save_checkpoint(self._save_checkpoint_path)
                self.get_logger().info(
                    f"odometry state saved to {self._save_checkpoint_path}"
                )

        @staticmethod
        def _to_pc2(points, header):
            msg = PointCloud2()
            msg.header = header
            msg.height = 1
            msg.width = len(points)
            msg.fields = [
                PointField(name=n, offset=4 * i, datatype=PointField.FLOAT32, count=1)
                for i, n in enumerate("xyz")
            ]
            msg.is_bigendian = False
            msg.point_step = 12
            msg.row_step = 12 * len(points)
            msg.data = np.asarray(points, np.float32).tobytes()
            msg.is_dense = True
            return msg

    _NODE_CLASS = OdometryServer
    return OdometryServer


def main(args=None):
    import rclpy

    node_class = get_node_class()
    rclpy.init(args=args)
    node = node_class()
    try:
        rclpy.spin(node)
    finally:
        node.save_checkpoint_if_configured()
        node.destroy_node()
        rclpy.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
