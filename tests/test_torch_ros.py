"""The port's ROS 2 node (kiss_icp_tpu_torch.ros) against the JAX package's.

The counterparts of tests/test_ros_utils.py, test_ros_core.py,
test_ros_container.py and test_ros_node_shell.py, each run on both packages
with the same inputs:
  * utils and core (float64 numpy): equal to JAX's within 1e-12;
  * the container's argument split: equal;
  * the rclpy shell, under test_ros_node_shell.py's fake rclpy / msgs / tf2
    modules with the node parameter `device` = "cpu": the poses it publishes
    on the same messages within 1e-4 m of the JAX node's, and the checkpoint
    `main()` writes on shutdown loads into both packages.
Without a GPU the node's default device raises: it never falls back to the
CPU.
"""

import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import oracle
import test_ros_node_shell as shell
from kiss_icp_tpu.config.schema import config_to_dict as jax_config_to_dict
from kiss_icp_tpu.odometry import KissICP as JaxKissICP
from kiss_icp_tpu.ros import container as jcontainer
from kiss_icp_tpu.ros import core as jcore
from kiss_icp_tpu.ros import odometry_server as jserver
from kiss_icp_tpu.ros import utils as jutils
from kiss_icp_tpu_torch.config.schema import config_to_dict
from kiss_icp_tpu_torch.odometry import KissICP
from kiss_icp_tpu_torch.ros import container, core, odometry_server, utils

torch.set_num_threads(1)

POSE_ATOL = 1e-4  # the port's poses against JAX's (tests/test_torch_odometry.py)


# ------------------------------------------------------------------ utils
def test_pose_quat_roundtrip_equals_jax():
    pose = oracle.se3_exp(np.random.default_rng(0).standard_normal(6))
    q, t = utils.pose_to_quat_trans(pose)
    jq, jt = jutils.pose_to_quat_trans(pose)
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-12)
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-12)
    back = utils.quat_trans_to_pose(q, t)
    np.testing.assert_allclose(back, jutils.quat_trans_to_pose(jq, jt), rtol=0, atol=1e-12)
    np.testing.assert_allclose(back, pose, atol=1e-9)


def test_reexpress_in_base_frame_equals_jax():
    rng = np.random.default_rng(1)
    pose = oracle.se3_exp(rng.standard_normal(6) * 0.5)
    t_cb = oracle.se3_exp(rng.standard_normal(6) * 0.2)
    out = utils.reexpress_in_base_frame(pose, t_cb)
    np.testing.assert_allclose(out, jutils.reexpress_in_base_frame(pose, t_cb), rtol=0, atol=1e-12)
    np.testing.assert_allclose(out, t_cb @ pose @ np.linalg.inv(t_cb), atol=1e-12)
    np.testing.assert_allclose(utils.reexpress_in_base_frame(pose, np.eye(4)), pose, atol=1e-12)


def test_odometry_covariance_equals_jax():
    cov = utils.odometry_covariance(0.2, 0.3)
    np.testing.assert_array_equal(cov, jutils.odometry_covariance(0.2, 0.3))
    np.testing.assert_allclose(np.diag(cov), [0.2, 0.2, 0.2, 0.3, 0.3, 0.3])
    np.testing.assert_array_equal(utils.odometry_covariance(), jutils.odometry_covariance())


# ------------------------------------------------------------------- core
def _pose(yaw=0.3, t=(5.0, -2.0, 0.5)):
    p = np.eye(4)
    p[:3, :3] = Rotation.from_euler("z", yaw).as_matrix()
    p[:3, 3] = t
    return p


def _extrinsic():
    e = np.eye(4)
    e[:3, :3] = Rotation.from_euler("xyz", [0.05, -0.02, 1.2]).as_matrix()
    e[:3, 3] = (0.8, 0.0, -1.5)
    return e


def _assert_payloads_equal(got, ref):
    assert (got.frame_id, got.child_frame_id) == (ref.frame_id, ref.child_frame_id)
    np.testing.assert_allclose(got.pose, ref.pose, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.covariance, ref.covariance)
    assert (got.tf is None) == (ref.tf is None)
    if ref.tf is not None:
        assert (got.tf.parent_frame, got.tf.child_frame) == (ref.tf.parent_frame,
                                                             ref.tf.child_frame)
        np.testing.assert_allclose(got.tf.pose, ref.tf.pose, rtol=0, atol=1e-12)


def _both(**kw):
    """The same publisher from each package."""
    return core.OdometryPublisher(**kw), jcore.OdometryPublisher(**kw)


def test_default_parameters_are_jax_plus_device():
    assert {k: v for k, v in core.DEFAULT_PARAMETERS.items() if k != "device"} == \
        jcore.DEFAULT_PARAMETERS
    assert core.DEFAULT_PARAMETERS["device"] == "cuda"
    assert list(core.DEFAULT_PARAMETERS)[:-1] == list(jcore.DEFAULT_PARAMETERS)


@pytest.mark.parametrize("params", [
    {},
    {"max_range": 50.0, "voxel_size": 0.5, "fixed_threshold": 0.3, "deskew": False},
    {"min_range": 2.0, "max_num_iterations": 30, "ground_align": 0.1, "device": "cpu"},
], ids=["defaults", "overrides", "engine"])
def test_config_from_params_equals_jax(params):
    cfg = core.config_from_params(params)
    jparams = {k: v for k, v in params.items() if k != "device"}
    assert config_to_dict(cfg) == jax_config_to_dict(jcore.config_from_params(jparams))
    if not params:
        assert cfg.data.max_range == 100.0 and cfg.mapping.voxel_size == 1.0
        assert cfg.adaptive_threshold.fixed_threshold is None
        assert cfg.registration.max_num_iterations == 500


def test_egocentric_no_base_frame_equals_jax():
    pub, jpub = _both(odom_frame="odom", base_frame="")
    out = pub.build(_pose(), "lidar")
    _assert_payloads_equal(out, jpub.build(_pose(), "lidar"))
    assert (out.frame_id, out.child_frame_id) == ("odom", "lidar")
    assert (out.tf.parent_frame, out.tf.child_frame) == ("odom", "lidar")


def test_base_frame_equals_cloud_frame_is_egocentric_as_jax():
    calls = []
    pub, jpub = _both(base_frame="lidar",
                      tf_lookup=lambda *a: calls.append(a) or np.eye(4))
    _assert_payloads_equal(pub.build(_pose(), "lidar"), jpub.build(_pose(), "lidar"))
    assert not calls


def test_base_frame_conjugation_through_tf_equals_jax():
    ext = _extrinsic()
    looked_up = []

    def lookup(target, source):
        looked_up.append((target, source))
        return ext

    pub, jpub = _both(base_frame="base_link", tf_lookup=lookup)
    out = pub.build(_pose(), "lidar")
    _assert_payloads_equal(out, jpub.build(_pose(), "lidar"))
    np.testing.assert_allclose(out.pose, ext @ _pose() @ np.linalg.inv(ext), atol=1e-12)
    assert looked_up == [("base_link", "lidar")] * 2 and pub.extrinsic_warning is None
    pub.build(_pose(), "lidar")  # the cached extrinsic: no new lookup
    assert len(looked_up) == 2


def test_missing_tf_falls_back_to_identity_with_warning_as_jax():
    pub, jpub = _both(base_frame="base_link", tf_lookup=lambda *a: None)
    _assert_payloads_equal(pub.build(_pose(), "lidar"), jpub.build(_pose(), "lidar"))
    assert pub.extrinsic_warning == jpub.extrinsic_warning
    assert "base_link" in pub.extrinsic_warning


def test_inverted_tf_equals_jax():
    pub, jpub = _both(odom_frame="odom", invert_odom_tf=True)
    out = pub.build(_pose(), "lidar")
    _assert_payloads_equal(out, jpub.build(_pose(), "lidar"))
    assert (out.tf.parent_frame, out.tf.child_frame) == ("lidar", "odom")


def test_tf_disabled_as_jax():
    pub, jpub = _both(publish_odom_tf=False)
    _assert_payloads_equal(pub.build(_pose(), "lidar"), jpub.build(_pose(), "lidar"))
    assert pub.build(_pose(), "lidar").tf is None


def test_transform_to_matrix_equals_jax():
    ext = _extrinsic()
    q = Rotation.from_matrix(ext[:3, :3]).as_quat()
    m = core.transform_to_matrix(ext[:3, 3], q)
    np.testing.assert_allclose(m, jcore.transform_to_matrix(ext[:3, 3], q), rtol=0, atol=1e-12)
    np.testing.assert_allclose(m, ext, atol=1e-12)


def test_publisher_from_params_equals_jax():
    params = {"lidar_odom_frame": "map", "base_frame": "base", "invert_odom_tf": True,
              "position_covariance": 0.5}
    cfg, pub = core.publisher_from_params(params)
    jcfg, jpub = jcore.publisher_from_params(params)
    assert config_to_dict(cfg) == jax_config_to_dict(jcfg)
    assert (pub.odom_frame, pub.base_frame, pub.invert_odom_tf, pub.position_covariance) == \
        (jpub.odom_frame, jpub.base_frame, jpub.invert_odom_tf, jpub.position_covariance)
    _assert_payloads_equal(pub.build(_pose(), "base"), jpub.build(_pose(), "base"))
    assert pub.build(_pose(), "base").covariance[0, 0] == 0.5


# -------------------------------------------------------------- container
@pytest.mark.parametrize("argv", [
    ["--ros-args", "-r", "__node:=kiss_icp_tpu_container", "-p", "pointcloud_topic:=/points",
     "topic:=/points"],
    ["my_pkg.viz:make_node other.mod:factory"],
    ["", "my_pkg.viz:make_node", "--ros-args", "-p", "x:=1"],
], ids=["ros-tokens", "one-token-specs", "mixed"])
def test_split_specs_equals_jax(argv):
    assert container.split_specs(argv) == jcontainer.split_specs(argv)


def test_spec_shape_equals_jax():
    for spec in ("a.b.c:factory", "a.b:=value", "-r", "a:b:c", "x:y"):
        assert bool(container._SPEC_RE.match(spec)) == bool(jcontainer._SPEC_RE.match(spec))


# --------------------------------------------------------------- the node
@pytest.fixture
def ros_env(monkeypatch):
    """test_ros_node_shell.py's fake ROS modules, and its small engine for
    both packages' nodes; the port's node on the CPU."""
    for name, mod in shell._fake_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    for server in (odometry_server, jserver):
        monkeypatch.setattr(server, "_NODE_CLASS", None)
    monkeypatch.setattr(shell._FakeNode, "PARAM_OVERRIDES", {})
    for mod in (core, jcore):
        orig = mod.config_from_params

        def small(params, orig=orig):
            cfg = orig(params)
            cfg.engine.max_points_per_frame = 8192
            cfg.engine.frame_capacity = 4096
            cfg.engine.source_capacity = 1024
            cfg.engine.map_capacity_log2 = 15
            cfg.engine.donate_state = False
            cfg.registration.max_num_iterations = 30
            return cfg

        monkeypatch.setattr(mod, "config_from_params", small)
    yield


def _node(server, overrides):
    shell._FakeNode.PARAM_OVERRIDES.clear()
    shell._FakeNode.PARAM_OVERRIDES.update({"max_range": 50.0, "min_range": 1.0,
                                            "voxel_size": 0.5, "device": "cpu", **overrides})
    return server.get_node_class()()


def _pub(node, topic):
    return next(p for p in node.publishers if p.topic == topic)


def _odom_pose(msg):
    p, q = msg.pose.pose.position, msg.pose.pose.orientation
    return utils.quat_trans_to_pose([q.x, q.y, q.z, q.w], [p.x, p.y, p.z])


def _tf_pose(tfm):
    t, q = tfm.transform.translation, tfm.transform.rotation
    return utils.quat_trans_to_pose([q.x, q.y, q.z, q.w], [t.x, t.y, t.z])


def _stream(overrides, msgs_of, frames):
    """Both nodes on the same messages; returns (port node, JAX node)."""
    nodes = []
    for server in (odometry_server, jserver):
        node = _node(server, overrides)
        (_, callback), = node.subscriptions
        for i, pts in enumerate(frames):
            callback(msgs_of(i, pts))
        nodes.append(node)
    return nodes


def test_node_stream_publishes_odometry_tf_and_debug_clouds_as_jax(ros_env):
    frames = shell._scan_frames(3)
    node, jnode = _stream({"pointcloud_topic": "/points", "publish_debug_clouds": True},
                          lambda i, p: shell._cloud_msg(p, with_stamps=True), frames)
    assert type(node.odometry).__module__ == "kiss_icp_tpu_torch.odometry"
    assert node.odometry.device.type == "cpu"
    assert node.node_name == jnode.node_name == "kiss_icp_tpu_node"
    assert node.subscriptions[0][0] == "/points"
    assert "ready" in node.get_logger().infos[-1]
    odom, jodom = _pub(node, "kiss/odometry").msgs, _pub(jnode, "kiss/odometry").msgs
    assert len(odom) == len(jodom) == 3
    for m, jm in zip(odom, jodom):
        assert (m.header.frame_id, m.child_frame_id) == (jm.header.frame_id, jm.child_frame_id)
        np.testing.assert_allclose(_odom_pose(m), _odom_pose(jm), rtol=0, atol=POSE_ATOL)
        assert list(m.pose.covariance) == list(jm.pose.covariance)
    assert np.linalg.norm(_odom_pose(odom[-1])[:3, 3]) > 0.01  # the sensor moved
    sent, jsent = node.tf_broadcaster.sent, jnode.tf_broadcaster.sent
    assert len(sent) == len(jsent) == 3
    assert (sent[-1].header.frame_id, sent[-1].child_frame_id) == ("odom_lidar", "lidar")
    np.testing.assert_allclose(_tf_pose(sent[-1]), _tf_pose(jsent[-1]), rtol=0, atol=POSE_ATOL)
    for topic in ("kiss/frame", "kiss/keypoints", "kiss/local_map"):
        clouds, jclouds = _pub(node, topic).msgs, _pub(jnode, topic).msgs
        assert len(clouds) == len(jclouds) == 3
        last = clouds[-1]
        assert last.header.frame_id == jclouds[-1].header.frame_id
        assert last.point_step == 12 and len(last.data) == last.row_step > 0
    assert _pub(node, "kiss/local_map").msgs[-1].header.frame_id == "odom_lidar"


def test_node_inverted_tf_as_jax(ros_env):
    node, jnode = _stream({"invert_odom_tf": True}, lambda i, p: shell._cloud_msg(p),
                          shell._scan_frames(1))
    tfm, jtfm = node.tf_broadcaster.sent[-1], jnode.tf_broadcaster.sent[-1]
    assert (tfm.header.frame_id, tfm.child_frame_id) == ("lidar", "odom_lidar")
    assert (tfm.header.frame_id, tfm.child_frame_id) == (jtfm.header.frame_id, jtfm.child_frame_id)
    np.testing.assert_allclose(_tf_pose(tfm), _tf_pose(jtfm), rtol=0, atol=POSE_ATOL)


def test_node_base_frame_retries_lookup_and_conjugates_as_jax(ros_env):
    frames = shell._scan_frames(3)
    runs = []
    for server in (odometry_server, jserver):
        node = _node(server, {"base_frame": "base_link"})
        (_, callback), = node.subscriptions
        callback(shell._cloud_msg(frames[0]))
        callback(shell._cloud_msg(frames[1]))
        warned = len(node.get_logger().warnings)
        t = shell.TransformStamped()
        t.transform.translation.x = 0.5
        node.tf_buffer.transforms[("base_link", "lidar")] = t
        callback(shell._cloud_msg(frames[2]))
        runs.append((warned, len(node.get_logger().warnings), node.tf_broadcaster.sent[-1]))
    (w, w_after, tfm), (jw, jw_after, jtfm) = runs
    assert (w, w_after) == (jw, jw_after) == (2, 2)
    assert tfm.child_frame_id == jtfm.child_frame_id == "base_link"
    np.testing.assert_allclose(_tf_pose(tfm), _tf_pose(jtfm), rtol=0, atol=POSE_ATOL)


def test_main_saves_checkpoint_on_shutdown_that_both_packages_load(ros_env, monkeypatch, tmp_path):
    """main() with the fake spin delivering three messages: the checkpoint
    written on shutdown holds the node's pose, loads into the port and into
    the JAX package, and warm-starts a fresh node."""
    frames = shell._scan_frames(3)
    spun = []

    def spin(node):
        (_, callback), = node.subscriptions
        for pts in frames:
            callback(shell._cloud_msg(pts, with_stamps=True))
        spun.append(node)

    monkeypatch.setattr(sys.modules["rclpy"], "spin", spin)
    ckpt = tmp_path / "state.npz"
    shell._FakeNode.PARAM_OVERRIDES.update({"max_range": 50.0, "min_range": 1.0,
                                            "voxel_size": 0.5, "device": "cpu",
                                            "save_checkpoint_path": str(ckpt)})
    odometry_server.main(args=None)
    assert ckpt.exists() and spun[0].destroyed
    pose = spun[0].odometry.last_pose
    jnode = _stream({}, lambda i, p: shell._cloud_msg(p, with_stamps=True), frames)[1]
    np.testing.assert_allclose(pose, jnode.odometry.last_pose, rtol=0, atol=POSE_ATOL)

    cfg = core.config_from_params({"max_range": 50.0, "min_range": 1.0, "voxel_size": 0.5})
    port = KissICP(cfg, device="cpu")
    port.load_checkpoint(ckpt)
    np.testing.assert_array_equal(port.last_pose, pose)
    jax = JaxKissICP(jcore.config_from_params({"max_range": 50.0, "min_range": 1.0,
                                               "voxel_size": 0.5}))
    jax.load_checkpoint(ckpt)
    np.testing.assert_allclose(jax.last_pose, pose, rtol=0, atol=1e-12)
    assert len(jax.local_map_points()) == len(port.local_map_points()) > 0

    node = _node(odometry_server, {"load_checkpoint": str(ckpt)})
    assert any("warm-started" in m for m in node.get_logger().infos)
    np.testing.assert_array_equal(node.odometry.last_pose, pose)


def test_container_composes_nodes_on_one_executor(ros_env, tmp_path):
    ckpt = tmp_path / "composed.npz"
    shell._FakeNode.PARAM_OVERRIDES.update({"max_range": 50.0, "min_range": 1.0,
                                            "voxel_size": 0.5, "device": "cpu",
                                            "save_checkpoint_path": str(ckpt)})
    container.main(["test_ros_node_shell:_extra_node_factory"])
    assert ckpt.exists()


def test_node_default_device_needs_a_gpu(ros_env, monkeypatch):
    """No device parameter: the node asks for CUDA and raises without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shell._FakeNode.PARAM_OVERRIDES.update({"max_range": 50.0, "voxel_size": 0.5})
    with pytest.raises(RuntimeError, match="CUDA"):
        odometry_server.get_node_class()()


def test_node_map_shards_raise_naming_item_16(ros_env):
    """`map_shards` = 2 no longer raises: both nodes run their map-sharded
    engine on the same messages and publish the same poses."""
    from kiss_icp_tpu_torch.parallel.sharded_engine import ShardedKissICP

    node, jnode = _stream({"map_shards": 2, "publish_debug_clouds": True},
                          lambda i, p: shell._cloud_msg(p, with_stamps=True),
                          shell._scan_frames(3))
    assert isinstance(node.odometry, ShardedKissICP)
    assert type(jnode.odometry).__name__ == "ShardedKissICP"
    assert node.odometry.mesh.shape["map"] == 2 and node.odometry.device.type == "cpu"
    odom, jodom = _pub(node, "kiss/odometry").msgs, _pub(jnode, "kiss/odometry").msgs
    assert len(odom) == len(jodom) == 3
    for m, jm in zip(odom, jodom):
        np.testing.assert_allclose(_odom_pose(m), _odom_pose(jm), rtol=0, atol=POSE_ATOL)
    assert len(_pub(node, "kiss/local_map").msgs[-1].data) > 0
