"""The pod program (kiss_icp_tpu_torch.parallel.pod: B sequences x map
shards) against the JAX package's `parallel/pod.py` on a 2 x 2 mesh of its
8-device CPU mesh, on the CPU.

Tolerances: per sequence and frame within 1e-4 m of JAX's pod with equal
iterations (as the map-sharded step, tests/test_torch_sharded_map.py);
each sequence within 1e-5 m of the port's own map-sharded drive of it
(tests/test_pod.py:64).
"""

import jax
import numpy as np
import pytest
import torch

from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.parallel import pod as jpod
from kiss_icp_tpu_torch import convert
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.parallel import pod, sharded_map

torch.set_num_threads(1)


def _config(cls):
    """tests/test_pod.py's `_config`."""
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 2048
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 14
    cfg.engine.donate_state = False
    cfg.registration.max_num_iterations = 12
    return cfg


def _frames(b, k, n, seed=0):
    """tests/test_pod.py's `_frames`: (B, K, N, 3), each sequence at its own
    velocity over one base cloud."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    pts = np.zeros((b, k, n, 3), np.float32)
    for i in range(b):
        vel = np.array([0.2 + 0.1 * i, 0.03 * i, 0], np.float32)
        for j in range(k):
            pts[i, j] = base + vel * j
    return pts, np.zeros((b, k, n), np.float32), np.ones((b, k, n), bool)


def test_pod_matches_jax():
    b, k = 4, 3
    jcfg, cfg = _config(JaxConfig), _config(KISSConfig)
    pts, ts, valid = _frames(b, k, cfg.engine.max_points_per_frame)
    jmesh = jpod.make_pod_mesh(2, 2)
    _, jres = jpod.make_pod_chunked_step(jcfg, jmesh)(jpod.init_pod_state(jcfg, jmesh, b),
                                                      pts, ts, valid)
    mesh = pod.make_pod_mesh(2, 2, device="cpu")
    state, res = pod.make_pod_chunked_step(cfg, mesh)(pod.init_pod_state(cfg, mesh, b),
                                                      pts, ts, valid)
    assert res.pose.shape == (b, k, 4, 4)
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
    for f in ("num_iterations", "num_correspondences", "num_dropped_map_voxels",
              "num_dropped_downsample", "used_fallback"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(jres, f)),
                                      err_msg=f)
    assert state.total_points.shape == (b, 2)


def test_pod_matches_map_sharded_per_sequence():
    b, k = 2, 3
    cfg = _config(KISSConfig)
    pts, ts, valid = _frames(b, k, cfg.engine.max_points_per_frame, seed=1)
    mesh = pod.make_pod_mesh(2, 4, device="cpu")
    _, res = pod.make_pod_chunked_step(cfg, mesh)(pod.init_pod_state(cfg, mesh, b),
                                                  pts, ts, valid)
    ref_mesh = sharded_map.map_mesh(4, device="cpu")
    chunk = sharded_map.make_map_sharded_chunked_step(cfg, ref_mesh)
    for i in range(b):
        _, rres = chunk(sharded_map.init_sharded_state(cfg, ref_mesh), pts[i], ts[i], valid[i])
        np.testing.assert_allclose(res.pose[i].numpy(), rres.pose.numpy(), atol=1e-5,
                                   err_msg=f"sequence {i}")
        np.testing.assert_array_equal(res.num_iterations[i].numpy(),
                                      rres.num_iterations.numpy())


def test_pod_surfaces_stats():
    b, k = 2, 3
    cfg = _config(KISSConfig)
    pts, ts, valid = _frames(b, k, cfg.engine.max_points_per_frame, seed=2)
    mesh = pod.make_pod_mesh(2, 4, device="cpu")
    _, res = pod.make_pod_chunked_step(cfg, mesh)(pod.init_pod_state(cfg, mesh, b),
                                                  pts, ts, valid)
    iters = res.num_iterations.numpy()
    assert iters.shape == (b, k)
    assert np.all(iters[:, 0] == 0)  # first frame: empty map
    assert np.all(iters[:, 1:] > 0)
    assert np.all(res.num_correspondences.numpy()[:, 1:] > 0)
    assert not bool(res.used_fallback.any())
    assert np.all(res.num_dropped_map_voxels.numpy() == 0)


def test_pod_state_and_storage():
    cfg = _config(KISSConfig)
    cfg.engine.map_storage = "u16"
    mesh = pod.make_pod_mesh(2, 4, device="cpu")
    st = pod.init_pod_state(cfg, mesh, batch=2)
    assert st.points.dtype == torch.uint16 and st.points.shape == (2, 1 << 14, 20, 3)
    assert st.total_points.shape == (2, 4)
    assert pod.PodState._fields == sharded_map.ShardedMapState._fields
    with pytest.raises(ValueError, match="seq axis"):
        pod.init_pod_state(cfg, mesh, batch=3)


def test_pod_wrapper_api_matches_jax():
    jcfg, cfg = _config(JaxConfig), _config(KISSConfig)
    jcfg.engine.map_shards = cfg.engine.map_shards = 4
    b, k = 2, 3
    pts, ts, valid = _frames(b, k, 1024, seed=3)
    frames = [[pts[i, j, valid[i, j]] for j in range(k)] for i in range(b)]
    po = pod.PodOdometry(cfg, batch=b, device="cpu")
    assert po.mesh.shape[sharded_map.MAP_AXIS] == 4
    poses = po.register_chunks(frames)
    assert poses.shape == (b, k, 4, 4) and poses.dtype == np.float32
    jposes = jpod.PodOdometry(jcfg, batch=b, n_map=4).register_chunks(frames)
    np.testing.assert_allclose(poses, jposes, atol=1e-4)
    np.testing.assert_array_equal(po.poses, poses[:, -1])


def test_pod_oversized_scan_stride_subsampled():
    """Scans above max_points_per_frame are stride-subsampled with drop
    accounting, as in JAX's PodOdometry."""
    cfg = _config(KISSConfig)
    cfg.engine.map_shards = 4
    cap = cfg.engine.max_points_per_frame
    big = np.random.default_rng(5).uniform(-30, 30, (cap * 2, 3)).astype(np.float32)
    po = pod.PodOdometry(cfg, batch=2, device="cpu")
    poses = po.register_chunks([[big], [big[:100]]])
    assert poses.shape == (2, 1, 4, 4)
    assert po.last_input_dropped == cap and po.total_input_dropped == cap
    with pytest.raises(ValueError, match="same chunk length"):
        po.register_chunks([[big], [big, big]])


def test_pod_state_crosses_packages():
    """A fresh pod state equals JAX's leaf for leaf (the JAX leaf order of
    convert.py), and JAX's leaves come back as the port's PodState."""
    jcfg, cfg = _config(JaxConfig), _config(KISSConfig)
    jcfg.engine.map_shards = cfg.engine.map_shards = 2
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jpod.init_pod_state(jcfg, jpod.make_pod_mesh(2, 2), 2))]
    mine = convert.state_to_numpy(pod.init_pod_state(cfg, pod.make_pod_mesh(2, 2, "cpu"), 2))
    for name, a, b in zip(convert.LEAF_NAMES, mine, jleaves):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    back = convert.state_from_numpy(jleaves, cfg, "cpu")
    assert isinstance(back, pod.PodState) and back.total_points.shape == (2, 2)
