"""The map-sharded engine behind `engine.map_shards > 1`
(kiss_icp_tpu_torch.parallel.sharded_engine) against the JAX package's
ShardedKissICP on its 8-device CPU mesh, on the CPU.

Tolerances: poses within 1e-4 m of JAX's engine frame by frame (the port's
single-device engine meets JAX's at 1e-4), the point outputs within 1e-5 m
(tests/test_sharded_engine.py:64-65), overflow counters equal; the
re-base, the checkpoints and the occupancy exactly.
"""

import jax
import numpy as np
import pytest
import torch

from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu_torch import convert, odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.parallel.sharded_engine import ShardedKissICP, make_map_mesh

torch.set_num_threads(1)

ATOL_JAX = 1e-4


def _config(cls, map_shards=1, storage="f32"):
    """tests/test_sharded_engine.py's `_config`."""
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 2048
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 14
    cfg.engine.map_shards = map_shards
    cfg.engine.map_storage = storage
    cfg.registration.max_num_iterations = 12
    return cfg


def _scans(k=4, n=1800, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    return [base + np.array([0.3, 0.05, 0.0], np.float32) * i for i in range(k)]


def _port(d=4, **kw):
    return odometry.create_odometry(_config(KISSConfig, d, **kw), device="cpu")


def _jax(d=4, **kw):
    return jodo.create_odometry(_config(JaxConfig, d, **kw))


def _jax_leaves(icp):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(icp.state)]


def test_factory_selects_engine():
    assert type(odometry.create_odometry(_config(KISSConfig, 1), device="cpu")) \
        is odometry.KissICP
    icp = _port(4)
    assert isinstance(icp, ShardedKissICP) and isinstance(icp, odometry.KissICP)
    assert icp.mesh.shape["map"] == 4 and icp.device.type == "cpu"
    assert icp.state.total_points.shape == (4,)


def test_trajectory_matches_jax_engine():
    ref = _jax(4)
    icp = _port(4)
    single = odometry.create_odometry(_config(KISSConfig, 1), device="cpu")
    for f in _scans():
        ref.register_frame_lazy(f)
        icp.register_frame_lazy(f)
        single.register_frame_lazy(f)
        np.testing.assert_allclose(icp.last_pose, ref.last_pose, atol=ATOL_JAX)
        assert icp.last_overflow() == ref.last_overflow()
        np.testing.assert_allclose(icp.last_pose, single.last_pose, atol=5e-4)


def test_point_outputs_match_jax():
    ref, icp = _jax(4), _port(4)
    for f in _scans(k=2):
        f_ref, s_ref = ref.register_frame(f)
        f_prt, s_prt = icp.register_frame(f)
        np.testing.assert_allclose(f_prt, f_ref, atol=1e-5)
        np.testing.assert_allclose(s_prt, s_ref, atol=1e-5)


def test_chunked_matches_streaming_and_jax_drops():
    scans = _scans(k=6)
    a = _port(4)
    poses = a.register_frames_chunked(scans)
    assert poses.shape == (6, 4, 4)
    ref = _jax(4)
    ref.register_frames_chunked(scans)
    np.testing.assert_array_equal(a.last_chunk_summary.num_dropped_downsample.numpy(),
                                  np.asarray(ref.last_chunk_summary.num_dropped_downsample))
    b = _port(4)
    stream = []
    for f in scans:
        b.register_frame_lazy(f)
        stream.append(b.last_pose)
    np.testing.assert_allclose(poses, np.stack(stream), atol=1e-5)


def test_checkpoint_roundtrip(tmp_path):
    scans = _scans(k=5, seed=3)
    a = _port(4)
    for f in scans[:3]:
        a.register_frame_lazy(f)
    ckpt = tmp_path / "sharded.npz"
    a.save_checkpoint(ckpt)
    b = _port(4)
    b.load_checkpoint(ckpt)
    for f in scans[3:]:
        a.register_frame_lazy(f)
        b.register_frame_lazy(f)
        np.testing.assert_array_equal(a.last_pose, b.last_pose)
    assert torch.equal(a.state.counts, b.state.counts)


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_checkpoints_load_across_packages(tmp_path, storage):
    """JAX saves, the port loads (tables equal, the next frame within the
    pose tolerance); the port saves, JAX loads (the same)."""
    scans = _scans(k=4, seed=5)
    j = _jax(4, storage=storage)
    for f in scans[:3]:
        j.register_frame_lazy(f)
    ckpt = tmp_path / "jax.npz"
    j.save_checkpoint(ckpt)
    p = _port(4, storage=storage)
    p.load_checkpoint(ckpt)
    for a, b in zip(convert.state_to_numpy(p.state), _jax_leaves(j)):
        np.testing.assert_array_equal(a, b)
    j.register_frame_lazy(scans[3])
    p.register_frame_lazy(scans[3])
    np.testing.assert_allclose(p.last_pose, j.last_pose, atol=ATOL_JAX)

    ckpt2 = tmp_path / "port.npz"
    p.save_checkpoint(ckpt2)
    j2 = _jax(4, storage=storage)
    j2.load_checkpoint(ckpt2)
    for a, b in zip(convert.state_to_numpy(p.state), _jax_leaves(j2)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_engine_mismatch_fails_loudly(tmp_path):
    a = _port(4)
    a.register_frame_lazy(_scans(k=1)[0])
    ckpt = tmp_path / "sharded.npz"
    a.save_checkpoint(ckpt)
    with pytest.raises(ValueError, match="map"):
        odometry.create_odometry(_config(KISSConfig, 1), device="cpu").load_checkpoint(ckpt)
    with pytest.raises(ValueError, match="map"):
        _port(2).load_checkpoint(ckpt)
    single = odometry.create_odometry(_config(KISSConfig, 1), device="cpu")
    single.register_frame_lazy(_scans(k=1)[0])
    single.save_checkpoint(tmp_path / "single.npz")
    with pytest.raises(ValueError, match="map"):
        _port(4).load_checkpoint(tmp_path / "single.npz")
    with pytest.raises(ValueError, match="map"):
        _jax(4).load_checkpoint(tmp_path / "single.npz")


def test_local_map_points_match_jax():
    ref, icp = _jax(4), _port(4)
    for f in _scans(k=3):
        ref.register_frame_lazy(f)
        icp.register_frame_lazy(f)
    a, b = icp.local_map_points(), ref.local_map_points()
    assert len(a) == len(b)
    a, b = a[np.lexsort(a.T)], b[np.lexsort(b.T)]
    np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_rebase_slot_for_slot(tmp_path, storage):
    """From one state, JAX's cross-shard re-base and the port's give the same
    tables slot for slot, the same drops and pose."""
    j = _jax(4, storage=storage)
    for f in _scans(k=3, seed=9):
        j.register_frame_lazy(f)
    ckpt = tmp_path / "s.npz"
    j.save_checkpoint(ckpt)
    p = _port(4, storage=storage)
    p.load_checkpoint(ckpt)
    shift = np.array([5, -3, 1], np.int32)
    assert p._apply_rebase(shift) == j._apply_rebase(shift)
    for name, a, b in zip(convert.LEAF_NAMES, convert.state_to_numpy(p.state),
                          _jax_leaves(j)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_forced_rebase_keeps_world_poses():
    cfg = _config(KISSConfig, 4)
    cfg.engine.rebase_trigger_voxels = 1
    icp = odometry.create_odometry(cfg, device="cpu")
    ref = _port(4)
    for f in _scans(k=4, seed=2):
        icp.register_frame(f)
        ref.register_frame(f)
    assert np.any(icp.origin != 0)
    np.testing.assert_allclose(icp.last_pose, ref.last_pose, atol=5e-3)


def test_shard_occupancy_matches_jax():
    ref, icp = _jax(4), _port(4)
    for f in _scans(k=3, n=4000, seed=7):
        ref.register_frame_lazy(f)
        icp.register_frame_lazy(f)
    occ = icp.shard_occupancy()
    np.testing.assert_array_equal(occ, ref.shard_occupancy())
    assert occ.shape == (4,) and occ.sum() > 0
    assert occ.max() <= 3 * max(occ.min(), 1)


def test_map_shards_validated():
    with pytest.raises(ValueError, match="power of two"):
        _port(3)
    with pytest.raises(ValueError, match=">= 2"):
        make_map_mesh(_config(KISSConfig, 1), device="cpu")
    cfg = _config(KISSConfig, 1 << 14)
    with pytest.raises(ValueError, match="capacity"):
        odometry.create_odometry(cfg, device="cpu")


def test_sharded_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        odometry.create_odometry(_config(KISSConfig, 2))
