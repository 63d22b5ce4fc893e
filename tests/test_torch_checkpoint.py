"""Port checkpoints (kiss_icp_tpu_torch.io.checkpoint, KissICP.save_checkpoint
/ load_checkpoint) and their compatibility with the JAX package's files.

Within the port: resume is bit-exact, mismatched capacities are refused, a
bare state is still shape-checked, older files (no map_shards key, one leaf
fewer) load, and the rolling origin round-trips. Across packages: JAX saves
and the port loads, the port saves and JAX loads; in both directions the
next frame gives the saving package's own next pose at atol 1e-4 (as
tests/test_torch_odometry.py holds poses).
"""

import json

import numpy as np
import pytest
import torch

from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu_torch import convert, odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.io import checkpoint
from kiss_icp_tpu_torch.pipeline import OdometryPipeline

torch.set_num_threads(1)


def _cfg(cls=KISSConfig, **engine):
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 4096
    cfg.engine.frame_capacity = 4096
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 15
    cfg.registration.max_num_iterations = 30
    if cls is JaxConfig:
        cfg.engine.use_pallas = False
    for k, v in engine.items():
        setattr(cfg.engine, k, v)
    return cfg


def _dataset(n):
    return SyntheticDataset(sequence=1, n_scans=n, n_beams=16, n_azimuth=256,
                            max_range=50.0, speed=1.0, accel_frames=4)


def _scans(n):
    ds = _dataset(n)
    return [ds[i] for i in range(n)]


def _icp(**engine):
    return odometry.KissICP(_cfg(**engine), device="cpu")


def test_roundtrip_resume_is_exact(tmp_path):
    scans = _scans(6)
    path = tmp_path / "state.npz"
    icp = _icp()
    for pts, ts in scans[:3]:
        icp.register_frame_lazy(pts, ts)
    icp.save_checkpoint(path)
    for pts, ts in scans[3:]:
        icp.register_frame_lazy(pts, ts)

    icp2 = _icp()
    icp2.load_checkpoint(path)
    for pts, ts in scans[3:]:
        icp2.register_frame_lazy(pts, ts)
    np.testing.assert_array_equal(icp2.last_pose, icp.last_pose)
    np.testing.assert_array_equal(icp2.last_delta, icp.last_delta)
    for a, b in zip(convert.state_to_numpy(icp2.state), convert.state_to_numpy(icp.state)):
        np.testing.assert_array_equal(a, b)
    assert not list(tmp_path.glob("*.tmp*"))


def test_mismatched_capacity_rejected(tmp_path):
    path = tmp_path / "state.npz"
    icp = _icp()
    icp.register_frame_lazy(*_scans(1)[0])
    icp.save_checkpoint(path)
    with pytest.raises(ValueError, match="map_capacity_log2"):
        _icp(map_capacity_log2=14).load_checkpoint(path)
    with pytest.raises(ValueError, match="map_storage"):
        _icp(map_storage="u16").load_checkpoint(path)


def test_save_state_without_metadata_shape_checked(tmp_path):
    cfg = _cfg()
    path = tmp_path / "bare.npz"
    checkpoint.save_state(path, odometry.init_state(cfg, "cpu"))
    restored = checkpoint.load_checkpoint(path, cfg, "cpu")
    assert restored.map.counts.shape == (1 << 15,)
    with pytest.raises(ValueError, match="shape/dtype"):
        checkpoint.load_checkpoint(path, _cfg(map_capacity_log2=14), "cpu")
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files}
    del arrays["leaf_11"], arrays["leaf_10"]
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="has 10 arrays, expected 12"):
        checkpoint.load_checkpoint(path, cfg, "cpu")


def test_checkpoint_without_map_shards_key_loads(tmp_path):
    cfg = _cfg()
    icp = odometry.KissICP(cfg, device="cpu")
    icp.register_frame_lazy(*_scans(1)[0])
    p = tmp_path / "old.npz"
    icp.save_checkpoint(p)
    with np.load(p) as d:
        arrays = {k: d[k] for k in d.files}
    meta = json.loads(bytes(arrays["metadata_json"]).decode())
    del meta["map_shards"]
    arrays["metadata_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(p, **arrays)
    fresh = odometry.KissICP(cfg, device="cpu")
    fresh.load_checkpoint(p)
    np.testing.assert_array_equal(fresh.last_pose, icp.last_pose)


def test_pre_round5_checkpoint_leaf_migration(tmp_path):
    """A file from before the map's num_oob_points counter (one leaf fewer)
    loads, with the counter as zero and every other leaf intact."""
    cfg = _cfg()
    icp = odometry.KissICP(cfg, device="cpu")
    for f, t in _scans(3):
        icp.register_frame(f, t)
    path = tmp_path / "new.npz"
    icp.save_checkpoint(path)
    oob = convert.LEAF_NAMES.index("num_oob_points")
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files}
    old = {k: v for k, v in arrays.items() if not k.startswith("leaf_")}
    for j, i in enumerate(i for i in range(12) if i != oob):
        old[f"leaf_{j}"] = arrays[f"leaf_{i}"]
    old_path = tmp_path / "old.npz"
    np.savez(old_path, **old)

    state = checkpoint.load_checkpoint(old_path, cfg, "cpu")
    assert int(state.map.num_oob_points) == 0
    assert torch.equal(state.pose, icp.state.pose)
    assert torch.equal(state.map.counts, icp.state.map.counts)


def test_origin_roundtrips(tmp_path):
    scans = _scans(13)
    icp = _icp(rebase_trigger_voxels=6)
    for f, t in scans[:12]:
        icp.register_frame(f, t)
    assert np.any(icp.origin != 0)
    path = tmp_path / "ckpt.npz"
    icp.save_checkpoint(path)
    np.testing.assert_array_equal(checkpoint.load_extra(path, "origin"), icp.origin)

    icp2 = _icp(rebase_trigger_voxels=6)
    icp2.origin = np.array([999.0, 0.0, 0.0])  # a stale origin must not survive
    icp2.load_checkpoint(path)
    np.testing.assert_array_equal(icp2.origin, icp.origin)
    np.testing.assert_array_equal(icp2.last_pose, icp.last_pose)
    icp.register_frame(*scans[12])
    icp2.register_frame(*scans[12])
    np.testing.assert_array_equal(icp2.last_pose, icp.last_pose)

    # A checkpoint written without the origin (before re-bases) means zero.
    bare = tmp_path / "no_origin.npz"
    checkpoint.save_checkpoint(bare, icp.state, icp.config)
    icp2.load_checkpoint(bare)
    assert np.all(icp2.origin == 0)


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_checkpoints_cross_packages(tmp_path, storage):
    """JAX saves, the port loads; the port saves, JAX loads: the next frame
    gives the saving package's pose (atol 1e-4), origin included."""
    scans = _scans(10)
    engine = dict(map_storage=storage, rebase_trigger_voxels=6)

    jicp = jodo.KissICP(_cfg(JaxConfig, **engine))
    for f, t in scans[:8]:
        jicp.register_frame(f, t)
    assert np.any(jicp.origin != 0)
    jpath = tmp_path / "jax.npz"
    jicp.save_checkpoint(jpath)
    icp = odometry.KissICP(_cfg(**engine), device="cpu")
    icp.load_checkpoint(jpath)
    np.testing.assert_array_equal(icp.origin, jicp.origin)
    np.testing.assert_array_equal(icp.last_pose, jicp.last_pose)
    jicp.register_frame(*scans[8])
    icp.register_frame(*scans[8])
    np.testing.assert_allclose(icp.last_pose, jicp.last_pose, atol=1e-4)

    ppath = tmp_path / "port.npz"
    icp.save_checkpoint(ppath)
    jicp2 = jodo.KissICP(_cfg(JaxConfig, **engine))
    jicp2.load_checkpoint(ppath)
    np.testing.assert_array_equal(jicp2.origin, icp.origin)
    np.testing.assert_array_equal(jicp2.last_pose, icp.last_pose)
    icp.register_frame(*scans[9])
    jicp2.register_frame(*scans[9])
    np.testing.assert_allclose(jicp2.last_pose, icp.last_pose, atol=1e-4)


def _pipeline_cfg(tmp_path, **engine):
    cfg = _cfg(**engine)
    cfg.out_dir = str(tmp_path / "results")
    return cfg


def test_pipeline_resume_matches_full_run(tmp_path):
    """Save at frame 3, resume with --jump 3: the tail equals the full run's
    poses bit for bit."""
    ds = _dataset(6)
    full = OdometryPipeline(ds, config=_pipeline_cfg(tmp_path), device="cpu")
    full.run()
    head = OdometryPipeline(ds, config=_pipeline_cfg(tmp_path), n_scans=3,
                            save_checkpoint=True, device="cpu")
    head.run()
    ckpt = head.results_dir / "checkpoint.npz"
    tail = OdometryPipeline(ds, config=_pipeline_cfg(tmp_path), jump=3,
                            resume_from=ckpt, device="cpu")
    tail.run()
    np.testing.assert_array_equal(tail.poses, full.poses[3:])


@pytest.mark.parametrize("chunk", [1, 3])
def test_pipeline_periodic_checkpoint(tmp_path, chunk):
    """--checkpoint-every 2 over 4 frames (streaming, or chunks of 3 that
    checkpoint at the first chunk boundary past each multiple): the file is
    written atomically, and resuming from it reproduces the full run's
    tail."""
    ds = _dataset(6)
    full = OdometryPipeline(ds, config=_pipeline_cfg(tmp_path, pipeline_chunk=chunk),
                            device="cpu")
    full.run()
    head = OdometryPipeline(ds, config=_pipeline_cfg(tmp_path, pipeline_chunk=chunk),
                            n_scans=3 if chunk == 3 else 4, checkpoint_every=2, device="cpu")
    head.run()
    ckpt = head.results_dir / "checkpoint.npz"
    assert ckpt.exists() and not list(head.results_dir.glob("*.tmp*"))
    done = 3 if chunk == 3 else 4
    tail = OdometryPipeline(ds, config=_pipeline_cfg(tmp_path, pipeline_chunk=1), jump=done,
                            resume_from=ckpt, device="cpu")
    tail.run()
    np.testing.assert_array_equal(tail.poses, full.poses[done:])
