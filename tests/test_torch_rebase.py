"""Port rolling-origin re-base (hash_map.rebase, odometry.rebase_state,
KissICP.maybe_rebase) against the JAX package.

  * `hash_map.rebase` equals JAX slot for slot (vkeys, fprints, counts,
    points, total_points, drop counters) for f32 and u16 storage, with the
    rebuild's drop count, on a roomy map and on an over-full one; the map
    passed in is left as it was.
  * Trajectories with forced re-bases equal the un-rebased run within
    tests/test_rebase.py:170-171's tolerances, per frame and chunked, and
    equal JAX's rebased run at atol 1e-4 per frame (as
    tests/test_torch_odometry.py holds poses).
  * World poses are continuous across a re-base; a re-base leaves what a
    FrameResult or a ChunkSummary holds untouched.
  * Near the key envelope: out-of-envelope drops without re-base and none
    with it, in the same counts as JAX.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.ops import hash_map as jhm
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.ops import hash_map as hm

torch.set_num_threads(1)

MAP_FIELDS = ("vkeys", "fprints", "counts", "points", "total_points",
              "num_dropped_voxels", "num_oob_points")


def _filled_maps(storage, capacity_log2, n, spread):
    args = dict(voxel_size=1.0, max_distance=1e9, max_points_per_voxel=4,
                capacity_log2=capacity_log2, probe_length=16, group_capacity=8,
                storage=storage)
    cfg, jcfg = hm.MapConfig(**args), jhm.MapConfig(**args)
    pts = np.random.default_rng(0).uniform(-spread, spread, (n, 3)).astype(np.float32)
    m, _ = hm.insert(cfg, hm.create_map(cfg), torch.from_numpy(pts),
                     torch.ones(n, dtype=torch.bool))
    jm, _ = jhm.insert(jcfg, jhm.create_map(jcfg), jnp.asarray(pts), jnp.ones(n, bool))
    return cfg, m, jcfg, jm


@pytest.mark.parametrize("storage", ["f32", "u16"])
@pytest.mark.parametrize("capacity_log2,n,spread,shift", [
    (12, 300, 40.0, [17, -5, 3]),  # roomy: nothing drops
    (6, 400, 30.0, [3, 3, 3]),  # 64 slots, over-full: the rebuild drops
])
def test_rebase_matches_jax_slot_for_slot(storage, capacity_log2, n, spread, shift):
    cfg, m, jcfg, jm = _filled_maps(storage, capacity_log2, n, spread)
    before = {f: getattr(m, f).clone() for f in MAP_FIELDS}
    m2, dropped = hm.rebase(cfg, m, torch.tensor(shift, dtype=torch.int32))
    jm2, jdropped = jhm.rebase(jcfg, jm, jnp.asarray(np.array(shift, np.int32)))

    assert int(dropped) == int(jdropped)
    for name in MAP_FIELDS:
        np.testing.assert_array_equal(getattr(m2, name).numpy(),
                                      np.asarray(getattr(jm2, name)), err_msg=name)
    for name in MAP_FIELDS:  # out of place: the old map is as it was
        assert torch.equal(getattr(m, name), before[name]), name
    assert int(m2.num_dropped_voxels) == int(m.num_dropped_voxels) + int(dropped)
    assert int(m2.total_points) == int(m2.counts.sum())
    if capacity_log2 == 12:
        assert int(dropped) == 0 and int(m2.total_points) == int(m.total_points)
    else:
        assert int(dropped) > 0


def _engine_config(cls, trigger=0):
    cfg = cls()
    cfg.data.max_range = 30.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 4096
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 14
    cfg.engine.rebase_trigger_voxels = trigger
    if cls is JaxConfig:
        cfg.engine.use_pallas = False
    return cfg


def _scans(n):
    ds = SyntheticDataset(sequence=0, n_scans=n, n_beams=16, n_azimuth=256,
                          max_range=30.0, speed=1.2, accel_frames=3)
    return [ds[i] for i in range(n)]


def _run(icp, scans, chunked):
    poses = []
    if chunked:
        for a in range(0, len(scans), 6):
            part = scans[a:a + 6]
            poses.extend(icp.register_frames_chunked([s[0] for s in part],
                                                     [s[1] for s in part]))
    else:
        for f, t in scans:
            icp.register_frame(f, t)
            poses.append(icp.last_pose)
    return np.asarray(poses)


@pytest.mark.parametrize("chunked", [False, True])
def test_trajectory_parity_with_and_without_rebase(chunked):
    scans = _scans(18)
    base_icp = odometry.KissICP(_engine_config(KISSConfig, 0), device="cpu")
    base = _run(base_icp, scans, chunked)
    reb_icp = odometry.KissICP(_engine_config(KISSConfig, 8), device="cpu")
    reb = _run(reb_icp, scans, chunked)
    jicp = jodo.KissICP(_engine_config(JaxConfig, 8))
    jreb = _run(jicp, scans, chunked)

    assert np.any(reb_icp.origin != 0), "trigger 8 voxels must have fired"
    assert np.all(base_icp.origin == 0)
    np.testing.assert_array_equal(reb_icp.origin, jicp.origin)
    np.testing.assert_allclose(reb[:, :3, 3], base[:, :3, 3], atol=5e-3)
    np.testing.assert_allclose(reb[:, :3, :3], base[:, :3, :3], atol=1e-3)
    for i in range(len(scans)):
        np.testing.assert_allclose(reb[i], jreb[i], atol=1e-4, err_msg=f"frame {i}")
    if chunked:
        s, js = reb_icp.last_chunk_summary, jicp.last_chunk_summary
        for name in ("num_oob_points", "num_dropped_map_voxels", "num_iterations"):
            np.testing.assert_array_equal(getattr(s, name).numpy(),
                                          np.asarray(getattr(js, name)), err_msg=name)
        assert int(s.num_oob_points.sum()) == 0
    else:
        assert reb_icp.last_overflow() == base_icp.last_overflow() == jicp.last_overflow()
    assert reb_icp.total_rebase_dropped == 0
    assert len(reb_icp.local_map_points()) == len(jicp.local_map_points()) > 0


def test_world_pose_continuity_and_results_untouched():
    """No jump in world poses at a re-base, and a re-base changes no tensor
    that a FrameResult or ChunkSummary still holds (they share the pose
    tensor with the state)."""
    scans = _scans(18)
    icp = odometry.KissICP(_engine_config(KISSConfig, 6), device="cpu")
    poses = _run(icp, scans[:12], chunked=False)
    assert np.any(icp.origin != 0)
    step = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    assert float(step.max()) < 3.0  # per-frame motion, no origin jump

    # A frame result and a chunk summary, then a forced roll.
    res = icp.register_frame_lazy(*scans[12])
    assert res.pose is icp.state.pose
    kept = res.pose.clone()
    chunk, _ = icp.build_chunk([s[0] for s in scans[13:15]], [s[1] for s in scans[13:15]])
    summary = icp.dispatch_chunk(chunk)
    kept_poses = summary.poses.clone()
    origin = icp.origin.copy()
    world = icp.last_pose
    icp.config.engine.rebase_trigger_voxels = 1
    assert icp.maybe_rebase() is True
    assert torch.equal(res.pose, kept) and torch.equal(summary.poses, kept_poses)
    assert np.any(icp.origin != origin)
    np.testing.assert_allclose(icp.last_pose, world, atol=1e-5)


def test_envelope_edge_drops_without_rebase_and_recovers_with():
    """A pose 3 voxels from the +16383-voxel key envelope: without re-base
    the points past it are counted (not as map-voxel drops); an explicit
    maybe_rebase rolls the origin and the next frames insert fully. Counts
    and poses as in JAX."""
    scans = _scans(4)
    edge = np.eye(4, dtype=np.float32)
    edge[0, 3] = 16380.0

    icp = odometry.KissICP(_engine_config(KISSConfig, 0), device="cpu")
    jicp = jodo.KissICP(_engine_config(JaxConfig, 0))
    icp.state = icp.state._replace(pose=torch.from_numpy(edge))
    jicp.state = jicp.state._replace(pose=jnp.asarray(edge))
    icp.register_frame(*scans[0])
    jicp.register_frame(*scans[0])
    assert icp.last_overflow()[3] > 0 and icp.last_overflow()[1] == 0
    assert icp.last_overflow() == jicp.last_overflow()

    icp = odometry.KissICP(_engine_config(KISSConfig, 100), device="cpu")
    jicp = jodo.KissICP(_engine_config(JaxConfig, 100))
    icp.state = icp.state._replace(pose=torch.from_numpy(edge))
    jicp.state = jicp.state._replace(pose=jnp.asarray(edge))
    assert icp.maybe_rebase() is True and jicp.maybe_rebase() is True
    np.testing.assert_array_equal(icp.origin, jicp.origin)
    assert float(icp.state.pose[:3, 3].abs().max()) < 100.0
    for f, t in scans:
        icp.register_frame(f, t)
        jicp.register_frame(f, t)
        assert icp.last_overflow()[3] == 0
        assert icp.last_overflow() == jicp.last_overflow()
        np.testing.assert_allclose(icp.last_pose, jicp.last_pose, atol=1e-4)
    assert abs(icp.last_pose[0, 3] - 16380.0) < 50.0
    assert len(icp.local_map_points()) > 100
