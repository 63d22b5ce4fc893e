"""Port odometry step (kiss_icp_tpu_torch.odometry) against the JAX one.

Small configurations on the CPU, where every kernel wrapper takes its plain
PyTorch version. Poses are held at atol 1e-4 (as the Pallas path is in
tests/test_pallas_kernels.py) and iteration counts exactly. Also: the
degradation probes, the device rule (no silent CPU fallback) and the parts
of the KissICP wrapper this slice ports.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig

torch.set_num_threads(1)


def _small(cls):
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 2048
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 13
    cfg.engine.donate_state = False
    cfg.registration.max_num_iterations = 12
    return cfg


def _random_frames(n_frames=3, n=2048):
    rng = np.random.default_rng(7)
    base = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    return [base + np.array([0.3 * i, 0.05 * i, 0], np.float32)
            for i in range(n_frames)]


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_register_frame_matches_jax_random_cloud(storage):
    cfg, jcfg = _small(KISSConfig), _small(JaxConfig)
    cfg.engine.map_storage = jcfg.engine.map_storage = storage
    n = 2048
    ts, valid = np.zeros(n, np.float32), np.ones(n, bool)
    state = odometry.init_state(cfg, device="cpu")
    jstate = jodo.init_state(jcfg)
    for pts in _random_frames():
        state, res = odometry.register_frame(
            cfg, state, torch.from_numpy(pts), torch.from_numpy(ts),
            torch.from_numpy(valid))
        jstate, jres = jodo.register_frame(jcfg, jstate, jnp.asarray(pts),
                                           jnp.asarray(ts), jnp.asarray(valid))
        np.testing.assert_allclose(res.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
        assert res.num_iterations == int(jres.num_iterations)
        assert int(res.num_correspondences) == int(jres.num_correspondences)
        for name in ("num_dropped_downsample", "num_dropped_map_voxels",
                     "num_oob_points", "used_fallback"):
            assert int(getattr(res, name)) == int(getattr(jres, name)), name
        np.testing.assert_allclose(float(res.sigma), float(jres.sigma), rtol=1e-5)
        np.testing.assert_array_equal(res.source_valid.numpy(),
                                      np.asarray(jres.source_valid))
    assert int(state.map.total_points) == int(jstate.map.total_points)


def test_kissicp_wrapper_matches_jax():
    cfg, jcfg = _small(KISSConfig), _small(JaxConfig)
    icp = odometry.KissICP(cfg, device="cpu")
    jicp = jodo.KissICP(jcfg)
    for pts in _random_frames():
        frame, source = icp.register_frame(pts)
        jframe, jsource = jicp.register_frame(pts)
        np.testing.assert_allclose(frame, jframe, atol=1e-5)
        np.testing.assert_array_equal(source.shape, jsource.shape)
        np.testing.assert_allclose(icp.last_pose, jicp.last_pose, atol=1e-4)
        np.testing.assert_allclose(icp.last_delta, jicp.last_delta, atol=1e-4)
        assert icp.last_overflow() == jicp.last_overflow()
    assert icp.last_pose.dtype == np.float64
    ours, ref = icp.local_map_points(), jicp.local_map_points()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(np.sort(ours, axis=0), np.sort(ref, axis=0), atol=1e-3)
    res = icp.register_frame_lazy(_random_frames(4)[-1])
    assert res is icp.last_result and res.pose.shape == (4, 4)


def test_oversized_scan_is_subsampled_like_jax():
    cfg, jcfg = _small(KISSConfig), _small(JaxConfig)
    rng = np.random.default_rng(3)
    frame = rng.uniform(-20, 20, (5000, 3)).astype(np.float32)
    stamps = np.linspace(0, 1, 5000).astype(np.float32)
    got = odometry.subsample_to_capacity(frame, stamps, 2048)
    ref = jodo.subsample_to_capacity(frame, stamps, 2048)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2] == ref[2] == 5000 - 2048
    icp = odometry.KissICP(cfg, device="cpu")
    icp.register_frame(frame, stamps)
    assert icp.last_input_dropped == 5000 - 2048
    assert icp.last_overflow()[2] == 5000 - 2048


def test_degradation_probes_stay_finite():
    """Empty, all-NaN (marked valid) and all-out-of-range scans, then a
    normal scan: the pose stays finite (constant-velocity extrapolation)."""
    cfg = _small(KISSConfig)
    frames = _random_frames(2)
    icp = odometry.KissICP(cfg, device="cpu")
    cap = cfg.engine.max_points_per_frame
    icp.register_frame(frames[0])
    poses = []
    for scan in (np.zeros((0, 3), np.float32), np.full((cap, 3), np.nan, np.float32),
                 np.full((cap, 3), 5000.0, np.float32), frames[1]):
        icp.register_frame(scan)
        poses.append(icp.last_pose)
        assert not bool(icp.last_result.used_fallback)
    assert all(np.all(np.isfinite(p)) for p in poses)
    assert icp.last_result.num_iterations > 0


def test_entry_points_default_to_cuda(monkeypatch):
    """device=None means CUDA; with no card that fails loudly instead of
    dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small(KISSConfig)
    with pytest.raises(RuntimeError, match="CUDA"):
        odometry.KissICP(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        odometry.init_state(cfg)
    assert odometry.KissICP(cfg, device="cpu").device.type == "cpu"


def test_unported_options_refused_at_construction():
    """Nothing is refused: with `engine.map_shards = 2`, `create_odometry`
    returns the map-sharded engine, as JAX's does, and KissICP itself is the
    single-device engine whatever map_shards says (JAX's KissICP too)."""
    from kiss_icp_tpu.parallel.sharded_engine import ShardedKissICP as JaxSharded
    from kiss_icp_tpu_torch.parallel.sharded_engine import ShardedKissICP

    cfg, jcfg = _small(KISSConfig), _small(JaxConfig)
    cfg.engine.map_shards = jcfg.engine.map_shards = 2
    assert isinstance(odometry.create_odometry(cfg, device="cpu"), ShardedKissICP)
    assert isinstance(jodo.create_odometry(jcfg), JaxSharded)
    single = odometry.KissICP(cfg, device="cpu")
    assert type(single) is odometry.KissICP and single.state.map.total_points.shape == ()


def test_rebase_trigger_raises_instead_of_drifting_on():
    """The trigger no longer raises: past `rebase_trigger_voxels` the origin
    rolls as in JAX (the pose shifts by whole voxels, the world pose stays),
    and a rebuild that drops voxels raises a RuntimeWarning."""
    cfg, jcfg = _small(KISSConfig), _small(JaxConfig)
    cfg.engine.rebase_trigger_voxels = jcfg.engine.rebase_trigger_voxels = 2
    icp, jicp = odometry.KissICP(cfg, device="cpu"), jodo.KissICP(jcfg)
    frame = _random_frames(1)[0]
    icp.register_frame(frame)
    jicp.register_frame(frame)
    assert icp.maybe_rebase([0.5, 0.0, 0.0]) is False
    world = icp.last_pose
    assert icp.maybe_rebase([3.0, 0.0, -1.2]) is True
    assert jicp.maybe_rebase([3.0, 0.0, -1.2]) is True
    np.testing.assert_array_equal(icp.origin, [3.0, 0.0, -1.5])
    np.testing.assert_array_equal(icp.origin, jicp.origin)
    np.testing.assert_allclose(icp.last_pose, world, atol=1e-6)
    np.testing.assert_allclose(icp.local_map_points().sum(0), jicp.local_map_points().sum(0),
                               rtol=1e-6)
    cfg.engine.rebase_trigger_voxels = 0
    assert odometry.KissICP(cfg, device="cpu").maybe_rebase([1e6, 0, 0]) is False

    full = _small(KISSConfig)
    full.engine.map_capacity_log2 = 6  # 64 slots: the rebuild cannot place all
    full.engine.rebase_trigger_voxels = 1
    icp = odometry.KissICP(full, device="cpu")
    icp.register_frame_lazy(frame)
    with pytest.warns(RuntimeWarning, match="re-base dropped"):
        assert icp.maybe_rebase([5.0, 5.0, 5.0]) is True
    assert icp.total_rebase_dropped > 0


def _witness():
    """Frame 0 of `_random_frames`, and a frame 1 made of half of its frame
    1 and half new points (seed 3): the second frame adds 1044 points to a
    map of 2048, so a step that wrote its caller's map would see them."""
    frames = _random_frames()
    new = np.random.default_rng(3).uniform(-30, 30, (1024, 3)).astype(np.float32)
    return frames[0], np.concatenate([frames[1][:1024], new])


def _leaves(state):
    return [t.clone() for t in torch.utils._pytree.tree_leaves(state)]


def _same_leaves(state, leaves):
    got = torch.utils._pytree.tree_leaves(state)
    return len(got) == len(leaves) and all(torch.equal(a, b) for a, b in zip(got, leaves))


def _frame(pts):
    n = pts.shape[0]
    return torch.from_numpy(pts), torch.zeros(n), torch.ones(n, dtype=torch.bool)


def test_step_without_donation_leaves_the_state_as_it_was():
    """engine.donate_state false: two steps from one state give the same
    3092 points, iterations and pose, within 1e-4 of JAX `make_step`, and
    the state stepped from stays bit-identical."""
    cfg, jcfg = _small(KISSConfig), _small(JaxConfig)
    f0, f1 = _witness()
    state, _ = odometry.register_frame(cfg, odometry.init_state(cfg, device="cpu"), *_frame(f0))
    jstep = jodo.make_step(jcfg)
    jstate, _ = jstep(jodo.init_state(jcfg), *(jnp.asarray(a.numpy()) for a in _frame(f0)))
    assert int(state.map.total_points) == int(jstate.map.total_points) == 2048
    before = _leaves(state)
    step = odometry.make_step(cfg)
    runs = [step(state, *_frame(f1)) for _ in range(2)]
    jruns = [jstep(jstate, *(jnp.asarray(a.numpy()) for a in _frame(f1))) for _ in range(2)]
    assert _same_leaves(state, before)
    for (new, res), (jnew, jres) in zip(runs, jruns):
        assert int(new.map.total_points) == int(jnew.map.total_points) == 3092
        assert int(res.num_iterations) == int(jres.num_iterations) == 3
        np.testing.assert_allclose(res.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
    assert torch.equal(runs[0][1].pose, runs[1][1].pose)


def test_step_with_donation_updates_the_map_in_place():
    """engine.donate_state true: the step writes the caller's map (counts
    and points in place) and gives the bits of the step that copies."""
    cfg = _small(KISSConfig)
    f0, f1 = _witness()
    state, _ = odometry.register_frame(cfg, odometry.init_state(cfg, device="cpu"), *_frame(f0))
    copied, res = odometry.make_step(cfg)(state, *_frame(f1))
    cfg.engine.donate_state = True
    counts_before = int((state.map.counts > 0).sum())
    donated, dres = odometry.make_step(cfg)(state, *_frame(f1))
    assert int((state.map.counts > 0).sum()) > counts_before  # written in place
    assert donated.map.counts is state.map.counts and donated.map.points is state.map.points
    assert torch.equal(dres.pose, res.pose)
    for a, b in zip(donated.map, copied.map):
        assert torch.equal(a, b)


def test_chunked_step_without_donation_copies_once():
    """A chunk that does not donate leaves its input state bit-identical and
    gives the donating chunk's bits."""
    cfg = _small(KISSConfig)
    f0, f1 = _witness()
    frames = [_frame(f) for f in (f0, f1, _random_frames()[2])]
    pts, ts, valid = (torch.stack([f[i] for f in frames]) for i in range(3))
    state = odometry.init_state(cfg, device="cpu")
    before = _leaves(state)
    out, summary = odometry.make_chunked_step(cfg)(state, pts, ts, valid)
    assert _same_leaves(state, before)
    again, summary2 = odometry.make_chunked_step(cfg)(state, pts, ts, valid)
    donated, dsummary = odometry.make_chunked_step(cfg, donate=True)(state, pts, ts, valid)
    for s in (summary2, dsummary):
        assert torch.equal(s.poses, summary.poses)
        assert torch.equal(s.num_iterations, summary.num_iterations)
    assert int(out.map.total_points) == int(donated.map.total_points) > 2048


def test_make_rebase_leaves_the_state_as_it_was():
    cfg, jcfg = _small(KISSConfig), _small(JaxConfig)
    f0, _ = _witness()
    state, _ = odometry.register_frame(cfg, odometry.init_state(cfg, device="cpu"), *_frame(f0))
    jstate, _ = jodo.register_frame(jcfg, jodo.init_state(jcfg),
                                    *(jnp.asarray(a.numpy()) for a in _frame(f0)))
    before = _leaves(state)
    shift = np.array([3, -2, 1], np.int32)
    new, dropped = odometry.make_rebase(cfg)(state, shift)
    jnew, jdropped = jodo.make_rebase(jcfg)(jstate, jnp.asarray(shift))
    assert _same_leaves(state, before)
    assert int(dropped) == int(jdropped)
    np.testing.assert_array_equal(new.pose.numpy(), np.asarray(jnew.pose))
    np.testing.assert_array_equal(new.map.vkeys.numpy(), np.asarray(jnew.map.vkeys))
    assert int(new.map.total_points) == int(jnew.map.total_points) == 2048
