"""nn_mode "cached" in the port against the JAX package.

  * `query_topc` gives JAX's candidates in JAX's order (`lax.top_k` of -d²:
    ties to the lower index), tied distances and NaN queries included.
  * `gauss_newton_loop_cached` from the same inputs: pose within atol 1e-4,
    iterations and re-gathers equal.
  * A 6-frame drive (16x512 beams, 2^15-slot map) against JAX's KissICP:
    poses within atol 1e-4, iteration counts equal; and against the port's
    exact mode within the bounds of tests/test_cached_assoc.py.
  * A bad initial guess forces re-gathers and lands on the exact pose.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.ops import hash_map as jhm
from kiss_icp_tpu.ops import registration as jreg
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.kernels import linsys
from kiss_icp_tpu_torch.metrics import absolute_trajectory_error
from kiss_icp_tpu_torch.ops import hash_map as hm
from kiss_icp_tpu_torch.ops import registration

torch.set_num_threads(1)


def _map_both(n=3000, seed=3, spread=20.0):
    args = dict(voxel_size=1.0, max_distance=100.0, max_points_per_voxel=8,
                capacity_log2=13, probe_length=16, group_capacity=16)
    cfg, jcfg = hm.MapConfig(**args), jhm.MapConfig(**args)
    pts = np.random.default_rng(seed).uniform(-spread, spread, (n, 3)).astype(np.float32)
    m, _ = hm.insert(cfg, hm.create_map(cfg), torch.from_numpy(pts),
                     torch.ones(n, dtype=torch.bool))
    jm, _ = jhm.insert(jcfg, jhm.create_map(jcfg), jnp.asarray(pts), jnp.ones(n, bool))
    return cfg, m, jcfg, jm


@pytest.mark.parametrize("c", [1, 8, 20])
def test_query_topc_matches_jax(c):
    cfg, m, jcfg, jm = _map_both()
    rng = np.random.default_rng(4)
    q = rng.uniform(-20, 20, (512, 3)).astype(np.float32)
    q[::37] = np.nan
    cand, cval = hm.query_topc(cfg, m, torch.from_numpy(q), c)
    jcand, jcval = jhm.query_topc(jcfg, jm, jnp.asarray(q), c)
    np.testing.assert_array_equal(cval.numpy(), np.asarray(jcval))
    assert not bool(cval[::37].any())  # a NaN query has no valid candidate
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    # Nearest first, and the first is the exact query's answer.
    exact = hm.query_nearest(cfg, m, torch.from_numpy(q), torch.ones(512, dtype=torch.bool))
    d = torch.where(cval, torch.linalg.norm(cand - torch.from_numpy(q)[:, None], dim=-1),
                    torch.tensor(float("inf")))
    assert bool((d[:, 1:] >= d[:, :-1] - 1e-6).all() | ~cval[:, 1:].any())
    f = exact.found
    torch.testing.assert_close(d[f, 0], exact.distances[f], rtol=1e-6, atol=1e-6)


def test_query_topc_ties_break_by_lower_index():
    """Three stored points at 0.4 m from the query in its own voxel, and
    two at 0.6 m in the voxels above and below: the lower (neighbour, lane)
    index comes first, as lax.top_k orders them."""
    args = dict(voxel_size=1.0, max_distance=30.0, max_points_per_voxel=4, capacity_log2=10)
    cfg, jcfg = hm.MapConfig(**args), jhm.MapConfig(**args)
    pts = np.array([[0.5, 0.5, 0.9], [0.5, 0.5, 0.1], [0.9, 0.5, 0.5], [0.5, 0.5, -0.1],
                    [0.5, 0.5, 1.1]], np.float32)
    m, _ = hm.insert(cfg, hm.create_map(cfg), torch.from_numpy(pts),
                     torch.ones(5, dtype=torch.bool))
    jm, _ = jhm.insert(jcfg, jhm.create_map(jcfg), jnp.asarray(pts), jnp.ones(5, bool))
    q = np.array([[0.5, 0.5, 0.5]], np.float32)
    cand, cval = hm.query_topc(cfg, m, torch.from_numpy(q), 6)
    jcand, jcval = jhm.query_topc(jcfg, jm, jnp.asarray(q), 6)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    np.testing.assert_array_equal(cval.numpy(), np.asarray(jcval))
    assert cval.numpy().tolist() == [[True] * 5 + [False]]
    # Own voxel (j = 0) first, in lane order; then the voxel above (j = 1),
    # then the one below (j = 2).
    assert sorted(map(tuple, cand[0, :3].tolist())) == sorted(map(tuple, pts[:3].tolist()))
    np.testing.assert_array_equal(cand[0, 3:5].numpy(), pts[[4, 3]])


def test_cached_loop_matches_jax():
    cfg, m, jcfg, jm = _map_both()
    rng = np.random.default_rng(5)
    src = rng.uniform(-15, 15, (1024, 3)).astype(np.float32)
    valid = rng.random(1024) > 0.1
    guess = np.eye(4, dtype=np.float32)
    guess[:3, 3] = [0.6, -0.4, 0.1]  # far enough to force re-gathers
    kw = dict(refresh_dist=0.25, max_iterations=60, convergence=1e-4)
    t_icp, iters, regathers = registration.gauss_newton_loop_cached(
        torch.from_numpy(src), torch.from_numpy(valid), torch.from_numpy(guess),
        torch.tensor(3.0), torch.tensor(1.0),
        gather_fn=lambda s: hm.query_topc(cfg, m, s, 8),
        linsys_fn=linsys.build_linear_system, **kw)
    jt, jiters, jregathers = jreg.gauss_newton_loop_cached(
        jnp.asarray(src), jnp.asarray(valid), jnp.asarray(guess), jnp.float32(3.0),
        jnp.float32(1.0), gather_fn=lambda s: jhm.query_topc(jcfg, jm, s, 8), **kw)
    np.testing.assert_allclose(t_icp.numpy(), np.asarray(jt), atol=1e-4)
    assert iters == int(jiters) > 1
    assert regathers == int(jregathers) > 0


def _config(cls, nn_mode):
    cfg = cls()
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 8192
    cfg.engine.frame_capacity = 8192
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 15
    cfg.engine.nn_mode = nn_mode
    return cfg


N_FRAMES = 6


@pytest.fixture(scope="module")
def drive():
    ds = SyntheticDataset(sequence=1, n_scans=N_FRAMES, n_beams=16, n_azimuth=512,
                          speed=1.0, accel_frames=6)
    scans = [ds[i] for i in range(N_FRAMES)]
    out = {}
    for name, icp in (("cached", odometry.KissICP(_config(KISSConfig, "cached"), device="cpu")),
                      ("exact", odometry.KissICP(_config(KISSConfig, "gather27"), device="cpu")),
                      ("jax", jodo.KissICP(_config(JaxConfig, "cached")))):
        poses, iters = [], []
        for pts, stamps in scans:
            icp.register_frame(pts, stamps)
            poses.append(icp.last_pose)
            iters.append(int(icp.last_result.num_iterations))
        out[name] = (np.stack(poses), np.asarray(iters))
    return ds, out


def test_cached_drive_matches_jax(drive):
    _, out = drive
    np.testing.assert_allclose(out["cached"][0], out["jax"][0], atol=1e-4)
    np.testing.assert_array_equal(out["cached"][1], out["jax"][1])


def test_cached_trajectory_within_exact_mode_bounds(drive):
    """The bounds of tests/test_cached_assoc.py: 0.15 m translation, 6e-3
    rotation, ATE at most 1.15x the exact mode's + 0.01 m, mean iterations
    below 2.5x the exact mode's."""
    ds, out = drive
    (p_cached, it_cached), (p_exact, it_exact) = out["cached"], out["exact"]
    assert np.linalg.norm(p_cached[:, :3, 3] - p_exact[:, :3, 3], axis=1).max() < 0.15
    np.testing.assert_allclose(p_cached[:, :3, :3], p_exact[:, :3, :3], atol=6e-3)
    gt = ds.gt_poses[:N_FRAMES]
    ate_exact, _ = absolute_trajectory_error(gt, p_exact)
    ate_cached, _ = absolute_trajectory_error(gt, p_cached)
    assert ate_cached <= ate_exact * 1.15 + 0.01
    assert it_cached.mean() < 2.5 * max(it_exact.mean(), 1.0)


def test_cached_refresh_engages_on_bad_guess():
    """A constant-velocity guess ~1.5 m off: the motion bound forces
    re-gathers and the pose lands where the exact mode's does, and where
    JAX's cached mode does."""
    rng = np.random.default_rng(11)
    base = rng.uniform(-25, 25, (4096, 3)).astype(np.float32)
    steps = (base, base + np.array([0.4, 0.1, 0], np.float32),
             base + np.array([2.4, 0.4, 0], np.float32))

    def run(icp):
        for frame in steps:
            icp.register_frame_lazy(frame)
        return icp.last_pose

    cached = run(odometry.KissICP(_config(KISSConfig, "cached"), device="cpu"))
    np.testing.assert_allclose(
        cached, run(odometry.KissICP(_config(KISSConfig, "gather27"), device="cpu")), atol=0.05)
    np.testing.assert_allclose(cached, run(jodo.KissICP(_config(JaxConfig, "cached"))), atol=1e-4)
