"""Port ground-plane stabilization (kiss_icp_tpu_torch.ops.ground) against JAX.

  * `nanquantile` gives `jnp.nanquantile`'s bits: the band edge is where
    JAX puts it.
  * `estimate_ground_plane` and `align_pose_to_ground` against JAX at rtol
    1e-5 / atol 1e-6 (f32 sums over thousands of points in another order),
    with `ok` and `num_points` equal, degenerate fits included.
  * A 6-frame drive with engine.ground_align = 0.1 against JAX's KissICP:
    poses within atol 1e-4, iteration counts equal; degenerate scans with
    the stabilizer on stay finite, as in JAX.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.ops import ground as jground
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.ops import ground

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _scene(a=0.02, b=-0.01, c=-1.7, n_ground=3000, n_struct=500, seed=0, noise=0.01):
    """Points on the plane z = ax + by + c in an annulus, plus wall clutter
    (tests/test_ground.py's scene)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(4.0, 28.0, n_ground)
    th = rng.uniform(0, 2 * np.pi, n_ground)
    x, y = r * np.cos(th), r * np.sin(th)
    z = a * x + b * y + c + rng.normal(0, noise, n_ground)
    wall = np.stack([rng.uniform(5, 25, n_struct), rng.uniform(-2, 2, n_struct),
                     rng.uniform(-1.0, 6.0, n_struct)], 1)
    return np.concatenate([np.stack([x, y, z], 1), wall]).astype(np.float32)


@pytest.mark.parametrize("n,nan_share,seed", [(4096, 0.3, 0), (513, 0.0, 1), (97, 0.9, 2),
                                              (64, 1.0, 3), (1, 0.0, 4)])
def test_nanquantile_bit_equal_to_jax(n, nan_share, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(-1.5, 0.4, n).astype(np.float32)
    x[rng.random(n) < nan_share] = np.nan
    for q in (0.15, 0.5, 0.0, 1.0):
        got = ground.nanquantile(torch.from_numpy(x), q).numpy()
        ref = np.asarray(jnp.nanquantile(jnp.asarray(x), q))
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def _hold_plane(points, valid):
    got = ground.estimate_ground_plane(torch.from_numpy(points), torch.from_numpy(valid))
    ref = jground.estimate_ground_plane(jnp.asarray(points), jnp.asarray(valid))
    assert bool(got.ok) == bool(ref.ok)
    assert int(got.num_points) == int(ref.num_points)
    if bool(ref.ok):
        np.testing.assert_allclose(got.normal_body.numpy(), np.asarray(ref.normal_body), **TOL)
        np.testing.assert_allclose(got.height.numpy(), np.asarray(ref.height), **TOL)
    return got


@pytest.mark.parametrize("a,b,c,seed", [(0.02, -0.01, -1.7, 0), (-0.05, 0.03, -2.1, 1),
                                        (0.0, 0.0, -1.2, 2)])
def test_plane_fit_matches_jax(a, b, c, seed):
    pts = _scene(a, b, c, seed=seed)
    valid = np.ones(len(pts), bool)
    valid[::7] = False
    plane = _hold_plane(pts, valid)
    assert bool(plane.ok) and int(plane.num_points) > 500
    n_true = np.array([-a, -b, 1.0]) / np.linalg.norm([-a, -b, 1.0])
    np.testing.assert_allclose(plane.normal_body.numpy(), n_true, atol=2e-3)


@pytest.mark.parametrize("case", ["few_points", "all_invalid", "all_nan", "steep", "line"])
def test_plane_fit_degenerate_cases_match_jax(case):
    pts = _scene()
    valid = np.ones(len(pts), bool)
    if case == "few_points":
        pts, valid = pts[:150], valid[:150]
    elif case == "all_invalid":
        valid[:] = False
    elif case == "all_nan":
        pts[:] = np.nan
    elif case == "steep":  # a 45-degree "ground": the band latches onto a slope
        pts[:, 2] = pts[:, 0]
    elif case == "line":  # every point on one ray: a singular system
        pts[:, 1] = 0.0
        pts[:, 0] = np.abs(pts[:, 0]) + 3.5
    plane = _hold_plane(pts, valid)
    assert not bool(plane.ok)


def _tilted_pose(deg, t=(5.0, -3.0, 1.2)):
    th = np.deg2rad(deg)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
    pose[:3, 3] = t
    return pose


@pytest.mark.parametrize("deg,normal,alignment,ok", [
    (2.0, (0.0, 0.0, 1.0), 0.5, True),    # tilt halved
    (2.0, (0.0, 0.0, 1.0), 0.5, False),   # not ok: exact passthrough
    (0.0, (0.5, 0.0, 0.866), 1.0, True),  # 30 degrees: clamped to 0.05 rad
    (0.0, (0.0, 0.0, 1.0), 0.3, True),    # no tilt: no axis, passthrough
    (-7.0, (0.1, -0.2, 0.97), 0.1, True),
])
def test_align_pose_to_ground_matches_jax(deg, normal, alignment, ok):
    pose = _tilted_pose(deg)
    n = np.asarray(normal, np.float32)
    n /= np.linalg.norm(n)
    got = ground.align_pose_to_ground(
        torch.from_numpy(pose),
        ground.GroundPlane(torch.from_numpy(n), torch.tensor(1.7), torch.tensor(5000),
                           torch.tensor(ok)), alignment)
    ref = jground.align_pose_to_ground(
        jnp.asarray(pose),
        jground.GroundPlane(jnp.asarray(n), jnp.float32(1.7), jnp.int32(5000),
                            jnp.asarray(ok)), alignment)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(got[:3, 3].numpy(), pose[:3, 3])
    if not ok or deg == 0.0 and normal[0] == 0.0:
        np.testing.assert_array_equal(got.numpy(), pose)
    else:
        assert not np.array_equal(got.numpy(), pose)
    n_w = got[:3, :3].numpy() @ n
    moved = np.arccos(np.clip((pose[:3, :3] @ n)[2], -1, 1)) - np.arccos(np.clip(n_w[2], -1, 1))
    assert moved <= 0.05 + 1e-4  # max_correction_rad


def _config(cls, ground_align):
    cfg = cls()
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 8192
    cfg.engine.frame_capacity = 8192
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 15
    cfg.engine.ground_align = ground_align
    return cfg


def test_ground_align_drive_matches_jax():
    ds = SyntheticDataset(sequence=1, n_scans=6, n_beams=16, n_azimuth=512,
                          speed=1.0, accel_frames=6)
    icp = odometry.KissICP(_config(KISSConfig, 0.1), device="cpu")
    jicp = jodo.KissICP(_config(JaxConfig, 0.1))
    off = odometry.KissICP(_config(KISSConfig, 0.0), device="cpu")
    for i in range(6):
        pts, stamps = ds[i]
        for engine in (icp, jicp, off):
            engine.register_frame(pts, stamps)
        np.testing.assert_allclose(icp.last_pose, jicp.last_pose, atol=1e-4, err_msg=f"frame {i}")
        assert icp.last_result.num_iterations == int(jicp.last_result.num_iterations)
    # The knob is live: the stabilized drive leaves the plain one.
    assert not np.allclose(icp.last_pose, off.last_pose, atol=1e-6)


def test_ground_align_survives_degenerate_scans():
    """Empty, all-NaN and out-of-range scans with the stabilizer on: the
    quantile is NaN or the band empty, the fit is not ok, and the pose stays
    finite and equal to JAX's."""
    cfg, jcfg = _config(KISSConfig, 0.15), _config(JaxConfig, 0.15)
    icp, jicp = odometry.KissICP(cfg, device="cpu"), jodo.KissICP(jcfg)
    ds = SyntheticDataset(sequence=0, n_scans=2, n_beams=16, n_azimuth=256,
                          max_range=30.0, speed=1.0, accel_frames=2)
    frames = [ds[0], (np.zeros((0, 3), np.float32), np.zeros(0, np.float32)),
              (np.full((500, 3), np.nan, np.float32), np.zeros(500, np.float32)),
              (np.full((500, 3), 9000.0, np.float32), np.zeros(500, np.float32)), ds[1]]
    for pts, stamps in frames:
        icp.register_frame(pts, stamps)
        jicp.register_frame(pts, stamps)
        assert np.all(np.isfinite(icp.last_pose))
        np.testing.assert_allclose(icp.last_pose, jicp.last_pose, atol=1e-4)
