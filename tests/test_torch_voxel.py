"""Port voxelization and preprocessing against the JAX package.

`voxel_downsample` and `group_by_voxel` must be bit-equal (same survivors,
same order, same drop counts), including capacity overflow, invalid rows and
coordinates outside the 15-bit key envelope. Preprocess is an f32 deskew by
per-point SE(3) exponentials: points agree to f32 rounding of ~50 m
coordinates (rtol 2e-6 / atol 2e-5), validity exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu.ops import preprocess as jpre
from kiss_icp_tpu.ops import voxel as jvox
from kiss_icp_tpu_torch.ops import preprocess, se3, voxel

torch.set_num_threads(1)


def _cloud(seed, n, spread=30.0, oob=False):
    """Random points, a tenth invalid; duplicates in voxels; optionally a
    few far outside the key envelope (|coord| > 16384 voxels)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    pts[: n // 4] = pts[n // 4: n // 2] + rng.normal(0, 0.05, (n // 4, 3))
    if oob:
        pts[-20:] = rng.uniform(3e4, 4e4, (20, 3)) * rng.choice([-1, 1], (20, 3))
    valid = rng.random(n) > 0.1
    return pts.astype(np.float32), valid


@pytest.mark.parametrize("voxel_size,capacity,oob", [
    (0.5, 4096, False),   # no overflow
    (1.5, 512, False),    # overflow: hash-ordered drops
    (0.5, 3000, True),    # out-of-envelope rows
    (1.0, 64, True),      # heavy overflow
])
def test_voxel_downsample_bit_equal(voxel_size, capacity, oob):
    pts, valid = _cloud(0, 5000, oob=oob)
    got = voxel.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(valid),
                                 voxel_size=voxel_size, capacity=capacity)
    ref = jvox.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid),
                                voxel_size=voxel_size, capacity=capacity)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert int(got.num_kept) == int(ref.num_kept)
    assert int(got.num_dropped) == int(ref.num_dropped)
    if capacity < 1000:
        assert int(got.num_dropped) > 0


@pytest.mark.parametrize("group_capacity,oob", [(16, False), (3, True)])
def test_group_by_voxel_bit_equal(group_capacity, oob):
    pts, valid = _cloud(1, 3000, spread=8.0, oob=oob)
    args = dict(voxel_size=1.0, group_capacity=group_capacity)
    got = voxel.group_by_voxel(torch.from_numpy(pts), torch.from_numpy(valid), **args)
    ref = jvox.group_by_voxel(jnp.asarray(pts), jnp.asarray(valid), **args)
    for name in ("coords", "group_valid", "candidates", "cand_valid", "num_groups"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_keys_and_envelope_exact():
    rng = np.random.default_rng(2)
    coords = rng.integers(-20000, 20000, (4000, 3)).astype(np.int32)
    valid = rng.random(4000) > 0.2
    for margin in (0, 1):
        np.testing.assert_array_equal(
            voxel.in_envelope(torch.from_numpy(coords), margin).numpy(),
            np.asarray(jvox.in_envelope(jnp.asarray(coords), margin)))
    for g, r in zip(voxel.pack_voxel_keys(torch.from_numpy(coords),
                                          torch.from_numpy(valid)),
                    jvox.pack_voxel_keys(jnp.asarray(coords), jnp.asarray(valid))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    pts = rng.uniform(-100, 100, (4000, 3)).astype(np.float32)
    for v in (0.5, 1.0, 1.5):
        np.testing.assert_array_equal(
            voxel.point_to_voxel(torch.from_numpy(pts), v).numpy(),
            np.asarray(jvox.point_to_voxel(jnp.asarray(pts), v)))


@pytest.mark.parametrize("stamps", ["ramp", "none", "deskew_off"])
def test_preprocess(stamps):
    rng = np.random.default_rng(3)
    n = 4000
    pts = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    pts[:10] = np.nan  # garbage rows must end invalid
    valid = rng.random(n) > 0.05
    ts = (np.linspace(0.2, 0.3, n) if stamps == "ramp" else np.zeros(n)).astype(np.float32)
    ts[~valid] = 7.0  # stamps of invalid rows must not enter the normalization
    twist = np.array([0.4, -0.1, 0.02, 0.01, -0.02, 0.05], np.float32)
    motion = se3.se3_exp(torch.from_numpy(twist)).numpy()
    kw = dict(max_range=50.0, min_range=2.0, deskew=stamps != "deskew_off")
    got = preprocess.preprocess(torch.from_numpy(pts), torch.from_numpy(ts),
                                torch.from_numpy(valid), torch.from_numpy(motion), **kw)
    ref = jpre.preprocess(jnp.asarray(pts), jnp.asarray(ts), jnp.asarray(valid),
                          jnp.asarray(motion), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    ok = got.valid.numpy()
    np.testing.assert_allclose(got.points.numpy()[ok], np.asarray(ref.points)[ok],
                               rtol=2e-6, atol=2e-5)
    if stamps == "ramp":
        moved = np.abs(got.points.numpy()[ok] - pts[ok]).max()
        assert moved > 0.01  # the scan really was deskewed
    else:
        np.testing.assert_array_equal(got.points.numpy()[ok], pts[ok])
