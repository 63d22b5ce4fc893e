"""Sharded single-sequence ICP over a "pts" axis
(kiss_icp_tpu_torch.parallel.sharded_icp) against the JAX package's
`make_sharded_align` on its 8-device CPU mesh and against the port's
single-device `align_points_to_map`, on the CPU.

Tolerances: tests/test_sharded_icp.py's, pose within 1e-4 of the
single-device solver and within 5e-3 of the ground truth, the final
correspondence count equal; against JAX's sharded align within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kiss_icp_tpu.ops import hash_map as jhm
from kiss_icp_tpu.parallel import sharded_icp as jsi
from kiss_icp_tpu_torch.ops import hash_map, registration
from kiss_icp_tpu_torch.parallel import sharded_icp
from kiss_icp_tpu_torch.parallel.grid import DeviceMesh, GridAxis

import oracle

torch.set_num_threads(1)


def _surface_cloud(n=2048, seed=0):
    """tests/test_sharded_icp.py's floor and two walls."""
    rng = np.random.default_rng(seed)
    n3 = n // 3
    floor = np.stack([rng.uniform(-20, 20, n3), rng.uniform(-20, 20, n3),
                      np.full(n3, -2.0)], axis=1)
    wall_x = np.stack([np.full(n3, 15.0), rng.uniform(-20, 20, n3),
                       rng.uniform(-2, 6, n3)], axis=1)
    rest = n - 2 * n3
    wall_y = np.stack([rng.uniform(-20, 20, rest), np.full(rest, -12.0),
                       rng.uniform(-2, 6, rest)], axis=1)
    return np.concatenate([floor, wall_x, wall_y]).astype(np.float32)


def _problem():
    cloud = _surface_cloud()
    rng = np.random.default_rng(1)
    twist = np.concatenate([rng.uniform(-0.2, 0.2, 3), rng.uniform(-0.01, 0.01, 3)])
    gt = oracle.se3_exp(twist)
    inv = np.linalg.inv(gt)
    body = (cloud @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    return cloud, body, gt


@pytest.mark.parametrize("stripes", [2, 8])
def test_sharded_align_matches_single_device_and_jax(stripes):
    cloud, body, gt = _problem()
    kw = dict(voxel_size=1.0, max_distance=100.0, capacity_log2=14)
    cfg = hash_map.MapConfig(**kw)
    m, _ = hash_map.insert(cfg, hash_map.create_map(cfg), torch.from_numpy(cloud),
                           torch.ones(len(cloud), dtype=torch.bool))
    args = (torch.from_numpy(body), torch.ones(len(body), dtype=torch.bool),
            torch.eye(4), torch.tensor(2.0), torch.tensor(0.7))
    single = registration.align_points_to_map(cfg, m, *args, max_iterations=60,
                                              convergence=1e-5)
    mesh = DeviceMesh(torch.device("cpu"), ((sharded_icp.PTS_AXIS, GridAxis(stripes)),))
    sharded = sharded_icp.make_sharded_align(cfg, mesh, max_iterations=60,
                                             convergence=1e-5)(m, *args)
    np.testing.assert_allclose(sharded.pose.numpy(), single.pose.numpy(), atol=1e-4)
    np.testing.assert_allclose(sharded.pose.numpy(), gt, atol=5e-3)
    assert int(sharded.num_correspondences) == int(single.num_correspondences)

    jcfg = jhm.MapConfig(**kw)
    jm, _ = jhm.insert(jcfg, jhm.create_map(jcfg), jnp.asarray(cloud),
                       jnp.ones(len(cloud), bool))
    jmesh = Mesh(np.asarray(jax.devices()[:stripes]), (jsi.PTS_AXIS,))
    jres = jsi.make_sharded_align(jcfg, jmesh, max_iterations=60, convergence=1e-5)(
        jm, jnp.asarray(body), jnp.ones(len(body), bool), jnp.eye(4, dtype=jnp.float32),
        jnp.float32(2.0), jnp.float32(0.7))
    np.testing.assert_allclose(sharded.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
    assert int(sharded.num_correspondences) == int(jres.num_correspondences)


def test_block_systems_sum_the_blocks():
    """The pts axis's block sums equal one system over all the points (the
    plain K1 within f32 rounding), and an indivisible split raises."""
    rng = np.random.default_rng(3)
    b, n = 2, 64
    src = torch.from_numpy(rng.uniform(-5, 5, (b, n, 3)).astype(np.float32))
    tgt = src + torch.from_numpy(rng.normal(0, 0.1, (b, n, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((b, n)) > 0.2)
    ks, center = torch.full((b,), 0.7), torch.zeros(b, 3)
    active = torch.ones(b, dtype=torch.bool)
    whole = [registration.build_linear_system(src[i], tgt[i], mask[i], ks[i], center[i])
             for i in range(b)]
    got = sharded_icp.block_systems(GridAxis(4), src, tgt, mask, ks, center, active)
    for i in range(b):
        np.testing.assert_allclose(got.jtj[i].numpy(), whole[i].jtj.numpy(), rtol=1e-5,
                                   atol=1e-4)
        assert int(got.num_correspondences[i]) == int(whole[i].num_correspondences)
    with pytest.raises(ValueError, match="blocks"):
        sharded_icp.local_points(GridAxis(3), src, 1)
