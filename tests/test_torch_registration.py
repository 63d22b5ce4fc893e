"""Port registration (kiss_icp_tpu_torch.ops.registration) against the JAX one.

`build_linear_system` is the plain version of the port's normal-equation
kernel (kernels/linsys.py). It is held to the JAX einsum and to the Pallas
kernel in interpret mode at the tolerance of tests/test_pallas_kernels.py
(rtol 2e-5 / atol 1e-3: sums of ~10^4 f32 terms in different orders), with
the correspondence count exact. On CPU tensors the kernel wrappers take the
plain versions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu.ops import hash_map as jhm
from kiss_icp_tpu.ops import registration as jreg
from kiss_icp_tpu.ops.pallas_kernels import build_linear_system_pallas
from kiss_icp_tpu_torch.kernels import linsys, nn27
from kiss_icp_tpu_torch.ops import hash_map as hm
from kiss_icp_tpu_torch.ops import registration

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=1e-3)


def _case(n, seed, masked=True, kernel=0.7, center=(3.0, -2.0, 1.0)):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    tgt = (src + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    mask = rng.random(n) > 0.3 if masked else np.zeros(n, bool)
    return (src, tgt, mask, np.float32(kernel), np.asarray(center, np.float32))


@pytest.mark.parametrize("n,seed,masked", [
    (4096, 0, True), (5000, 1, True), (100, 2, True), (2048, 3, False)])
def test_linear_system_matches_jax_and_pallas(n, seed, masked):
    args = _case(n, seed, masked)
    got = registration.build_linear_system(*[torch.from_numpy(np.asarray(a))
                                             for a in args])
    jargs = [jnp.asarray(a) for a in args]
    for ref in (jreg.build_linear_system(*jargs),
                build_linear_system_pallas(*jargs, interpret=True)):
        np.testing.assert_allclose(got.jtj.numpy(), np.asarray(ref.jtj), **TOL)
        np.testing.assert_allclose(got.jtr.numpy(), np.asarray(ref.jtr), **TOL)
        assert int(got.num_correspondences) == int(ref.num_correspondences)
    if not masked:
        assert bool(torch.all(got.jtj == 0)) and int(got.num_correspondences) == 0


def test_wrappers_take_plain_version_on_cpu():
    args = [torch.from_numpy(np.asarray(a)) for a in _case(300, 4)]
    before = linsys.build_linear_system.launches
    a = linsys.build_linear_system(*args)
    b = registration.build_linear_system(*args)
    assert torch.equal(a.jtj, b.jtj) and torch.equal(a.jtr, b.jtr)
    assert linsys.build_linear_system.launches == before
    cfg = hm.MapConfig(voxel_size=1.0, capacity_log2=10)
    m = hm.create_map(cfg)
    before = nn27.query_nearest.launches
    q = nn27.query_nearest(cfg, m, args[0], args[2])
    assert not bool(q.found.any())
    assert nn27.query_nearest.launches == before


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version: a tensor elsewhere that is
    not on CUDA raises before anything is built or launched."""
    args = [torch.from_numpy(np.asarray(a)).to("meta") for a in _case(64, 5)]
    with pytest.raises(ValueError, match="source"):
        linsys.build_linear_system(*args)
    cfg = hm.MapConfig(voxel_size=1.0, capacity_log2=10)
    with pytest.raises(ValueError, match="queries"):
        nn27.query_nearest(cfg, hm.create_map(cfg), args[0], args[2])


@pytest.mark.parametrize("kind", ["regular", "no_correspondences", "singular",
                                  "not_pd", "huge"])
def test_solve_increment_matches_jax(kind):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    jtj = (a @ a.T + 0.5 * np.eye(6)).astype(np.float32)
    jtr = rng.normal(size=6).astype(np.float32)
    count = 100
    if kind == "no_correspondences":
        jtj[:] = 0
        jtr[:] = 0
        count = 0
    elif kind == "singular":
        jtj[:] = 0
        jtj[0, 0] = 1.0
    elif kind == "not_pd":
        jtj = -jtj
    elif kind == "huge":
        jtr *= np.float32(1e6)
    got = registration.solve_increment(registration.LinearSystem(
        torch.from_numpy(jtj), torch.from_numpy(jtr), torch.tensor(count, dtype=torch.int32)))
    ref = jreg.solve_increment(jreg.LinearSystem(
        jnp.asarray(jtj), jnp.asarray(jtr), jnp.asarray(count, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)
    assert np.all(np.isfinite(got.numpy()))
    assert float(torch.linalg.norm(got)) <= 10.0 + 1e-5


def test_align_points_to_map_matches_jax():
    """One registration against a 3-insert map: pose within atol 1e-4,
    iteration count and final correspondence count equal."""
    args = dict(voxel_size=1.0, max_distance=30.0, max_points_per_voxel=20,
                capacity_log2=13)
    cfg, jcfg = hm.MapConfig(**args), jhm.MapConfig(**args)
    rng = np.random.default_rng(6)
    base = rng.uniform(-15, 15, (1500, 3)).astype(np.float32)
    m, jm = hm.create_map(cfg), jhm.create_map(jcfg)
    for i in range(3):
        pts = base + np.float32(0.02 * i)
        m, _ = hm.insert(cfg, m, torch.from_numpy(pts), torch.ones(1500, dtype=torch.bool))
        jm, _ = jhm.insert(jcfg, jm, jnp.asarray(pts), jnp.ones(1500, bool))
    src = base[::3] + np.array([0.15, -0.1, 0.05], np.float32)
    valid = np.ones(len(src), bool)
    guess = np.eye(4, dtype=np.float32)
    guess[:3, 3] = [0.5, 0.2, -0.1]
    sigma = np.float32(0.8)
    got = registration.align_points_to_map(
        cfg, m, torch.from_numpy(src), torch.from_numpy(valid), torch.from_numpy(guess),
        torch.tensor(3 * sigma), torch.tensor(sigma), max_iterations=50,
        convergence=1e-4)
    ref = jreg.align_points_to_map(
        jcfg, jm, jnp.asarray(src), jnp.asarray(valid), jnp.asarray(guess),
        jnp.float32(3 * sigma), jnp.float32(sigma), max_iterations=50,
        convergence=1e-4)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-4)
    assert got.num_iterations == int(ref.num_iterations)
    assert int(got.num_correspondences) == int(ref.num_correspondences)
    assert got.num_iterations > 1
