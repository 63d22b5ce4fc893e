"""Port SE(3) math (kiss_icp_tpu_torch.ops.se3) against the JAX package.

Same float32 inputs, made with numpy from a seed, through both. Both are f32
with the same formulas but different kernels (XLA fuses and may contract to
FMA, PyTorch rounds every op), so values agree to a few f32 ulp of the
result's scale: atol 2e-6 on unit-scale outputs (rotations, coefficients),
rtol 2e-6 / atol 1e-5 on translations up to ~50 m.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu.ops import se3 as jse3
from kiss_icp_tpu_torch.ops import se3

torch.set_num_threads(1)

UNIT = dict(rtol=0, atol=2e-6)
METRIC = dict(rtol=2e-6, atol=1e-5)


def _twists(seed, n=64):
    """Twists whose rotation angles span tiny (< 3.5e-4 rad, where arccos
    would read zero), Taylor-branch (< 1e-3), generic, and near pi."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angles = np.concatenate([
        rng.uniform(1e-6, 3.5e-4, n // 4),
        rng.uniform(3.5e-4, 1e-3, n // 4),
        rng.uniform(1e-3, 3.0, n // 4),
        np.pi - rng.uniform(1e-4, 5e-3, n - 3 * (n // 4)),
    ])
    w = axis * angles[:, None]
    v = rng.uniform(-20, 20, (n, 3))
    return np.concatenate([v, w], axis=1).astype(np.float32)


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*[torch.from_numpy(a) for a in arrays])
    ref = fn_j(*[jnp.asarray(a) for a in arrays])
    return got, ref


def _close(got, ref, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


def test_hat_vee_exact():
    w = _twists(0)[:, 3:]
    got, ref = _both(se3.hat, jse3.hat, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    m = got.numpy()
    got, ref = _both(se3.vee, jse3.vee, m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sinc_terms():
    theta2 = (_twists(1)[:, 3:] ** 2).sum(-1).astype(np.float32)
    got, ref = _both(se3._sinc_terms, jse3._sinc_terms, theta2)
    for g, r in zip(got, ref):
        _close(g, r, UNIT)


def test_so3_exp_and_angle():
    w = _twists(2)[:, 3:]
    got, ref = _both(se3.so3_exp, jse3.so3_exp, w)
    _close(got, ref, UNIT)
    r = got.numpy()
    got, ref = _both(se3.rotation_angle, jse3.rotation_angle, r)
    _close(got, ref, UNIT)
    # The atan2 form resolves the tiny angles that arccos would read as 0.
    tiny = np.linalg.norm(w, axis=1) < 3.5e-4
    assert np.all(got.numpy()[tiny] > 0)


def test_so3_log_generic_and_near_pi():
    r = se3.so3_exp(torch.from_numpy(_twists(3)[:, 3:])).numpy()
    got, ref = _both(se3.so3_log, jse3.so3_log, r)
    _close(got, ref, dict(rtol=0, atol=2e-5))


@pytest.mark.parametrize("name", ["_v_matrix", "_v_matrix_inv"])
def test_v_matrices(name):
    w = _twists(4)[:, 3:]
    got, ref = _both(getattr(se3, name), getattr(jse3, name), w)
    _close(got, ref, UNIT)


def test_se3_exp_log():
    x = _twists(5)
    got, ref = _both(se3.se3_exp, jse3.se3_exp, x)
    _close(got, ref, METRIC)
    pose = got.numpy()
    # Away from pi, where log is well conditioned.
    gen = np.linalg.norm(x[:, 3:], axis=1) < 3.0
    got, ref = _both(se3.se3_log, jse3.se3_log, pose[gen])
    _close(got, ref, dict(rtol=2e-5, atol=2e-5))


def test_rt_identity_inverse_orthonormalize_transform():
    x = _twists(6)
    pose = se3.se3_exp(torch.from_numpy(x)).numpy()
    got, ref = _both(se3.rt_to_matrix, jse3.rt_to_matrix,
                     pose[:, :3, :3], pose[:, :3, 3])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(se3.identity().numpy(),
                                  np.asarray(jse3.identity()))
    got, ref = _both(se3.inverse, jse3.inverse, pose)
    _close(got, ref, METRIC)
    # A rotation with f32 scale drift, as long compositions leave it.
    drift = pose.copy()
    drift[:, :3, :3] *= np.float32(1.0 + 3e-3)
    got, ref = _both(se3.orthonormalize, jse3.orthonormalize, drift)
    _close(got, ref, METRIC)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-50, 50, (500, 3)).astype(np.float32)
    got, ref = _both(se3.transform, jse3.transform, pose[10], pts)
    _close(got, ref, dict(rtol=2e-6, atol=2e-5))


def test_exp_scaled_batch():
    x = _twists(8)[20]
    scales = np.linspace(-1.0, 0.0, 257, dtype=np.float32)
    got, ref = _both(se3.exp_scaled_batch, jse3.exp_scaled_batch, x, scales)
    _close(got, ref, METRIC)
