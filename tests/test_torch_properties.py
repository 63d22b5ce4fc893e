"""Property-based tests (hypothesis) of the port's core op algebra: the
twin of tests/test_properties.py.

The nine invariants of the JAX suite, on the port's ops/se3.py, ops/voxel.py,
ops/threshold.py, ops/hash_map.py (through K2's wrapper) and odometry.py,
with its fixtures, shapes, example counts (KISS_PROP_EXAMPLES included)
and bounds, and its |x| < 1e-3 snaps exactly as it has them. The runs are
derandomized, so the tier-1 count is the same run to run. Each example also
goes through the JAX function, and the two must agree at the tolerances of
tests/test_torch_se3.py, test_torch_voxel.py (bit-equal),
test_torch_threshold.py, test_torch_hash_map.py and test_torch_odometry.py.

The map query and the garbage fuzz run through tests/torch_properties.py,
whose runners chip_smoke.py's phase "properties" also runs on the card, on
the same examples (there K2 answers the query and K1/K2 carry the fuzz). The
map query runs on f32 and u16 maps (JAX's property stores f32 only; its u16
twin is held to JAX's u16 map). One property is the port's own: the same
garbage over a scene, because JAX's fuzz crops every frame of its examples
to nothing and so never reaches the Gauss-Newton loop (nor K1 on the card).
"""

import os
import subprocess
import sys
from pathlib import Path

import hypothesis
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import assume, given, strategies as st

import torch_properties as tp
from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.ops import hash_map as jhm
from kiss_icp_tpu.ops import se3 as jse3
from kiss_icp_tpu.ops import threshold as jthreshold
from kiss_icp_tpu.ops import voxel as jvoxel
from kiss_icp_tpu_torch.ops import se3, threshold, voxel

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SET, finite, twists, points_small = tp.SET, tp.finite, tp.twists, tp.points_small
# tests/test_torch_se3.py's tolerances against JAX.
UNIT = dict(rtol=0, atol=2e-6)
METRIC = dict(rtol=2e-6, atol=1e-5)
LOG = dict(rtol=2e-5, atol=2e-5)


def _exp(xi):
    """The port's and JAX's se3_exp of one twist, as numpy."""
    return (se3.se3_exp(torch.from_numpy(xi)).numpy(),
            np.asarray(jse3.se3_exp(jnp.asarray(xi))))


@SET
@given(twists)
def test_se3_exp_is_rigid(xi):
    t, jt = _exp(xi)
    r = t[:3, :3]
    np.testing.assert_allclose(r.T @ r, np.eye(3), atol=2e-6)
    assert abs(np.linalg.det(r) - 1.0) < 5e-6
    np.testing.assert_array_equal(t[3], [0, 0, 0, 1])
    np.testing.assert_allclose(t, jt, **METRIC)


@SET
@given(twists)
def test_se3_exp_log_roundtrip(xi):
    # Keep |w| below pi where log is unique.
    w = xi[3:]
    n = np.linalg.norm(w)
    if n > 3.0:
        xi = np.concatenate([xi[:3], w * (3.0 / n)]).astype(np.float32)
    back = se3.se3_log(se3.se3_exp(torch.from_numpy(xi))).numpy()
    np.testing.assert_allclose(back, xi, atol=5e-5, rtol=5e-4)
    jback = np.asarray(jse3.se3_log(jse3.se3_exp(jnp.asarray(xi))))
    np.testing.assert_allclose(back, jback, **LOG)


@SET
@given(twists, twists)
def test_se3_group_laws(a, b):
    ta, tb = se3.se3_exp(torch.from_numpy(a)), se3.se3_exp(torch.from_numpy(b))
    # inverse
    np.testing.assert_allclose((ta @ se3.inverse(ta)).numpy(), np.eye(4), atol=1e-5)
    # associativity of compose with inverse round trip
    ab = (se3.inverse(tb) @ (tb @ ta)).numpy()
    np.testing.assert_allclose(ab, ta.numpy(), atol=1e-5)
    jta, jtb = jse3.se3_exp(jnp.asarray(a)), jse3.se3_exp(jnp.asarray(b))
    np.testing.assert_allclose(se3.inverse(ta).numpy(), np.asarray(jse3.inverse(jta)),
                               **METRIC)
    np.testing.assert_allclose(ab, np.asarray(jse3.inverse(jtb) @ (jtb @ jta)), atol=1e-5)


@SET
@given(twists, points_small)
def test_transform_inverse_restores_points(xi, pts):
    t = se3.se3_exp(torch.from_numpy(xi))
    moved = se3.transform(t, torch.from_numpy(pts))
    back = se3.transform(se3.inverse(t), moved).numpy()
    np.testing.assert_allclose(back, pts, atol=2e-4)
    jt = jse3.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(moved.numpy(), np.asarray(jse3.transform(jt, jnp.asarray(pts))),
                               **METRIC)


@SET
@given(twists)
def test_orthonormalize_projects_and_is_stable(xi):
    t, _ = _exp(xi)
    noisy = t.copy()
    noisy[:3, :3] += 1e-3 * np.arange(9, dtype=np.float32).reshape(3, 3) / 9.0
    fixed = se3.orthonormalize(torch.from_numpy(noisy)).numpy()
    r = fixed[:3, :3]
    np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-5)
    twice = se3.orthonormalize(torch.from_numpy(fixed)).numpy()
    np.testing.assert_allclose(twice, fixed, atol=1e-6)
    np.testing.assert_allclose(fixed[:3, 3], noisy[:3, 3])  # translation kept
    np.testing.assert_allclose(fixed, np.asarray(jse3.orthonormalize(jnp.asarray(noisy))),
                               **UNIT)


@SET
@given(points_small, st.floats(0.3, 3.0))
def test_downsample_subset_unique_lowest_index(pts, vsize):
    # The JAX property's two knife edges, kept as it has them: near-zero
    # coordinates snapped (XLA's subnormal flush), examples within 1e-4 of
    # a nonzero voxel face discarded (XLA's p * (1/v)).
    pts = np.where(np.abs(pts) < 1e-3, 0.0, pts).astype(np.float32)
    q = pts.astype(np.float64) / vsize
    frac = np.abs(q - np.round(q))
    assume(bool(np.all((frac > 1e-4) | (np.round(q) == 0))))
    valid = np.ones(len(pts), bool)
    out = voxel.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(valid),
                                 voxel_size=float(vsize), capacity=128)
    opts = out.points.numpy()[out.valid.numpy()]
    assert int(out.num_dropped) == 0
    keys_in = np.floor(pts / vsize).astype(np.int64)
    keys_out = np.floor(opts / vsize).astype(np.int64)
    # one output per occupied voxel, exactly
    uin = {tuple(k) for k in keys_in}
    uout = [tuple(k) for k in keys_out]
    assert len(uout) == len(set(uout)) == len(uin)
    # each output IS the lowest-index input of its voxel
    first = {}
    for i, k in enumerate(map(tuple, keys_in)):
        first.setdefault(k, pts[i])
    for k, p in zip(uout, opts):
        np.testing.assert_array_equal(p, first[k])
    ref = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid),
                                  voxel_size=float(vsize), capacity=128)
    np.testing.assert_array_equal(out.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))


@SET
@given(st.lists(st.floats(0.0, 3.0, **finite), min_size=1, max_size=40),
       st.floats(0.05, 0.5))
def test_threshold_recurrence_matches_f64_oracle(errors, min_motion):
    """Translation-only model deviations against the reference recurrence
    (Threshold.cpp:30-51) in float64, and against JAX's threshold."""
    state = threshold.init_state(2.0)
    jstate = jthreshold.init_state(2.0)
    kw = dict(max_range=100.0, min_motion_th=float(min_motion))
    sse, num = 2.0**2, 1
    for e in errors:
        dev = np.eye(4, dtype=np.float32)
        dev[0, 3] = e
        state = threshold.update_model_deviation(state, torch.from_numpy(dev), **kw)
        jstate = jthreshold.update_model_deviation(jstate, jnp.asarray(dev), **kw)
        # The gate compares in f32, as the JAX property mirrors.
        if np.float32(e) > np.float32(min_motion):
            sse += float(np.float32(e)) ** 2
            num += 1
        sigma = float(threshold.compute_threshold(state))
        np.testing.assert_allclose(sigma, np.sqrt(sse / num), rtol=2e-4)
        np.testing.assert_allclose(sigma, float(jthreshold.compute_threshold(jstate)),
                                   rtol=1e-5)
        assert float(state.num_samples) == float(jstate.num_samples)


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_map_query_honest_and_optimal(storage):
    """Whatever the map stored, every answer is honest and optimal against
    brute force over the 27-voxel neighbourhood (tests/torch_properties.py),
    on the drawn and on the recorded examples, and equals JAX's query on
    JAX's map of the same points at tests/test_torch_hash_map.py's
    tolerance: found equal, distances rtol 1e-6, the neighbour at JAX's
    distance rtol 1e-5. On u16 maps both may also differ by one ulp of the
    neighbour's coordinates: XLA fuses JAX's decode into an FMA, the port
    rounds its two steps (`test_u16_decode_rounding_parts_from_jax`)."""
    jcfg = jhm.MapConfig(storage=storage, **tp.MAP_KW)

    def against_jax(store_pts, queries, result):
        nn, dist, found = result
        store_pts, queries = tp.snap(store_pts), tp.snap(queries)
        jm, _ = jhm.insert(jcfg, jhm.create_map(jcfg), jnp.asarray(store_pts),
                           jnp.ones(len(store_pts), bool))
        ref = jhm.query_nearest(jcfg, jm, jnp.asarray(queries), jnp.ones(len(queries), bool))
        f = np.asarray(ref.found)
        np.testing.assert_array_equal(found, f)
        jdist = np.asarray(ref.distances)[f]
        ulp = np.spacing(np.abs(nn[f]).max(axis=1)) if storage == "u16" else 0.0
        for got, rtol in ((dist[f], 1e-6), (np.linalg.norm(queries[f] - nn[f], axis=1), 1e-5)):
            assert np.all(np.abs(got - jdist) <= rtol * jdist + ulp), (got, jdist)

    assert tp.run_map_query(storage, "cpu", against_jax) >= tp.SET.max_examples
    assert tp.replay_map_query(storage, "cpu", against_jax) == 30


def test_u16_decode_rounding_parts_from_jax():
    """Witness (ROADMAP Queue 3, "u16 decode"): a stored point 0.343 m from
    its query, where the neighbour's u16 decode s * (v / 65535) + corner
    rounds once in JAX (XLA's FMA) and twice in the port, one ulp (9.5e-7 m
    at 8 m) apart: 2.8e-6 of the distance, over rtol 1e-6. Both answers are
    honest and optimal."""
    store = np.zeros((64, 3), np.float32)
    store[0, 0] = 8.3431225
    queries = np.zeros((64, 3), np.float32)
    queries[0, 0] = 8.0
    nn, dist, _ = tp.map_query_example(store, queries, "u16", "cpu")
    jcfg = jhm.MapConfig(storage="u16", **tp.MAP_KW)
    jm, _ = jhm.insert(jcfg, jhm.create_map(jcfg), jnp.asarray(store), jnp.ones(64, bool))
    ref = jhm.query_nearest(jcfg, jm, jnp.asarray(queries), jnp.ones(64, bool))
    stored = np.float32(np.round(np.float32(0.3431225) * np.float32(65535.0)))
    scale = np.float32(1.0) / np.float32(65535.0)
    assert nn[0, 0] == np.float32(stored * scale) + np.float32(8.0)  # two roundings
    assert np.asarray(ref.neighbors)[0, 0] == np.float32(np.float64(stored) * np.float64(scale)
                                                         + 8.0)  # one
    assert nn[0, 0] - np.asarray(ref.neighbors)[0, 0] == np.spacing(np.float32(8.0))
    assert abs(dist[0] - float(ref.distances[0])) > 1e-6 * dist[0]


_JAX_FUZZ_STEP = None


def _jax_fuzz_step():
    global _JAX_FUZZ_STEP
    if _JAX_FUZZ_STEP is None:
        from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig

        _JAX_FUZZ_STEP = (tp.fuzz_config(JaxConfig), jodo.make_step(tp.fuzz_config(JaxConfig)))
    return _JAX_FUZZ_STEP


def _hat(p):
    return np.array([[0.0, -p[2], p[1]], [p[2], 0.0, -p[0]], [-p[1], p[0], 0.0]])


def _well_posed(pts, valid) -> bool:
    """Whether the frame's normal equations can have full rank: J^T J of
    its distinct in-range points (1-50 m, the fuzz config's crop), J = [I,
    -[p]x] a point, has its smallest eigenvalue above 1e-6 of its largest.
    Fewer than three distinct points, or all of them on one line, leave a
    rotation unobserved: the 6x6 solve then returns what rounding makes of
    a singular system, in either package."""
    r = np.linalg.norm(pts, axis=1)
    keep = valid & np.isfinite(r) & (r > 1.0) & (r < 50.0)
    p = np.unique(pts[keep].astype(np.float64), axis=0)
    if len(p) < 3:
        return False
    p -= p.mean(axis=0)
    jtj = sum(np.hstack([np.eye(3), -_hat(q)]).T @ np.hstack([np.eye(3), -_hat(q)]) for q in p)
    ev = np.linalg.eigvalsh(jtj)
    return bool(ev[0] > 1e-6 * ev[-1])


def _against_jax_step(pts, valid, frames, compared=None):
    """Each frame's pose within 1e-4 of JAX's step on the same frames,
    iterations equal (tests/test_torch_odometry.py), up to the first frame
    whose Gauss-Newton loop ran on a rank-deficient problem (`_well_posed`):
    from there on both packages carry a pose that rounding chose
    (`test_ill_posed_garbage_parts_from_jax`). `compared` counts the frames
    held to JAX and the frames not."""
    jcfg, step = _jax_fuzz_step()
    state = jodo.init_state(jcfg)
    ts = jnp.zeros((256,), jnp.float32)
    for i, (pose, sigma, iters) in enumerate(frames):
        state, res = step(state, jnp.asarray(pts[i]), ts, jnp.asarray(valid[i]))
        if (iters or int(res.num_iterations)) and not _well_posed(pts[i], valid[i]):
            if compared is not None:
                compared["not"] += len(frames) - i
            return
        np.testing.assert_allclose(pose, np.asarray(res.pose), atol=1e-4)
        assert iters == int(res.num_iterations)
        if compared is not None:
            compared["held"] += 1


def test_register_frame_survives_garbage():
    """NaN floods, +-1e4 outliers and random masks, drawn and recorded:
    every pose finite and SE(3), sigma finite (tests/torch_properties.py),
    and JAX's poses."""
    compared = {"held": 0, "not": 0}
    assert tp.run_garbage("cpu", _against_jax_step) >= tp.FUZZ_SET.max_examples
    assert tp.replay_garbage("garbage", "cpu",
                             lambda *a: _against_jax_step(*a, compared)) == 15
    assert compared == {"held": 60, "not": 0}


def test_register_frame_survives_garbage_in_a_scene():
    """The same garbage over a scene, so that the Gauss-Newton loop runs on
    what survives: JAX's own fuzz crops every frame of its recorded
    examples to nothing (no point lands 1-50 m out) and never reaches the
    loop; here most recorded examples run it."""
    iterations, compared = [], {"held": 0, "not": 0}

    def check(pts, valid, frames):
        iterations.append(sum(f[2] for f in frames))
        _against_jax_step(pts, valid, frames, compared)

    assert tp.run_garbage_in_scene("cpu", _against_jax_step) >= tp.FUZZ_SET.max_examples
    assert tp.replay_garbage("scene", "cpu", check) == 15
    assert sum(it > 0 for it in iterations) >= 10, iterations
    # 11 frames of the recorded examples follow a rank-deficient one (1-2
    # distinct points in range): the other 49 are held to JAX.
    assert compared == {"held": 49, "not": 11}, compared


def test_ill_posed_garbage_parts_from_jax():
    """Witness (ROADMAP Queue 3): garbage that leaves two distinct points in
    range, (1, 1, 1) and (0, 1, 1), in a hypothesis-shrunk example. From
    frame 2 on, one correspondence gives a rank-deficient 6x6 system: both
    packages keep every pose finite and SE(3), and they part (by 0.24 m at
    frame 2): neither answer is determined by the input."""
    pts = np.ones((4, 256, 3), np.float32)
    pts[1, 0] = [0.0, 1.0, 1.0]
    valid = np.ones((4, 256), bool)
    frames = tp.garbage_example(pts, valid, "cpu")
    assert not _well_posed(pts[1], valid[1])
    jcfg, step = _jax_fuzz_step()
    state = jodo.init_state(jcfg)
    for i, (pose, sigma, iters) in enumerate(frames):
        state, res = step(state, jnp.asarray(pts[i]), jnp.zeros((256,), jnp.float32),
                          jnp.asarray(valid[i]))
        jpose = np.asarray(res.pose)
        assert np.all(np.isfinite(jpose))
        np.testing.assert_allclose(jpose[:3, :3].T @ jpose[:3, :3], np.eye(3), atol=1e-4)
        if i == 0:
            np.testing.assert_array_equal(pose, jpose)
        else:
            assert iters > 0 and int(res.num_correspondences) == 1
            assert np.abs(pose - jpose).max() > 0.1


def test_recorded_examples_are_the_runners_draws():
    """tests/torch_property_examples.npz (what the card replays) is what the
    runners draw in a fresh process with the hypothesis version that
    recorded it: within a test worker the draws also depend on the modules
    loaded before (hypothesis mixes the constants of local modules into
    its draws), so the check runs in its own process."""
    rec = tp.recorded()
    if str(rec["hypothesis_version"]) != hypothesis.__version__:
        pytest.skip(f"recorded with hypothesis {rec['hypothesis_version']}, "
                    f"this is {hypothesis.__version__}: its draws differ")
    env = {k: v for k, v in os.environ.items() if k != "KISS_PROP_EXAMPLES"}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, str(REPO / "tests" / "torch_properties.py"), "--check"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
