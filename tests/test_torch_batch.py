"""The sequence axis (kiss_icp_tpu_torch.parallel.batch) against the JAX
package's `parallel/batch.py` and against the port's own single-sequence
step, on the CPU, where the kernels' batched operators take their plain
versions.

Tolerances: the port's batched step against JAX's `make_batched_step` and
`make_batched_chunked_step` at atol 1e-4 with equal iteration counts (JAX
holds its own batched step to its single one at 5e-4,
tests/test_parallel.py:80-81; 1e-4 holds here); each row against the port's
`register_frame` on that row within 1e-5 with equal iterations (the lockstep
loop does the rows' SE(3) algebra as batched matmuls, which may round a bit
apart from the single-row ones); "vmap" against "map" within 1e-5. The rows
move at distinct velocities, so their trip counts differ (the inputs of
tests/test_parallel.py:131-160).
"""

import jax
import numpy as np
import pytest
import torch

from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.parallel import batch as jbatch
from kiss_icp_tpu_torch import convert, odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.kernels import linsys, nn27
from kiss_icp_tpu_torch.ops import hash_map as hm
from kiss_icp_tpu_torch.ops import registration
from kiss_icp_tpu_torch.parallel import batch as pbatch

torch.set_num_threads(1)

B, N, K = 4, 512, 3
ATOL_JAX = 1e-4
ATOL_ROW = 1e-5


def _tiny(cls):
    """tests/test_parallel.py's `_tiny_config`."""
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = N
    cfg.engine.frame_capacity = N
    cfg.engine.source_capacity = 128
    cfg.engine.map_capacity_log2 = 10
    cfg.engine.probe_length = 8
    cfg.engine.group_capacity = 8
    cfg.engine.donate_state = False
    cfg.registration.max_num_iterations = 10
    return cfg


def _drive(b=B, k=K, seed=11):
    """(K, B, N, 3) scans of one random cloud, each row moving at its own
    velocity (tests/test_parallel.py:140-144), zero stamps, all valid."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-30, 30, (b, N, 3)).astype(np.float32)
    pts = np.stack([base + np.arange(1, b + 1)[:, None, None].astype(np.float32)
                    * np.array([0.15 * i, 0.02 * i, 0], np.float32) for i in range(k)])
    return pts, np.zeros((k, b, N), np.float32), np.ones((k, b, N), bool)


def _port_frames(cfg, pts, ts, valid, state=None):
    """The port's batched step over every frame: (poses (K,B,4,4),
    iterations (K,B), state)."""
    step = pbatch.make_batched_step(cfg, pbatch.make_mesh(device="cpu"))
    state = pbatch.init_batched_state(cfg, pts.shape[1], "cpu") if state is None else state
    poses, iters = [], []
    for i in range(pts.shape[0]):
        state, res = step(state, pts[i], ts[i], valid[i])
        poses.append(res.pose.numpy())
        iters.append(res.num_iterations.numpy())
    return np.stack(poses), np.stack(iters), state


def _single_rows(cfg, pts, ts, valid):
    """Each row through the port's single-sequence step: (poses (K,B,4,4),
    iterations (K,B))."""
    poses = np.zeros(pts.shape[:2] + (4, 4), np.float32)
    iters = np.zeros(pts.shape[:2], np.int64)
    for b in range(pts.shape[1]):
        state = odometry.init_state(cfg, "cpu")
        for i in range(pts.shape[0]):
            state, res = odometry.register_frame(
                cfg, state, *(torch.from_numpy(a[i, b]) for a in (pts, ts, valid)))
            poses[i, b] = res.pose.numpy()
            iters[i, b] = int(res.num_iterations)
    return poses, iters


@pytest.fixture(scope="module")
def jax_frames():
    """JAX's make_batched_step over _drive(): (poses, iterations, the state
    after frame 0 and the state at the end, as numpy leaves)."""
    jcfg = _tiny(JaxConfig)
    pts, ts, valid = _drive()
    step = jbatch.make_batched_step(jcfg, jbatch.make_mesh(1))
    state = jbatch.init_batched_state(jcfg, B)
    poses, iters, after0 = [], [], None
    for i in range(K):
        state, res = step(state, pts[i], ts[i], valid[i])
        poses.append(np.asarray(res.pose))
        iters.append(np.asarray(res.num_iterations))
        if i == 0:
            after0 = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
    return np.stack(poses), np.stack(iters), after0


def test_batched_step_matches_jax_make_batched_step(jax_frames):
    jposes, jiters, _ = jax_frames
    poses, iters, _ = _port_frames(_tiny(KISSConfig), *_drive())
    np.testing.assert_array_equal(iters, jiters)
    assert len({tuple(r) for r in iters[1:].T}) > 1, "rows should differ in trip counts"
    np.testing.assert_allclose(poses, jposes, atol=ATOL_JAX)


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_rows_match_the_single_sequence_step(storage):
    cfg = _tiny(KISSConfig)
    cfg.engine.map_storage = storage
    drive = _drive()
    poses, iters, _ = _port_frames(cfg, *drive)
    sposes, siters = _single_rows(cfg, *drive)
    np.testing.assert_array_equal(iters, siters)
    np.testing.assert_allclose(poses, sposes, atol=ATOL_ROW, rtol=0)


@pytest.mark.parametrize("engine", [
    dict(nn_mode="pallas_fused"),  # lockstep, as gather27
    dict(nn_mode="loop27"), dict(nn_mode="compact", nn_live_capacity_log2=9),
    dict(nn_mode="cached"), dict(deskew_refine=1), dict(deskew_refine_map=True),
    dict(ground_align=0.1),
], ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()))
def test_every_mode_and_option_runs_batched_as_single_rows(engine):
    """No mode or option that JAX's batched step takes raises here; those
    off the lockstep path run row by row through register_frame."""
    cfg = _tiny(KISSConfig)
    for key, value in engine.items():
        setattr(cfg.engine, key, value)
    drive = _drive(b=2, k=2)
    poses, iters, _ = _port_frames(cfg, *drive)
    sposes, siters = _single_rows(cfg, *drive)
    np.testing.assert_array_equal(iters, siters)
    np.testing.assert_allclose(poses, sposes, atol=ATOL_ROW, rtol=0)
    assert odometry.lockstep_eligible(cfg) == (engine.get("nn_mode") == "pallas_fused")


def test_one_batched_launch_per_lockstep_iteration(monkeypatch):
    """Each lockstep iteration calls each batched operator once for all
    rows; a frame calls K2 once more for the final count (none while every
    map is empty); the unbatched operators are never called."""
    calls = {"k1": 0, "k2": 0, "single": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(linsys, "build_linear_systems",
                        counted("k1", linsys.build_linear_systems))
    monkeypatch.setattr(nn27, "query_nearest_batched",
                        counted("k2", nn27.query_nearest_batched))
    monkeypatch.setattr(linsys, "build_linear_system",
                        counted("single", linsys.build_linear_system))
    monkeypatch.setattr(nn27, "query_nearest", counted("single", nn27.query_nearest))
    _, iters, _ = _port_frames(_tiny(KISSConfig), *_drive())
    lockstep = int(iters.max(axis=1).sum())
    assert lockstep < int(iters.sum())
    assert calls == {"k1": lockstep, "k2": lockstep + K - 1, "single": 0}


@pytest.fixture(scope="module")
def jax_chunks():
    jcfg = _tiny(JaxConfig)
    pts, ts, valid = _drive()
    out = {}
    for mode in ("vmap", "map"):
        chunk = jbatch.make_batched_chunked_step(jcfg, seq_mode=mode)
        _, poses = chunk(jbatch.init_batched_state(jcfg, B), pts, ts, valid)
        out[mode] = np.asarray(poses)
    return out


def test_chunked_vmap_matches_map_and_jax(jax_chunks):
    cfg = _tiny(KISSConfig)
    drive = _drive()
    poses = {}
    for mode in ("vmap", "map"):
        chunk = pbatch.make_batched_chunked_step(cfg, seq_mode=mode)
        state, p = chunk(pbatch.init_batched_state(cfg, B, "cpu"), *drive)
        assert p.shape == (K, B, 4, 4) and state.pose.shape == (B, 4, 4)
        poses[mode] = p.numpy()
        np.testing.assert_allclose(poses[mode], jax_chunks[mode], atol=ATOL_JAX)
    np.testing.assert_allclose(poses["map"], poses["vmap"], atol=1e-5, rtol=0)
    # "vmap" is the per-frame batched step; "map" is each row's own chunk.
    np.testing.assert_array_equal(poses["vmap"], _port_frames(cfg, *drive)[0])
    np.testing.assert_array_equal(poses["map"], _single_rows(cfg, *drive)[0])


def test_batched_odometry_drops_as_jax():
    """An oversized scan is stride-subsampled with the same drop count as
    JAX's BatchedOdometry; poses agree."""
    cfg, jcfg = _tiny(KISSConfig), _tiny(JaxConfig)
    rng = np.random.default_rng(3)
    frames = [rng.uniform(-30, 30, (n, 3)) for n in (N, 700, 300)]
    stamps = [np.linspace(0, 1, len(f)) for f in frames]
    ours = pbatch.BatchedOdometry(cfg, 3, device="cpu")
    theirs = jbatch.BatchedOdometry(jcfg, 3, mesh=jbatch.make_mesh(1))
    for shift in (0.0, 0.3):
        moved = [f + np.array([shift, 0, 0]) for f in frames]
        got = ours.register_frames(moved, stamps)
        want = theirs.register_frames(moved, stamps)
        assert got.shape == (3, 4, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL_JAX)
        assert ours.last_input_dropped == theirs.last_input_dropped == 700 - N
    assert ours.total_input_dropped == theirs.total_input_dropped == 2 * (700 - N)
    np.testing.assert_allclose(ours.poses, np.asarray(theirs.poses), atol=ATOL_JAX)


def test_step_without_donation_leaves_the_stacked_state():
    cfg = _tiny(KISSConfig)
    pts, ts, valid = _drive()
    _, _, state = _port_frames(cfg, pts[:2], ts[:2], valid[:2])
    before = [t.clone() for t in torch.utils._pytree.tree_leaves(state)]
    step = pbatch.make_batched_step(cfg, pbatch.make_mesh(device="cpu"))
    s1, r1 = step(state, pts[2], ts[2], valid[2])
    s2, r2 = step(state, pts[2], ts[2], valid[2])
    for a, b in zip(torch.utils._pytree.tree_leaves(state), before):
        assert torch.equal(a, b)
    assert torch.equal(r1.pose, r2.pose) and torch.equal(s1.map.points, s2.map.points)
    # A donating step writes the caller's map.
    cfg.engine.donate_state = True
    fresh = pbatch.init_batched_state(cfg, B, "cpu")
    new, _ = pbatch.make_batched_step(cfg)(fresh, pts[0], ts[0], valid[0])
    assert bool(fresh.map.counts.any()) and torch.equal(fresh.map.counts, new.map.counts)


def test_larger_grids_raise():
    """Without a process group this process is the only device: a larger
    grid raises JAX's kind of error (JAX's reshape of too few devices, here
    asked of its 8 virtual ones). Grids over ranks: test_torch_multihost.py."""
    with pytest.raises(ValueError):
        jbatch.make_mesh(16)
    for args in ((2,), (1, 2), (8, 2)):
        with pytest.raises(ValueError):
            pbatch.make_mesh(*args, device="cpu")
    mesh = pbatch.make_mesh(device="cpu")
    assert mesh.shape == {"seq": 1, "pts": 1}
    assert pbatch.batched_state_sharding(mesh) == torch.device("cpu")
    cfg = _tiny(KISSConfig)
    with pytest.raises(ValueError, match="single-device"):
        pbatch.make_batched_chunked_step(cfg, mesh, seq_mode="map")
    with pytest.raises(ValueError, match="seq_mode"):
        pbatch.make_batched_chunked_step(cfg, seq_mode="pmap")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pbatch.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        pbatch.BatchedOdometry(_tiny(KISSConfig), 2)


def test_batched_state_crosses_from_jax_and_continues(jax_frames):
    """JAX's init_batched_state and its state after frame 0 become the
    port's stacked state and back bit for bit; from the latter both
    packages give the same next frames."""
    jcfg, cfg = _tiny(JaxConfig), _tiny(KISSConfig)
    _, _, after0 = jax_frames
    init = [np.asarray(x) for x in jax.tree_util.tree_leaves(jbatch.init_batched_state(jcfg, B))]
    for leaves in (init, after0):
        state = convert.state_from_numpy(leaves, cfg, "cpu")
        assert state.pose.shape == (B, 4, 4) and state.map.points.shape[0] == B
        for a, b in zip(convert.state_to_numpy(state), leaves):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    ours = convert.state_to_numpy(pbatch.init_batched_state(cfg, B, "cpu"))
    for a, b in zip(ours, init):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pts, ts, valid = _drive()
    poses, iters, _ = _port_frames(cfg, pts[1:], ts[1:], valid[1:],
                                   state=convert.state_from_numpy(after0, cfg, "cpu"))
    jposes, jiters, _ = jax_frames
    np.testing.assert_array_equal(iters, jiters[1:])
    np.testing.assert_allclose(poses, jposes[1:], atol=ATOL_JAX)
    with pytest.raises(ValueError, match="state array"):
        convert.state_from_numpy([a[:2] if i else a for i, a in enumerate(after0)], cfg, "cpu")


def _maps(b=3, storage="f32"):
    """b small maps of different random clouds, stacked."""
    cfg = hm.MapConfig(voxel_size=1.0, max_distance=100.0, max_points_per_voxel=8,
                       capacity_log2=11, probe_length=16, group_capacity=16,
                       storage=storage)
    rows = []
    for seed in range(b):
        pts = np.random.default_rng(seed).uniform(-20, 20, (1500, 3)).astype(np.float32)
        m, _ = hm.insert(cfg, hm.create_map(cfg), torch.from_numpy(pts),
                         torch.ones(1500, dtype=torch.bool))
        rows.append(m)
    return cfg, hm.VoxelMap(*(torch.stack(f) for f in zip(*rows))), rows


def _queries(b, s, seed=5):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.uniform(-22, 22, (b, s, 3)).astype(np.float32))
    return q, torch.from_numpy(rng.random((b, s)) > 0.1)


@pytest.mark.parametrize("storage,s", [("f32", 300), ("u16", 300), ("f32", 0)])
def test_nn27_batched_operator(storage, s):
    """opcheck, and the plain batched query equals B calls of the plain
    query; an inactive row gives zeros, inf and nothing found."""
    cfg, m, rows = _maps(3, storage)
    q, valid = _queries(3, s)
    active = torch.tensor([True, False, True])
    args = (q, valid, active, m.vkeys, m.fprints, m.counts, m.points,
            float(cfg.voxel_size), int(cfg.probe_length))
    torch.library.opcheck(torch.ops.kiss_icp_torch.nn27_batched.default, args)
    got = nn27.query_nearest_batched(cfg, m, q, valid, active)
    for b in range(3):
        if active[b]:
            want = hm.query_nearest(cfg, rows[b], q[b], valid[b])
            for x, y in zip(got, want):
                assert torch.equal(x[b], y)
        else:
            assert not bool(got.found[b].any()) and bool(torch.isinf(got.distances[b]).all())
            assert not bool(got.neighbors[b].any())


@pytest.mark.parametrize("n", [700, 0])
def test_linsys_batched_operator(n):
    """opcheck, and the plain batched system equals B calls of the plain
    system; an inactive row gives the zero system."""
    rng = np.random.default_rng(n)
    src = torch.from_numpy(rng.uniform(-50, 50, (3, n, 3)).astype(np.float32))
    tgt = src + torch.from_numpy(rng.normal(0, 0.3, (3, n, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, n)) > 0.3)
    scale = torch.tensor([0.7, 1.1, 0.4])
    center = torch.tensor([[3.0, -2.0, 1.0], [0.0, 5.0, -1.0], [1.0, 1.0, 1.0]])
    active = torch.tensor([True, True, False])
    args = (src, tgt, mask, scale, center, active)
    torch.library.opcheck(torch.ops.kiss_icp_torch.linsys_batched.default, args)
    got = linsys.build_linear_systems(*args)
    assert got.jtj.shape == (3, 6, 6) and got.num_correspondences.dtype == torch.int32
    for b in range(2):
        want = registration.build_linear_system(src[b], tgt[b], mask[b], scale[b], center[b])
        for x, y in zip(got, want):
            assert torch.equal(x[b], y)
    assert not bool(got.jtj[2].any()) and not bool(got.jtr[2].any())
    assert int(got.num_correspondences[2]) == 0


def test_pts_axis_matches_jax():
    """A "pts" axis of 2 in one process (two local blocks of the source):
    the batched step against JAX's on its (1 x 2) ("seq", "pts") mesh at
    the batched tolerance, equal iterations, and against the 1 x 1 grid
    within 1e-5."""
    from kiss_icp_tpu_torch.parallel.grid import DeviceMesh, GridAxis

    cfg, jcfg = _tiny(KISSConfig), _tiny(JaxConfig)
    pts, ts, valid = _drive()
    mesh = DeviceMesh(torch.device("cpu"), (("seq", GridAxis(1)), ("pts", GridAxis(2))))
    step = pbatch.make_batched_step(cfg, mesh)
    state = pbatch.init_batched_state(cfg, B, "cpu")
    got, iters = [], []
    for i in range(K):
        state, res = step(state, pts[i], ts[i], valid[i])
        got.append(res.pose.numpy())
        iters.append(res.num_iterations.numpy())
    jstep = jbatch.make_batched_step(jcfg, jbatch.make_mesh(2, pts_shards=2))
    jstate = jbatch.init_batched_state(jcfg, B)
    for i in range(K):
        jstate, jres = jstep(jstate, pts[i], ts[i], valid[i])
        np.testing.assert_allclose(got[i], np.asarray(jres.pose), atol=ATOL_JAX)
        np.testing.assert_array_equal(iters[i], np.asarray(jres.num_iterations))
    one, _, _ = _port_frames(cfg, pts, ts, valid)
    np.testing.assert_allclose(np.stack(got), one, atol=ATOL_ROW)
