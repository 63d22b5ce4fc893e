"""`engine.gn_unroll` in the port: u Gauss-Newton iterations per ICP loop
trip, and so per host read of the convergence test, with the trajectory and
the iteration counts of u = 1 (JAX: tests/test_registration.py:137-175).

On the CPU, where the kernels take their plain versions:
  * the single loop (KissICP over tests/test_registration.py's 16 x 256-beam
    drive, 2^14 slots, 10 frames): at u = 2, 3, 4 poses and iterations equal
    u = 1's bit for bit; at u = 1, 2, 4 within 1e-4 m of JAX's KissICP at
    the same u, iterations equal;
  * the knob is honoured, counted from outside (tests/torch_gn_count.py):
    trips = ceil(iterations / u) a frame, iterations run = trips x u, the
    plain K1 calls equal the iterations run and the plain K2 calls one more
    a frame (the final count); with max_num_iterations 5 at u = 4, two trips
    and 5 iterations, the state frozen after the fifth;
  * the lockstep loop (BatchedOdometry, 3 rows: sequences 0-2 of the same
    LiDAR), the map axis (map_shards = 2) and two gloo ranks of
    tests/torch_multihost_worker.py (4 map shards as 2 ranks x 2) at u = 2,
    3, 4: u = 1's bits, trips = ceil(the slowest row's iterations / u);
  * the per-frame artifact of io/aot.py exported at u = 2 holds two
    iterations in its loop body and gives the live u = 2 step's poses and
    iterations bit for bit.
"""

import io
import math

import numpy as np
import pytest
import torch

import torch_gn_count
import torch_multihost_worker as w
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.odometry import KissICP as JaxKissICP
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.io import aot
from kiss_icp_tpu_torch.kernels import nn27
from kiss_icp_tpu_torch.ops import hash_map, registration, se3
from kiss_icp_tpu_torch.parallel.batch import BatchedOdometry

torch.set_num_threads(1)

N_FRAMES = 10
UNROLLS = (2, 3, 4)
# Each rank drives unroll_drive three times (u = 2, 3, 4): ~10 s unloaded,
# several times that beside the other test workers.
RANK_TIMEOUT_S = 120


def _config(cls, unroll, max_iterations=500):
    """tests/test_registration.py:148-159's config."""
    c = cls()
    c.data.max_range = 30.0
    c.data.min_range = 1.0
    c.mapping.voxel_size = 1.0
    c.engine.max_points_per_frame = 4096
    c.engine.frame_capacity = 2048
    c.engine.source_capacity = 512
    c.engine.map_capacity_log2 = 14
    c.engine.use_pallas = False
    c.engine.gn_unroll = unroll
    c.registration.max_num_iterations = max_iterations
    return c


@pytest.fixture(scope="module")
def scans():
    ds = SyntheticDataset(sequence=0, n_scans=N_FRAMES, n_beams=16, n_azimuth=256,
                          max_range=30.0, speed=1.0, accel_frames=3)
    return [ds[i] for i in range(N_FRAMES)]


def _count_plain(calls):
    """Wrappers of the plain K1 and K2 that count their calls into `calls`."""
    real_k1, real_k2 = registration.build_linear_system, nn27._plain

    def k1(*a):
        calls["k1"] += 1
        return real_k1(*a)

    def k2(*a):
        calls["k2"] += 1
        return real_k2(*a)

    return k1, k2


@pytest.fixture(scope="module")
def port():
    """The port's drive at (u, max_iterations), run once for the module:
    poses, and per frame iterations, trips, iterations run and plain K1 / K2
    calls."""
    cache = {}

    def run(scan_list, unroll, max_iterations=500):
        key = (unroll, max_iterations)
        if key not in cache:
            icp = odometry.KissICP(_config(KISSConfig, unroll, max_iterations), device="cpu")
            calls = {"k1": 0, "k2": 0}
            k1, k2 = _count_plain(calls)
            mp = pytest.MonkeyPatch()
            mp.setattr(registration, "build_linear_system", k1)
            mp.setattr(nn27, "_plain", k2)
            out = {k: [] for k in ("iters", "trips", "evals", "k1", "k2")}
            poses = []
            try:
                with torch_gn_count.counting() as rec:
                    for pts, stamps in scan_list:
                        rec.reset()
                        calls.update(k1=0, k2=0)
                        icp.register_frame(pts, stamps)
                        poses.append(icp.last_pose)
                        out["iters"].append(int(icp.last_result.num_iterations))
                        out["trips"].append(rec.total("trips"))
                        out["evals"].append(rec.total("evals"))
                        out["k1"].append(calls["k1"])
                        out["k2"].append(calls["k2"])
            finally:
                mp.undo()
            cache[key] = dict(out, poses=np.stack(poses))
        return cache[key]

    return run


@pytest.mark.parametrize("unroll", UNROLLS)
def test_single_loop_bit_identical_to_unroll_1(port, scans, unroll):
    ref, got = port(scans, 1), port(scans, unroll)
    np.testing.assert_array_equal(got["poses"], ref["poses"])
    assert got["iters"] == ref["iters"]
    assert max(ref["iters"]) > 2 * max(UNROLLS)  # solves long enough to unroll


@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_single_loop_matches_jax(port, scans, unroll):
    got = port(scans, unroll)
    icp = JaxKissICP(_config(JaxConfig, unroll))
    poses, iters = [], []
    for pts, stamps in scans:
        icp.register_frame(pts, stamps)
        poses.append(np.asarray(icp.state.pose))
        iters.append(int(np.asarray(icp.last_result.num_iterations)))
    np.testing.assert_allclose(got["poses"], np.stack(poses), atol=1e-4)
    assert got["iters"] == iters


@pytest.mark.parametrize("unroll", (1,) + UNROLLS)
def test_trips_and_iterations_run(port, scans, unroll):
    """One convergence read a trip of u iterations: trips = ceil(iterations
    / u), u x trips iterations run, one plain K1 and one plain K2 call for
    each, and one more K2 call a frame for the final count (frame 0 meets
    an empty map: no loop, no call)."""
    got = port(scans, unroll)
    assert got["iters"][0] == got["trips"][0] == got["evals"][0] == 0
    assert got["k1"][0] == got["k2"][0] == 0
    for it, trips, evals, k1, k2 in zip(*(got[k][1:] for k in
                                          ("iters", "trips", "evals", "k1", "k2"))):
        assert it > 0 and trips == math.ceil(it / unroll)
        assert evals == trips * unroll
        assert k1 == evals and k2 == evals + 1
    if unroll > 1:
        assert sum(got["trips"]) < sum(port(scans, 1)["trips"])


def test_max_iterations_not_a_multiple_of_unroll(port, scans):
    """max_num_iterations 5 at u = 4: every solve that reaches the cap takes
    two trips and stops at 5 iterations, with u = 1's bits."""
    ref, got = port(scans, 1, 5), port(scans, 4, 5)
    np.testing.assert_array_equal(got["poses"], ref["poses"])
    assert got["iters"] == ref["iters"]
    capped = [i for i, it in enumerate(got["iters"]) if it == 5]
    assert len(capped) >= 5
    for i in capped:
        assert (got["trips"][i], got["evals"][i], got["k1"][i]) == (2, 8, 8)


def test_frozen_iterations_keep_the_state(scans):
    """`gauss_newton_loop` itself at max_iterations 5 and u = 4 (two trips,
    eight iterations): iterations 6-8 query the source exactly as the fifth
    left it, and the result is the u = 1 loop's."""
    cfg = _config(KISSConfig, 1)
    mcfg = odometry.map_config(cfg)
    first = torch.from_numpy(np.asarray(scans[0][0], np.float32))
    m, _ = hash_map.insert(mcfg, hash_map.create_map(mcfg), first,
                           torch.ones(len(first), dtype=torch.bool))
    points = torch.from_numpy(np.asarray(scans[1][0][::8], np.float32))
    valid = torch.ones(len(points), dtype=torch.bool)
    guess = se3.identity()

    def loop(unroll, seen):
        def query_fn(src):
            seen.append(src.clone())
            q = hash_map.query_nearest(mcfg, m, src, valid)
            return q.distances, q.neighbors

        return registration.gauss_newton_loop(
            points, valid, guess, torch.tensor(3.0), torch.tensor(1.0), query_fn=query_fn,
            linsys_fn=registration.build_linear_system, max_iterations=5,
            convergence=1e-4, unroll=unroll)

    ref_seen, seen = [], []
    ref, got = loop(1, ref_seen), loop(4, seen)
    assert int(ref[1]) == int(got[1]) == 5 and torch.equal(ref[0], got[0])
    assert len(ref_seen) == 5 and len(seen) == 8
    for a, b in zip(ref_seen, seen):
        assert torch.equal(a, b)
    # The fifth iteration moves the source; the three after it do not.
    assert not torch.equal(seen[4], seen[5])
    assert torch.equal(seen[5], seen[6]) and torch.equal(seen[5], seen[7])
    torch.testing.assert_close(seen[5], se3.transform(got[0] @ guess, points),
                               atol=1e-5, rtol=0)


# --- The lockstep loop (parallel/batch.py) ----------------------------------


@pytest.fixture(scope="module")
def rows():
    """3 rows of 6 frames: sequences 0, 1 and 2 of the drive's LiDAR (their
    own worlds and speeds), so the rows' iterations differ."""
    out = []
    for seq in range(3):
        ds = SyntheticDataset(sequence=seq, n_scans=6, n_beams=16, n_azimuth=256,
                              max_range=30.0, speed=1.0, accel_frames=3)
        out.append([ds[i] for i in range(6)])
    return out


@pytest.fixture(scope="module")
def lockstep(rows):
    cache = {}

    def run(unroll):
        if unroll not in cache:
            bo = BatchedOdometry(_config(KISSConfig, unroll), 3, device="cpu")
            poses, iters, trips = [], [], []
            with torch_gn_count.counting() as rec:
                for frame in zip(*rows):
                    rec.reset()
                    poses.append(bo.register_frames([p for p, _ in frame],
                                                    [t for _, t in frame]))
                    iters.append(bo.last_result.num_iterations.numpy().copy())
                    trips.append(rec.total("trips"))
            cache[unroll] = np.stack(poses), np.stack(iters), trips
        return cache[unroll]

    return run


@pytest.mark.parametrize("unroll", UNROLLS)
def test_lockstep_rows_bit_identical_to_unroll_1(lockstep, unroll):
    ref_poses, ref_iters, ref_trips = lockstep(1)
    poses, iters, trips = lockstep(unroll)
    np.testing.assert_array_equal(poses, ref_poses)
    np.testing.assert_array_equal(iters, ref_iters)
    assert any(len(set(r.tolist())) > 1 for r in ref_iters[1:]), "rows should differ"
    assert ref_iters.max() > 2 * max(UNROLLS)
    assert ref_trips == [int(r.max()) for r in ref_iters]
    assert trips == [math.ceil(int(r.max()) / unroll) for r in iters]


# --- The map axis (parallel/sharded_map.py) ---------------------------------


@pytest.fixture(scope="module")
def sharded(scans):
    cache = {}

    def run(unroll):
        if unroll not in cache:
            cfg = _config(KISSConfig, unroll)
            cfg.engine.map_shards = 2
            icp = odometry.create_odometry(cfg, device="cpu")
            poses, iters, trips = [], [], []
            with torch_gn_count.counting() as rec:
                for pts, stamps in scans[:6]:
                    rec.reset()
                    icp.register_frame(pts, stamps)
                    poses.append(icp.last_pose)
                    iters.append(int(icp.last_result.num_iterations))
                    trips.append(rec.total("trips"))
            cache[unroll] = np.stack(poses), iters, trips
        return cache[unroll]

    return run


@pytest.mark.parametrize("unroll", UNROLLS)
def test_map_shards_bit_identical_to_unroll_1(sharded, unroll):
    ref_poses, ref_iters, _ = sharded(1)
    poses, iters, trips = sharded(unroll)
    np.testing.assert_array_equal(poses, ref_poses)
    assert iters == ref_iters and max(iters) > 2 * max(UNROLLS)
    assert trips == [math.ceil(it / unroll) for it in iters]


def test_two_ranks_at_unroll_equal_one_process(tmp_path):
    """tests/torch_multihost_worker.py's unrolled drive (4 map shards as 2
    ranks x 2 over tests/test_registration.py's drive) at u = 2, 3, 4 in
    each rank: every u gives the one-process drive's bits at u = 1."""
    got = w.launch("unroll", tmp_path / "unroll.npz", RANK_TIMEOUT_S, unrolls=UNROLLS)
    icp = odometry.create_odometry(w.unroll_config(1), device="cpu")
    assert icp.mesh.axis("map").ranks == 1
    poses, iters = w.unroll_drive(icp)
    assert max(iters) > max(UNROLLS)
    for u in UNROLLS:
        np.testing.assert_array_equal(got[f"poses_u{u}"], poses, err_msg=f"u={u}")
        np.testing.assert_array_equal(got[f"iters_u{u}"], iters, err_msg=f"u={u}")


# --- The exported step (io/aot.py) ------------------------------------------


def test_exported_step_at_unroll_2_equals_live(scans, tmp_path):
    """The per-frame artifact at u = 2 over 4 frames of the drive: the
    program holds the loop body's two iterations (two K1 calls) and gives
    the live u = 2 step's poses and iterations bit for bit."""
    cfg = _config(KISSConfig, 2)
    cfg.engine.donate_state = False
    aot.save_step(tmp_path / "step.npz", cfg, device="cpu")
    step, _ = aot.load_step(tmp_path / "step.npz")
    with np.load(tmp_path / "step.npz") as d:
        program = torch.export.load(io.BytesIO(d["exported"].tobytes()))
    linsys = torch.ops.kiss_icp_torch.linsys.default
    assert sum(n.target is linsys for g in program.graph_module.modules()
               if isinstance(g, torch.fx.GraphModule) for n in g.graph.nodes) == 2
    live = odometry.make_step(cfg)
    cap = cfg.engine.max_points_per_frame
    state = lstate = odometry.init_state(cfg, device="cpu")
    iters = []
    for pts, stamps in scans[:4]:
        n = len(pts)
        arrays = (np.zeros((cap, 3), np.float32), np.zeros(cap, np.float32),
                  np.arange(cap) < n)
        arrays[0][:n], arrays[1][:n] = pts[:, :3], stamps
        state, res = step(state, *(torch.from_numpy(a) for a in arrays))
        lstate, lres = live(lstate, *(torch.from_numpy(a) for a in arrays))
        assert torch.equal(res.pose, lres.pose)
        iters.append(int(res.num_iterations))
        assert iters[-1] == int(lres.num_iterations)
    assert max(iters) > 2
