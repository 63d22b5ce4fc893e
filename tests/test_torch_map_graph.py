"""The map update (ops/hash_map.py `update`), direct or as one CUDA graph
(ops/control.py `graph_call`), on the CPU.

A frame's map update (the frame cloud to the world, insert, trim) writes
the map's tables in place and reads nothing back, on every path. On the
card, where a step owns the tables, it is the replay of one CUDA graph,
which the card tests of tests/test_torch_cuda.py hold to the direct update
bit for bit. Here, without a card:

  * the claim rounds (`probe_length` of them, no test) give JAX's
    `assigned`, `fprints` and `vkeys` (`kiss_icp_tpu.ops.hash_map.
    _claim_slots`, which rounds until none is pending), on random tables
    with full windows, shadowing and fingerprint collisions;
  * the fixed-shape write-back (`_write_rows`) leaves the table as the
    write of the rows with a slot does, slot 0 included, and `insert`
    equals JAX's `insert`, f32 and u16, in `m`'s own tables;
  * the graph's key is a pure function of the map's configuration, the
    shapes and the tables' addresses;
  * CPU tensors, `torch.export`, a step that does not donate, `rebase` and
    `map_shards` > 1 capture no map graph, and their update reads nothing;
  * with each capture and replay emulated in Python
    (tests/torch_graph_emulation.py), a single drive, a u16 drive with the
    ground fit, a chunked drive and three lockstep rows give the direct
    drive's poses and maps bit for bit, capture once for each set of map
    tables, replay every other update inside `kiss/map_insert` and read
    nothing back in the map;
  * the benchmark's reader `map_replay_pct` on a hand-made trace.
"""

import collections
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_graph_emulation
from kiss_icp_tpu.ops import hash_map as jhm
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.io import aot
from kiss_icp_tpu_torch.ops import control
from kiss_icp_tpu_torch.ops import hash_map as hm
from kiss_icp_tpu_torch.parallel import batch as pbatch
from odobench.harness import Layout
from odobench.trace import Trace

torch.set_num_threads(1)

CELLS = ("ouster64-10hz.offline", "hdl64e-kitti.offline", "hdl64e-kitti.batch11",
         "ouster64-u16-soak.offline")
FRAMES = 6


def _config(storage="f32", ground=0.0, trigger=0):
    c = KISSConfig()
    c.data.max_range = 30.0
    c.data.min_range = 1.0
    c.mapping.voxel_size = 1.0
    c.engine.max_points_per_frame = 2048
    c.engine.frame_capacity = 1024
    c.engine.source_capacity = 256
    c.engine.map_capacity_log2 = 13
    c.engine.map_storage = storage
    c.engine.ground_align = ground
    c.engine.rebase_trigger_voxels = trigger
    return c


@pytest.fixture(scope="module")
def scans():
    ds = SyntheticDataset(sequence=0, n_scans=FRAMES + 1, n_beams=16, n_azimuth=128,
                          max_range=30.0, speed=1.0, accel_frames=3)
    return [ds[i] for i in range(FRAMES + 1)]


def _same_map(a, b):
    for name, x, y in zip(hm.VoxelMap._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _np(t):
    """A tensor's values as numpy (u16 through its int16 bits)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# --- the claim rounds against JAX's ------------------------------------------


def _claim_case(rng, k):
    """Random tables of 2^5-2^8 slots, part filled (some windows full), a
    batch of distinct new voxels aimed at a few windows, and fingerprints
    drawn from a handful of values: collisions and shadowing are common."""
    cap = 1 << int(rng.integers(max(5, k.bit_length() - 1), 9))
    windows = cap // k
    fill = rng.random(cap) < rng.uniform(0.0, 1.0)
    fprints = np.where(fill, rng.integers(1, 6, cap), 0).astype(np.int32)
    vkeys = np.where(fill[:, None], rng.integers(-4, 4, (cap, 3)), 0).astype(np.int32)
    grid = np.stack(np.meshgrid(*[np.arange(-4, 4)] * 3, indexing="ij"), -1).reshape(-1, 3)
    v = int(rng.integers(1, min(len(grid), 4 * k + 8)))
    coords = grid[rng.permutation(len(grid))[:v]].astype(np.int32)
    fp = rng.integers(1, 6, v).astype(np.int32)
    rows = rng.integers(0, min(windows, int(rng.integers(1, 5))), v)
    pending = rng.random(v) < 0.85
    t = torch.from_numpy
    return (t(fprints), t(vkeys), t(coords), t(fp), t(rows).to(torch.int64), t(pending)), cap


_jax_claim_slots = jax.jit(jhm._claim_slots, static_argnames=("probe_length", "capacity"))


def _jax_claim(args, k, cap):
    """JAX's claim of a case, with its new voxels padded to 4k + 8 rows by
    rows that are not pending (they never claim, and the rows before them
    win as they would alone), so that JAX compiles once a table size.
    Returns JAX's (fprints, vkeys, assigned) of the case's rows."""
    fprints, vkeys, coords, fp, rows, pending = (a.numpy() for a in args)
    v, pad = coords.shape[0], 4 * k + 8 - coords.shape[0]
    fp_, vk_, assigned = _jax_claim_slots(
        jnp.asarray(fprints), jnp.asarray(vkeys),
        jnp.asarray(np.pad(coords, ((0, pad), (0, 0)))), jnp.asarray(np.pad(fp, (0, pad))),
        jnp.asarray(np.pad(rows, (0, pad)).astype(np.int32)),
        jnp.asarray(np.pad(pending, (0, pad))), probe_length=k, capacity=cap)
    return fp_, vk_, np.asarray(assigned)[:v]


@pytest.mark.parametrize("k", [2, 4, 8, 16])
def test_bounded_claim_rounds_equal_the_loop(k):
    """75 random cases a probe length: the port's `probe_length` rounds give
    the `assigned`, `fprints` and `vkeys` of JAX's loop, which runs until
    no row is pending; some cases drop rows and some fill two or more slots
    of one window (two rounds or more)."""
    rng = np.random.default_rng(k)
    drops, most = 0, 0
    for _ in range(75):
        args, cap = _claim_case(rng, k)
        assigned, fprints, vkeys = hm._claim_slots(*args, probe_length=k, capacity=cap)
        want_fp, want_vk, want_assigned = _jax_claim(args, k, cap)
        np.testing.assert_array_equal(assigned.numpy(), np.asarray(want_assigned))
        np.testing.assert_array_equal(fprints.numpy(), np.asarray(want_fp))
        np.testing.assert_array_equal(vkeys.numpy(), np.asarray(want_vk))
        drops += int(((assigned < 0) & args[5]).sum())
        won = assigned[assigned >= 0] // k
        most = max(most, int(torch.bincount(won).max()) if won.numel() else 0)
    assert drops > 0 and most >= 2


# --- the fixed-shape write-back ----------------------------------------------


@pytest.mark.parametrize("case", ["slot0_written", "slot0_kept", "none", "all"])
def test_write_rows_equals_the_listed_write(case):
    """`_write_rows` over all the rows against the write through the list
    of rows with a slot (`torch.nonzero`), on (C,) and (C, P, 3) tables."""
    rng = np.random.default_rng(7)
    c, v = 64, 40
    slots = torch.from_numpy(1 + rng.permutation(c - 1)[:v]).to(torch.int64)
    has = torch.from_numpy(rng.random(v) < 0.6)
    if case in ("slot0_written", "all"):
        slots[3], has[3] = 0, True
    has[:] = {"none": False, "all": True}.get(case, has)
    assert (int(has.sum()) > 0) == (case != "none")
    assert bool(((slots == 0) & has).any()) == (case in ("slot0_written", "all"))
    for shape, dtype in (((c,), torch.int32), ((c, 4, 3), torch.int16)):
        table = torch.from_numpy(rng.integers(-999, 999, shape)).to(dtype)
        rows = torch.from_numpy(rng.integers(-999, 999, (v,) + shape[1:])).to(dtype)
        want = table.clone()
        sel = torch.nonzero(has).squeeze(1)
        want.index_put_((slots[sel],), rows[sel])
        got = table.clone()
        hm._write_rows(got, torch.where(has, slots, torch.zeros_like(slots)), rows, has)
        assert torch.equal(got, want)


def _insert_case(storage, capacity_log2, probe_length, seed):
    cfg = hm.MapConfig(voxel_size=1.0, max_distance=12.0, max_points_per_voxel=6,
                       capacity_log2=capacity_log2, probe_length=probe_length,
                       group_capacity=8, storage=storage)
    rng = np.random.default_rng(seed)
    m = hm.create_map(cfg)
    for spread in (6.0, 10.0):
        pts = torch.from_numpy(rng.uniform(-spread, spread, (1500, 3)).astype(np.float32))
        m, _ = hm.insert(cfg, m, pts, torch.from_numpy(rng.random(1500) < 0.9))
    pts = torch.from_numpy(rng.uniform(-14.0, 14.0, (2000, 3)).astype(np.float32))
    return cfg, m, pts, torch.from_numpy(rng.random(2000) < 0.9)


@pytest.mark.parametrize("storage", ["f32", "u16"])
@pytest.mark.parametrize("capacity_log2,probe_length", [(13, 16), (7, 4)])
def test_fixed_insert_equals_the_live_insert(storage, capacity_log2, probe_length):
    """`insert` against JAX's `insert` on a part-filled map (2^7 slots and
    windows of 4: full windows and dropped voxels): every table, counter
    and statistic bit for bit, written into the tables of the map given."""
    cfg, m, pts, valid = _insert_case(storage, capacity_log2, probe_length, capacity_log2)
    jm = jhm.VoxelMap(*(jnp.asarray(_np(t)) for t in m))
    want, want_stats = jhm.insert(jhm.MapConfig(**cfg.__dict__), jm, jnp.asarray(pts.numpy()),
                                  jnp.asarray(valid.numpy()))
    got, stats = hm.insert(cfg, m, pts, valid)
    for name, a, b in zip(hm.VoxelMap._fields, got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
    for a, b in zip(stats, want_stats):
        assert int(a) == int(b)
    for name in ("vkeys", "fprints", "counts", "points"):
        assert getattr(got, name) is getattr(m, name), name
    assert int(stats.num_added_points) > 0
    if capacity_log2 == 7:
        assert int(stats.num_dropped_voxels) > 0


# --- the key -----------------------------------------------------------------


def _graph_calls(monkeypatch):
    """The key of every `control.graph_call`."""
    keys = []
    real = control.graph_call

    def spy(fn, name, *, inputs, tables, graph_key, keep=1):
        keys.append(control.capture_key(name, graph_key, (), inputs, tables))
        return real(fn, name, inputs=inputs, tables=tables, graph_key=graph_key, keep=keep)

    monkeypatch.setattr(control, "graph_call", spy)
    return keys


def test_key_is_the_statics_and_the_tables_addresses(monkeypatch):
    """Two updates of one map: one key, one capture, one replay. A moved
    table, another configuration or another frame size: another key."""
    cfg, m, pts, valid = _insert_case("f32", 13, 16, 1)
    events = torch_graph_emulation.emulate(monkeypatch)
    keys = _graph_calls(monkeypatch)
    pose = torch.eye(4)
    m, _ = hm.update(cfg, m, pose, pts, valid)
    m, _ = hm.update(cfg, m, pose, pts + 0.25, valid)
    assert keys[0] == keys[1] and hash(keys[0]) == hash(keys[1])
    assert events == {"CallGraph.capture": 1, "CallGraph.replay": 1}
    for other in (m._replace(counts=m.counts.clone()), m._replace(points=m.points.clone()),
                  m._replace(vkeys=m.vkeys.clone()), m._replace(fprints=m.fprints.clone())):
        hm.update(cfg, other, pose, pts, valid)
        assert keys[-1] != keys[0]
    hm.update(hm.MapConfig(**{**cfg.__dict__, "max_distance": 13.0}), m, pose, pts, valid)
    hm.update(cfg, m, pose, pts[:1000], valid[:1000])
    assert len(set(keys)) == len(keys) - 1
    assert events["CallGraph.capture"] == 7
    control.clear_graphs()


def test_graph_cache_keeps_every_row_and_the_loops(monkeypatch):
    """The map's graphs and the GN loop's have caches of their own, and a
    caller's `keep` (its rows) holds more than `MAX_GRAPHS` graphs."""
    monkeypatch.setattr(control, "MAX_GRAPHS", 2)
    control.clear_graphs()
    loop = control.TripGraph((torch.zeros(1),), ())
    control._keep("gn", "gn", loop)
    graphs = [control.CallGraph(()) for _ in range(5)]
    for i, g in enumerate(graphs):
        control._keep("map", i, g, keep=4)
    assert control._kept("gn", "gn") is loop
    assert control._kept("map", 0) is None
    assert [control._kept("map", i) for i in range(1, 5)] == graphs[1:]
    control._keep("map", 5, control.CallGraph(()))
    assert control._kept("map", 1) is None and control._kept("gn", "gn") is loop
    control.clear_graphs()
    assert control._kept("gn", "gn") is None


# --- where the update runs directly ------------------------------------------


def _refuse_graph_call(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the map update took the graph path")

    monkeypatch.setattr(control, "graph_call", refuse)


def _update_reads(events):
    """The host reads (`kiss/sync/*`) made inside a map update's spans."""
    def in_update(e):
        while e is not None:
            if e.name in ("kiss/map_insert", "kiss/map_trim"):
                return True
            e = e.cpu_parent
        return False

    return [e.name for e in events if e.name.startswith("kiss/sync/") and in_update(e)]


def test_cpu_keeps_the_live_update(scans, monkeypatch):
    """Without emulation a CPU drive captures no map graph: each frame's
    update is `kiss/map_insert`, then `kiss/map_trim` beside it (not inside
    it: `map_ms` sums both), and reads nothing back."""
    _refuse_graph_call(monkeypatch)
    icp = odometry.KissICP(_config(), device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for f, t in scans[:3]:
            icp.register_frame(f, t)
    events = [e for e in prof.events() if e.name.startswith("kiss/")]
    names = collections.Counter(e.name for e in events)
    assert names["kiss/map_insert"] == names["kiss/map_trim"] == 3
    assert {e.cpu_parent.name for e in events
            if e.name in ("kiss/map_insert", "kiss/map_trim")} == {"kiss/frame"}
    assert not _update_reads(events) and names["kiss/map_replay"] == 0
    assert {n for n in names if n.startswith("kiss/sync/map_")} == {"kiss/sync/map_empty"}


def test_export_keeps_the_claim_loop(monkeypatch):
    """With graphs emulated for every key, a donating step exported by
    io/aot.py captures nothing; it holds the GN while_loop and no other
    (the claim rounds are `probe_length` plain rounds)."""
    c = _config()
    c.engine.max_points_per_frame = 512
    c.engine.frame_capacity = 512
    c.engine.source_capacity = 128
    c.registration.max_num_iterations = 5
    events = torch_graph_emulation.emulate(monkeypatch)
    _refuse_graph_call(monkeypatch)
    import io
    ep = torch.export.load(io.BytesIO(aot.export_step(c, device="cpu")))
    loops = [node for gm in ep.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
             for node in gm.graph.nodes
             if node.op == "call_function" and "while_loop" in str(node.target)]
    assert len(loops) == 1
    assert not events


@pytest.mark.parametrize("path", ["step", "chunk", "batched_chunk"])
def test_non_donating_steps_keep_the_live_update(scans, monkeypatch, path):
    """`donate_state` false, with graphs emulated: the step leaves the
    caller's state as it was and updates its copy directly, capturing no
    map graph, as the per-frame step, the chunk and the batched chunk."""
    c = _config()
    c.engine.donate_state = False
    events = torch_graph_emulation.emulate(monkeypatch)
    _refuse_graph_call(monkeypatch)
    pts = torch.from_numpy(np.asarray(scans[0][0][:2048], np.float32))
    n = pts.shape[0]
    ts, valid = torch.zeros(n), torch.ones(n, dtype=torch.bool)
    state = odometry.init_state(c, device="cpu")
    if path == "batched_chunk":
        state = pbatch.init_batched_state(c, 2, "cpu")
    before = [t.clone() for t in torch.utils._pytree.tree_leaves(state)]
    if path == "step":
        new, _ = odometry.register_frame(c, state, pts, ts, valid)
    elif path == "chunk":
        new, _ = odometry.make_chunked_step(c)(state, pts[None], ts[None], valid[None])
    else:
        new, _ = pbatch.make_batched_chunked_step(c)(
            state, pts.expand(1, 2, n, 3), ts.expand(1, 2, n), valid.expand(1, 2, n))
    for a, b in zip(torch.utils._pytree.tree_leaves(state), before):
        assert torch.equal(a, b)
    assert int(new.map.total_points.sum()) > 0
    assert not [e for e in events if e.startswith("CallGraph")]


def test_rebase_and_map_shards_keep_the_live_path(scans, monkeypatch):
    """With graphs emulated: a re-base rebuilds the map into new tables, so
    the next update captures anew; the drive gives the direct drive's poses
    and map. The map-sharded engine captures no map graph, and its frames'
    updates read nothing back."""
    def drive():
        icp = odometry.KissICP(_config(), device="cpu")
        poses = []
        for i, (f, t) in enumerate(scans):
            if i == 3:
                icp._apply_rebase(np.array([2, -1, 0], np.int32))
            icp.register_frame(f, t)
            poses.append(icp.last_pose)
        return poses, icp.state.map

    live_poses, live_map = drive()
    with monkeypatch.context() as mp:
        events = torch_graph_emulation.emulate(mp)
        poses, m = drive()
    np.testing.assert_array_equal(np.asarray(poses), np.asarray(live_poses))
    _same_map(m, live_map)
    assert events["CallGraph.capture"] == 2
    assert events["CallGraph.replay"] == len(scans) - 2

    c = _config()
    c.engine.map_shards = 2
    with monkeypatch.context() as mp:
        events = torch_graph_emulation.emulate(mp)
        _refuse_graph_call(mp)
        icp = odometry.create_odometry(c, device="cpu")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for f, t in scans[:3]:
                icp.register_frame(f, t)
    control.clear_graphs()
    assert not [e for e in events if e.startswith("CallGraph")]
    assert not {e.name for e in prof.events() if e.name.startswith("kiss/sync/map_")} \
        - {"kiss/sync/map_empty"}
    assert int(icp.state.total_points.sum()) > 0


# --- emulated drives against the direct ones ---------------------------------


def _single(config):
    def drive(scans):
        icp = odometry.KissICP(config, device="cpu")
        poses = []
        for f, t in scans:
            icp.register_frame(f, t)
            poses.append(icp.last_pose)
        return poses, [icp.state.map], len(scans)
    return drive


def _chunked(scans):
    icp = odometry.KissICP(_config(), device="cpu")
    poses = []
    for a in range(0, len(scans), 3):
        part = scans[a:a + 3]
        poses.extend(icp.register_frames_chunked([s[0] for s in part], [s[1] for s in part]))
    return poses, [icp.state.map], len(scans)


def _lockstep(scans):
    rows = 3
    odo = pbatch.BatchedOdometry(_config(), rows, device="cpu")
    poses = []
    for i in range(len(scans) - rows + 1):
        poses.append(odo.register_frames([s[0] for s in scans[i:i + rows]],
                                         [s[1] for s in scans[i:i + rows]]))
    return poses, [odometry.state_row(odo.state, b).map for b in range(rows)], len(poses) * rows


DRIVES = {"f32": (_single(_config()), 1), "u16_ground": (_single(_config("u16", 0.1)), 1),
          "chunked": (_chunked, 1), "lockstep3": (_lockstep, 3)}


@pytest.mark.parametrize("path", sorted(DRIVES))
def test_emulated_map_graphs_give_the_live_drive(scans, monkeypatch, path):
    """Poses and every map table and counter bit-equal to the same drive
    with the direct update (no emulation); one capture for each set of
    tables, a replay for every other update, each inside `kiss/map_insert`;
    no map read and no `kiss/map_trim`."""
    drive, tables = DRIVES[path]
    live_poses, live_maps, updates = drive(scans)
    with monkeypatch.context() as mp:
        events = torch_graph_emulation.emulate(mp)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            poses, maps, _ = drive(scans)
    control.clear_graphs()
    np.testing.assert_array_equal(np.asarray(poses), np.asarray(live_poses))
    for m, live in zip(maps, live_maps):
        _same_map(m, live)
        assert int(m.total_points) > 0
    if path == "u16_ground":
        assert maps[0].points.dtype == torch.uint16
    spans = [e for e in prof.events() if e.name.startswith("kiss/map")
             or e.name.startswith("kiss/sync/map_")]
    names = collections.Counter(e.name for e in spans)
    assert names["kiss/map_insert"] == updates
    assert events["CallGraph.capture"] == names["kiss/map_capture"] == tables
    assert events["CallGraph.replay"] == names["kiss/map_replay"] == updates - tables
    assert {e.cpu_parent.name for e in spans if e.name in ("kiss/map_capture",
                                                           "kiss/map_replay")} \
        == {"kiss/map_insert"}
    # The one map read left is the registration's empty-map test.
    assert {n for n in names if n.startswith("kiss/sync/map_")} <= {"kiss/sync/map_empty"}
    assert names["kiss/map_trim"] == 0 and names["kiss/map_claim_trip"] == 0


# --- the benchmark's reader --------------------------------------------------


def test_map_replay_pct_reader_on_hand_made_trace():
    layout = Layout()
    for cell in CELLS:
        assert "map_replay_pct.offline" in {m["name"] for m in layout.metrics("per_layer", cell)}
    read = layout.reader("map_replay_pct.offline").read
    spans = [("odobench/dispatch_chunk", 0.0, 1000.0), ("kiss/map_insert", 10.0, 90.0),
             ("kiss/map_capture", 11.0, 89.0)]
    for i in range(1, 4):
        spans += [("kiss/map_insert", 100.0 * i, 100.0 * i + 20.0),
                  ("kiss/map_replay", 100.0 * i + 1.0, 100.0 * i + 19.0)]

    def ctx(spans):
        return SimpleNamespace(metric="map_replay_pct.offline", trace=Trace(spans=spans),
                               traced=[0, 1], iterations=[3, 3])

    assert read(ctx(spans)) == pytest.approx(75.0)
    # A program without the replay span (an older commit): no reading.
    assert read(ctx([s for s in spans if s[0] not in ("kiss/map_replay", "kiss/map_capture")])) \
        is None
    assert read(ctx([])) is None
