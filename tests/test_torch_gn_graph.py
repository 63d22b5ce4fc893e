"""The Gauss-Newton loop on CUDA graphs (ops/control.py), on the CPU.

On the card each GN loop trip is the replay of one CUDA graph, which the
card tests of tests/test_torch_cuda.py hold to the Python loop bit for bit.
Here, without a card:

  * the capture key is a pure function of the loop's name, its constants,
    its tensors' layouts and its tables' addresses: a moved `counts` or
    `points`, or another `gn_unroll`, gives a new key;
  * the Python loop runs wherever a graph cannot: CPU tensors, a step under
    `torch.export` (which keeps `torch.while_loop`, even where a graph
    would run), `nn_mode` "cached" (a host read inside its body) and a loop
    whose trips are shared with other processes (`any_active_fn`);
  * `outside_graph`, the call a captured trip leaves out (the lockstep
    loop's batched solve, which MAGMA runs), is the call itself elsewhere;
  * the graph path's bookkeeping, with each replay emulated by the trip
    run again in Python on the graph's own buffers: a single drive, the
    lockstep rows and the map shards give the Python loop's poses and
    iterations, capture once for each set of map tables and replay the
    other trips, and record `kiss/gn_capture` and `kiss/gn_replay` inside
    `kiss/gn_trip`, and tests/torch_gn_count.py counts their trips and
    iterations as it counts the Python loop's;
  * the benchmark's reader `gn_replay_pct` on a hand-made trace.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_gn_count
import torch_graph_emulation
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.ops import control, hash_map, registration, se3
from kiss_icp_tpu_torch.parallel.batch import BatchedOdometry
from odobench.harness import Layout
from odobench.trace import Trace

torch.set_num_threads(1)

CELLS = ("ouster64-10hz.offline", "hdl64e-kitti.offline", "hdl64e-kitti.batch11")


def _config(unroll=1, nn_mode="gather27", shards=1):
    c = KISSConfig()
    c.data.max_range = 30.0
    c.data.min_range = 1.0
    c.mapping.voxel_size = 1.0
    c.engine.max_points_per_frame = 2048
    c.engine.frame_capacity = 1024
    c.engine.source_capacity = 256
    c.engine.map_capacity_log2 = 13
    c.engine.gn_unroll = unroll
    c.engine.nn_mode = nn_mode
    c.engine.map_shards = shards
    return c


@pytest.fixture(scope="module")
def scans():
    ds = SyntheticDataset(sequence=0, n_scans=5, n_beams=16, n_azimuth=128,
                          max_range=30.0, speed=1.0, accel_frames=3)
    return [ds[i] for i in range(5)]


def _align_inputs(scans):
    mcfg = odometry.map_config(_config())
    first = torch.from_numpy(np.asarray(scans[0][0], np.float32))
    m, _ = hash_map.insert(mcfg, hash_map.create_map(mcfg), first,
                           torch.ones(len(first), dtype=torch.bool))
    points = torch.from_numpy(np.asarray(scans[1][0][::8], np.float32))
    return mcfg, m, points, torch.ones(len(points), dtype=torch.bool), se3.identity()


def _loop_calls(monkeypatch):
    """The keyword arguments of every `control.while_loop` call."""
    calls = []
    real = control.while_loop

    def spy(cond_fn, body_fn, carry, name, **kw):
        calls.append(dict(kw, name=name))
        return real(cond_fn, body_fn, carry, name, **kw)

    monkeypatch.setattr(control, "while_loop", spy)
    return calls


def _emulated_graphs(monkeypatch):
    """Graphs wherever a loop gives a key (as on the card), each capture and
    replay run in Python on the TripGraph's buffers; returns the count of
    captures and replays. The map update's graph is emulated too
    (tests/torch_graph_emulation.py), uncounted here."""
    events = {"capture": 0, "replay": 0}

    def capture(self, cond_fn, body_fn, tables):
        def trip():
            out = body_fn(*self.carry, *self.inputs, *tables)
            for dst, src in zip(self.carry, out):
                dst.copy_(src)
            self.test.copy_(cond_fn(*self.carry))

        events["capture"] += 1
        trip()

        def replay():
            events["replay"] += 1
            trip()

        self.parts, self.launched = [SimpleNamespace(replay=replay)], ()

    torch_graph_emulation.emulate(monkeypatch)
    monkeypatch.setattr(control.TripGraph, "capture", capture)
    return events


def test_capture_key_pure_function():
    carry = (torch.zeros(6, 3), torch.eye(4), torch.zeros((), dtype=torch.int32),
             torch.zeros((), dtype=torch.bool))
    inputs = (torch.ones(6, dtype=torch.bool), torch.zeros(3))
    counts, points = torch.zeros(16, dtype=torch.int32), torch.zeros(16, 4, 3)
    statics = ("single", "map", 500, 1e-4, 1)

    def key(statics=statics, carry=carry, inputs=inputs, tables=(counts, points)):
        return control.capture_key("gn", statics, carry, inputs, tables)

    assert key() == key() and hash(key()) == hash(key())
    # Other values at the same layouts: the same graph.
    assert key(carry=tuple(t.clone() for t in carry),
               inputs=tuple(t.clone() for t in inputs)) == key()
    # A moved table, another constant, another shape: another graph.
    assert key(tables=(counts.clone(), points)) != key()
    assert key(tables=(counts, points.clone())) != key()
    assert key(statics=("single", "map", 500, 1e-4, 2)) != key()
    assert key(inputs=(torch.ones(7, dtype=torch.bool), torch.zeros(3))) != key()


def test_unroll_and_tables_key_the_loop(scans, monkeypatch):
    """The keys the single loop gives: equal for equal calls, new for
    another `unroll` or for a map whose `counts` or `points` moved."""
    mcfg, m, points, valid, guess = _align_inputs(scans)
    calls = _loop_calls(monkeypatch)

    def align(m, unroll):
        registration.align_points_to_map(mcfg, m, points, valid, guess, torch.tensor(3.0),
                                         torch.tensor(1.0), max_iterations=60,
                                         convergence=1e-4, gn_unroll=unroll)
        loop = [c for c in calls if c["name"] == "gn"][-1]
        return control.capture_key("gn", loop["graph_key"], (), (), loop["tables"])

    first = align(m, 1)
    assert first == align(m, 1)
    assert align(m, 2) != first
    assert align(m._replace(counts=m.counts.clone()), 1) != first
    assert align(m._replace(points=m.points.clone()), 1) != first
    assert align(m._replace(vkeys=m.vkeys.clone(), fprints=m.fprints.clone()), 1) == first


def test_cpu_tensors_take_the_python_loop(scans, monkeypatch):
    """A key is given, and the CPU loop runs without a graph."""
    mcfg, m, points, valid, guess = _align_inputs(scans)
    calls = _loop_calls(monkeypatch)

    def refuse(*args):
        raise AssertionError("a CPU loop took the graph path")

    monkeypatch.setattr(control, "_graph_while_loop", refuse)
    res = registration.align_points_to_map(mcfg, m, points, valid, guess, torch.tensor(3.0),
                                           torch.tensor(1.0), max_iterations=60,
                                           convergence=1e-4)
    gn = [c for c in calls if c["name"] == "gn"]
    assert len(gn) == 1 and gn[0]["graph_key"] is not None and int(res.num_iterations) > 1
    assert not control.uses_graph((points,), gn[0]["graph_key"])


def test_export_keeps_while_loop_where_a_graph_would_run(scans, monkeypatch):
    """With graphs on for every keyed loop, as on the card, the exported
    registration still holds `torch.while_loop` and captures nothing; the
    live call does take the graph."""
    mcfg, m, points, valid, guess = _align_inputs(scans)
    events = _emulated_graphs(monkeypatch)

    class Align(torch.nn.Module):
        def forward(self, m, points, valid, guess):
            return tuple(registration.align_points_to_map(
                mcfg, m, points, valid, guess, torch.tensor(3.0), torch.tensor(1.0),
                max_iterations=60, convergence=1e-4))

    ep = torch.export.export(Align(), (m, points, valid, guess))
    targets = {str(node.target) for gm in ep.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule) for node in gm.graph.nodes
               if node.op == "call_function"}
    assert any("while_loop" in t for t in targets)
    assert events == {"capture": 0, "replay": 0}
    want = Align()(m, points, valid, guess)
    assert events["capture"] == 1 and events["replay"] > 0
    got = ep.module()(m, points, valid, guess)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert events["capture"] == 1


def test_cached_mode_and_shared_trips_take_the_python_loop(scans, monkeypatch):
    """`nn_mode` "cached" (its body reads the refresh test on the host) and
    a loop whose trips other processes share (`any_active_fn`) give no key,
    so they run the Python loop even where graphs run."""
    mcfg, m, points, valid, guess = _align_inputs(scans)
    events = _emulated_graphs(monkeypatch)
    calls = _loop_calls(monkeypatch)
    args = (mcfg, m, points, valid, guess, torch.tensor(3.0), torch.tensor(1.0))
    res = registration.align_points_to_map(*args, max_iterations=60, convergence=1e-4,
                                           nn_mode="cached")
    assert int(res.num_iterations) > 1
    assert events == {"capture": 0, "replay": 0}

    def query_fn(src):
        q = hash_map.query_nearest(mcfg, m, src, valid)
        return q.distances, q.neighbors

    kw = dict(query_fn=query_fn, linsys_fn=registration.build_linear_system,
              max_iterations=60, convergence=1e-4, graph_key="a map")
    shared = registration.gauss_newton_loop(points, valid, guess, torch.tensor(3.0),
                                            torch.tensor(1.0), any_active_fn=lambda r: r, **kw)
    assert events == {"capture": 0, "replay": 0}
    assert all(c.get("graph_key") is None for c in calls if c["name"] == "gn")
    alone = registration.gauss_newton_loop(points, valid, guess, torch.tensor(3.0),
                                           torch.tensor(1.0), **kw)
    assert events["capture"] == 1 and events["replay"] == int(alone[1]) - 1
    assert torch.equal(shared[0], alone[0]) and torch.equal(shared[1], alone[1])


def test_outside_graph_is_the_call_unless_a_trip_is_captured(monkeypatch):
    """`control.outside_graph(fn, *args)` is `fn(*args)`; while this thread
    captures a trip, the capture splits around it (`TripGraph.split`)."""
    a, b = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
    assert torch.equal(control.outside_graph(torch.add, a, b), a + b)
    splits = []

    class Capturing:
        def split(self, fn, args):
            splits.append((fn, args))
            return "held"

    monkeypatch.setattr(control._capturing, "graph", Capturing(), raising=False)
    assert control.outside_graph(torch.add, a, b) == "held"
    assert splits == [(torch.add, (a, b))]


def _drive(make, scans):
    odo = make()
    poses, iters = [], []
    for f, t in scans:
        odo.register_frame(f, t)
        poses.append(odo.last_pose)
        iters.append(int(odo.last_result.num_iterations))
    return poses, iters


def _batch_drive(scans):
    odo = BatchedOdometry(_config(), 2, device="cpu")
    poses, iters = [], []
    for i in range(len(scans) - 1):
        poses.append(odo.register_frames([scans[i][0], scans[i + 1][0]],
                                         [scans[i][1], scans[i + 1][1]]))
        iters.append(odo.last_result.num_iterations.tolist())
    return poses, iters


@pytest.mark.parametrize("path", ["single", "unroll2", "lockstep", "shards"])
def test_emulated_graphs_give_the_python_loop(scans, monkeypatch, path):
    """Each path on emulated graphs against the Python loop: equal poses
    and iterations, one capture (one state, tables in place) and a replay
    for every other trip."""
    drive = {
        "single": lambda: _drive(lambda: odometry.KissICP(_config(), device="cpu"), scans),
        "unroll2": lambda: _drive(lambda: odometry.KissICP(_config(2), device="cpu"), scans),
        "lockstep": lambda: _batch_drive(scans),
        "shards": lambda: _drive(lambda: odometry.create_odometry(_config(shards=2),
                                                                  device="cpu"), scans),
    }[path]
    with torch_gn_count.counting() as ref_rec:
        ref_poses, ref_iters = drive()
    with monkeypatch.context() as mp:
        events = _emulated_graphs(mp)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
                torch_gn_count.counting() as rec:
            poses, iters = drive()
    control.clear_graphs()
    assert iters == ref_iters
    for key in ("trips", "evals"):
        assert rec.total(key) == ref_rec.total(key) > 0
    for a, b in zip(poses, ref_poses):
        np.testing.assert_array_equal(a, b)
    spans = [e for e in prof.events() if e.name.startswith("kiss/gn_")]
    names = [e.name for e in spans]
    trips = names.count("kiss/gn_trip")
    assert events["capture"] == 1 and events["replay"] == trips - 1 > 0
    assert names.count("kiss/gn_capture") == 1 and names.count("kiss/gn_replay") == trips - 1
    assert {e.cpu_parent.name for e in spans if e.name != "kiss/gn_trip"} == {"kiss/gn_trip"}


def test_gn_replay_pct_reader_on_hand_made_trace():
    layout = Layout()
    for cell in CELLS:
        assert "gn_replay_pct.offline" in {m["name"] for m in layout.metrics("per_layer", cell)}
    read = layout.reader("gn_replay_pct.offline").read
    spans = [("odobench/dispatch_chunk", 0.0, 1000.0), ("kiss/gn_trip", 10.0, 90.0),
             ("kiss/gn_capture", 11.0, 89.0)]
    for i in range(1, 4):
        spans += [("kiss/gn_trip", 100.0 * i, 100.0 * i + 20.0),
                  ("kiss/gn_replay", 100.0 * i + 1.0, 100.0 * i + 19.0)]

    def ctx(spans):
        return SimpleNamespace(metric="gn_replay_pct.offline", trace=Trace(spans=spans),
                               traced=[0, 1], iterations=[3, 3])

    assert read(ctx(spans)) == pytest.approx(75.0)
    # A program without the replay span (an older commit): no reading.
    assert read(ctx([s for s in spans if s[0] not in ("kiss/gn_replay", "kiss/gn_capture")])) \
        is None
    assert read(ctx([])) is None
