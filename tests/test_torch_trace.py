"""The port's profiler spans (kiss_icp_tpu_torch/trace.py), on the CPU.

Under torch.profiler, a 3-chunk `KissICP` drive (`build_chunk` ->
`dispatch_chunk` -> `summary_poses`) and a 2-row `BatchedOdometry` record
every named span, nested where the work happens. Each Gauss-Newton loop
reads its test once a trip and once more (`kiss/sync/gn` = `kiss/gn_trip` +
1), and its trips are ceil(iterations / u) at gn_unroll 1 and 2, as
tests/torch_gn_count.py counts them from outside. A frame's map update
(`kiss/map_insert`, then `kiss/map_trim` beside it) reads nothing back.
Without a profiler a frame enters no `record_function`. Under
`torch.export` the step holds no profiler op, even while a profiler runs.
The benchmark's readers of the spans (odobench/layer_metrics) give their
numbers on a hand-made trace, and nothing where the spans are missing.
"""

import collections
import io
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_gn_count
from kiss_icp_tpu_torch import trace
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.io import aot
from kiss_icp_tpu_torch.odometry import KissICP
from kiss_icp_tpu_torch.parallel.batch import BatchedOdometry
from odobench.harness import Layout
from odobench.trace import Trace

torch.set_num_threads(1)

CHUNKS, K = 3, 2
CELLS = ("ouster64-10hz.offline", "hdl64e-kitti.offline", "hdl64e-kitti.batch11")


def _config(unroll=1):
    c = KISSConfig()
    c.data.max_range = 30.0
    c.data.min_range = 1.0
    c.mapping.voxel_size = 1.0
    c.engine.max_points_per_frame = 4096
    c.engine.frame_capacity = 2048
    c.engine.source_capacity = 512
    c.engine.map_capacity_log2 = 14
    c.engine.gn_unroll = unroll
    return c


@pytest.fixture(scope="module")
def scans():
    n = CHUNKS * K
    ds = SyntheticDataset(sequence=0, n_scans=n, n_beams=16, n_azimuth=256,
                          max_range=30.0, speed=1.0, accel_frames=3)
    return [ds[i] for i in range(n)]


def _profiled(fn):
    """The events of the `kiss/` spans `fn()` recorded under torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("kiss/")]


def _count(events):
    return collections.Counter(e.name for e in events)


def _loops(events, loop):
    """(trips, test reads) of each run of the control loop `loop`, in order:
    the spans grouped by the span the loop ran in."""
    runs = {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        kind = {f"kiss/{loop}_trip": 0, f"kiss/sync/{loop}": 1}.get(e.name)
        if kind is not None:
            runs.setdefault(e.cpu_parent.id, [0, 0])[kind] += 1
    return [tuple(r) for r in runs.values()]


def _parents(events, name):
    return {e.cpu_parent.name if e.cpu_parent is not None else None
            for e in events if e.name == name}


@pytest.mark.parametrize("unroll", [1, 2])
def test_chunked_drive_spans(scans, unroll):
    icp = KissICP(_config(unroll), device="cpu")
    iters = []

    def drive():
        for c in range(CHUNKS):
            part = scans[c * K:(c + 1) * K]
            chunk, dropped = icp.build_chunk([s[0] for s in part], [s[1] for s in part])
            summary = icp.dispatch_chunk(chunk, dropped)
            icp.summary_poses(summary)
            iters.extend(int(i) for i in summary.num_iterations)

    with torch_gn_count.counting() as rec:
        events = _profiled(drive)
    n = CHUNKS * K
    got = _count(events)
    for name, want in {"kiss/pack": CHUNKS, "kiss/h2d": CHUNKS, "kiss/summary": CHUNKS,
                       "kiss/sync/poses": CHUNKS, "kiss/frame": n, "kiss/preprocess": n,
                       "kiss/downsample": 2 * n, "kiss/threshold": 2 * n, "kiss/align": n,
                       "kiss/map_insert": n, "kiss/map_trim": n,
                       "kiss/sync/map_empty": n}.items():
        assert got[name] == want, (name, got[name])
    assert {k for k in got if k.startswith("kiss/sync/")} == {
        "kiss/sync/gn", "kiss/sync/map_empty", "kiss/sync/poses"}

    # The first frame meets an empty map and runs no loop.
    assert iters[0] == 0 and all(i > 0 for i in iters[1:])
    loops = _loops(events, "gn")
    assert loops == [(math.ceil(i / unroll), math.ceil(i / unroll) + 1) for i in iters[1:]]
    assert [t for t, _ in loops] == [loop["trips"] for loop in rec.loops]
    # One solve an iteration run, frozen ones included.
    assert got["kiss/solve"] == rec.total("evals") == unroll * got["kiss/gn_trip"]

    assert _parents(events, "kiss/frame") == {None}
    assert _parents(events, "kiss/align") == {"kiss/frame"}
    assert _parents(events, "kiss/gn_trip") == _parents(events, "kiss/sync/gn") == {"kiss/align"}
    assert _parents(events, "kiss/solve") == {"kiss/gn_trip"}
    assert _parents(events, "kiss/map_insert") == _parents(events, "kiss/map_trim") \
        == {"kiss/frame"}


@pytest.mark.parametrize("unroll", [1, 2])
def test_batched_step_spans(scans, unroll):
    odo = BatchedOdometry(_config(unroll), 2, device="cpu")
    steps = 3
    iters = []

    def drive():
        for i in range(steps):
            rows = [scans[i], scans[i + 1]]
            odo.register_frames([r[0] for r in rows], [r[1] for r in rows])
            iters.append(odo.last_result.num_iterations.tolist())

    with torch_gn_count.counting() as rec:
        events = _profiled(drive)
    got = _count(events)
    for name in ("kiss/pack", "kiss/h2d", "kiss/frame", "kiss/align", "kiss/sync/poses",
                 "kiss/sync/map_empty"):
        assert got[name] == steps, (name, got[name])
    # One lockstep loop a step; the first step's maps are empty, so its loop
    # reads its test once and runs no trip.
    slowest = [max(row) for row in iters]
    assert slowest[0] == 0 and min(slowest[1:]) > 0
    loops = _loops(events, "gn")
    assert loops == [(math.ceil(s / unroll), math.ceil(s / unroll) + 1) for s in slowest]
    assert [t for t, _ in loops] == [loop["trips"] for loop in rec.loops]
    assert got["kiss/solve"] == rec.total("evals")
    assert _parents(events, "kiss/frame") == {None}
    assert _parents(events, "kiss/gn_trip") == {"kiss/align"}


def test_no_profiler_no_record_function(scans, monkeypatch):
    """The spans' gate: with no profiler, a chunk, a streamed frame and a
    batch step never enter `record_function`; under a profiler they do."""
    entered = []
    real = torch.ops.profiler._record_function_enter_new

    def counted(*args):
        entered.append(args[0])
        return real(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counted)
    icp = KissICP(_config(), device="cpu")
    odo = BatchedOdometry(_config(), 2, device="cpu")

    def drive(part):
        chunk, dropped = icp.build_chunk([s[0] for s in part], [s[1] for s in part])
        icp.summary_poses(icp.dispatch_chunk(chunk, dropped))
        icp.register_frame(*part[-1])
        odo.register_frames([s[0] for s in part], [s[1] for s in part])

    drive(scans[:2])
    drive(scans[2:4])
    assert not trace.enabled() and entered == []
    _profiled(lambda: drive(scans[4:6]))
    assert "kiss/frame" in entered and "kiss/sync/gn" in entered


def test_exported_step_holds_no_profiler_op():
    """The per-frame step of io/aot.py exported while a profiler runs."""
    c = _config()
    c.engine.max_points_per_frame = 1024
    c.engine.frame_capacity = 1024
    c.engine.source_capacity = 256
    c.engine.map_capacity_log2 = 13
    c.engine.donate_state = False
    c.registration.max_num_iterations = 10
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        blob = aot.export_step(c, device="cpu")
    ep = torch.export.load(io.BytesIO(blob))
    targets = {str(node.target) for gm in ep.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule) for node in gm.graph.nodes
               if node.op == "call_function"}
    assert any("while_loop" in t for t in targets)
    assert not [t for t in targets if "profiler" in t or "record_function" in t]


# --- the benchmark's readers of the spans ------------------------------------

# Two traced frames: a call's pack and copy, two GN trips and their reads,
# and the pose read.
HAND_MADE = Trace(spans=[
    ("odobench/dispatch_chunk", 0.0, 1000.0), ("kiss/pack", 0.0, 100.0),
    ("kiss/h2d", 100.0, 150.0), ("kiss/frame", 150.0, 900.0), ("kiss/align", 190.0, 395.0),
    ("kiss/sync/gn", 195.0, 200.0), ("kiss/gn_trip", 200.0, 260.0),
    ("kiss/sync/gn", 260.0, 300.0), ("kiss/gn_trip", 300.0, 380.0),
    ("kiss/sync/gn", 380.0, 390.0), ("kiss/sync/poses", 900.0, 950.0)])

READINGS = {"syncs_per_frame.offline": 4 / 2, "sync_wait_ms.offline": 0.105 / 2,
            "gn_trip_us.offline": 70.0, "pack_ms.offline": 0.1 / 2, "h2d_ms.offline": 0.05 / 2}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_span_reader_on_hand_made_trace(metric):
    layout = Layout()
    for cell in CELLS:
        assert metric in {m["name"] for m in layout.metrics("per_layer", cell)}
    read = layout.reader(metric).read
    ctx = SimpleNamespace(metric=metric, trace=HAND_MADE, traced=[0, 1], iterations=[3, 3])
    assert read(ctx) == pytest.approx(READINGS[metric])
    # A program without the spans (an older commit): no reading, no error.
    bare = Trace(spans=[s for s in HAND_MADE.spans if not s[0].startswith("kiss/")])
    assert read(SimpleNamespace(metric=metric, trace=bare, traced=[0, 1],
                                iterations=[3, 3])) is None
    assert read(SimpleNamespace(metric=metric, trace=Trace(), traced=[],
                                iterations=[])) is None
