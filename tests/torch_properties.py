"""Property runners shared by the port's property tests and chip_smoke.py.

The examples, checks and bounds of tests/test_properties.py and the closed
loop of tests/test_quantized_map.py, run on the port on any device: with
`device="cpu"` the kernel wrappers take their plain versions; with
`device="cuda"` the map query launches K2 and the odometry step K1 and K2.
Imports nothing of JAX: tests/test_torch_properties.py and
tests/test_torch_quantized_map.py add the JAX comparisons through each
runner's `on_example` hook, and chip_smoke.py's phase "properties" runs the
same runners on the card.

Every hypothesis runner is derandomized and seeded, with no example
database, so that it draws the same examples wherever the same hypothesis
version runs it: the tier-1 count stays steady run to run. Another version
draws other examples, so the examples the CPU tests draw are also recorded
in tests/torch_property_examples.npz, and each `replay_*` runs them through
the same checks on any device and any hypothesis version; remake the file
with `python tests/torch_properties.py` whenever a runner's strategy or
seed changes. KISS_PROP_EXAMPLES raises the example budget of the drawing
runners for one-off deep fuzz runs, as in the JAX suite.
"""

import os
from pathlib import Path

import numpy as np
import torch
from hypothesis import given, seed, settings, strategies as st
from hypothesis.extra.numpy import arrays

from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.kernels import nn27
from kiss_icp_tpu_torch.ops import hash_map

_DETERMINISTIC = dict(deadline=None, derandomize=True, database=None)
SET = settings(max_examples=int(os.environ.get("KISS_PROP_EXAMPLES", "30")), **_DETERMINISTIC)
FUZZ_SET = settings(max_examples=15, **_DETERMINISTIC)

finite = dict(allow_nan=False, allow_infinity=False)
twists = arrays(np.float32, (6,), elements=st.floats(-2.0, 2.0, width=32, **finite))
points_small = arrays(np.float32, (64, 3),
                      elements=st.floats(-20.0, 20.0, width=32, **finite))
garbage_points = arrays(np.float32, (4, 256, 3),
                        elements=st.one_of(st.floats(-1e4, 1e4, width=32, **finite),
                                           st.just(float("nan"))))
garbage_valid = arrays(np.bool_, (4, 256), elements=st.booleans())

# One seed a runner: a runner draws the same examples in every process.
MAP_QUERY_SEED = 162
GARBAGE_SEED = 240
SCENE_SEED = 241

# tests/test_properties.py's map.
MAP_KW = dict(voxel_size=1.0, max_distance=100.0, max_points_per_voxel=8,
              capacity_log2=13, probe_length=16, group_capacity=16)


def map_config(storage: str) -> hash_map.MapConfig:
    return hash_map.MapConfig(storage=storage, **MAP_KW)


def snap(x: np.ndarray) -> np.ndarray:
    """|x| < 1e-3 -> 0, tests/test_properties.py:170-171 (XLA's subnormal
    flush puts floor(-1e-38) in voxel 0, numpy in voxel -1)."""
    return np.where(np.abs(x) < 1e-3, 0.0, x).astype(np.float32)


def map_query_example(store_pts, queries, storage: str, device):
    """tests/test_properties.py:162: whatever the map stored, every answer
    of the query (K2 on a CUDA device) is honest (the reported distance IS
    the distance to the returned neighbour) and optimal (no stored point in
    the query's 27-voxel neighbourhood is closer), against brute force in
    numpy; no answer only where the neighbourhood is empty. Returns
    (neighbours, distances, found) as numpy arrays."""
    cfg = map_config(storage)
    store_pts, queries = snap(store_pts), snap(queries)
    dev = torch.device(device)
    m = hash_map.create_map(cfg, device=dev)
    m, _ = hash_map.insert(cfg, m, torch.from_numpy(store_pts).to(dev),
                           torch.ones(len(store_pts), dtype=torch.bool, device=dev))
    q = nn27.query_nearest(cfg, m, torch.from_numpy(queries).to(dev),
                           torch.ones(len(queries), dtype=torch.bool, device=dev))
    dist, nn, found = q.distances.cpu().numpy(), q.neighbors.cpu().numpy(), q.found.cpu().numpy()

    stored, mask = hash_map.extract_points(cfg, m)
    stored = stored.cpu().numpy()[mask.cpu().numpy()]
    skeys = np.floor(stored / cfg.voxel_size).astype(np.int64)
    for i, query in enumerate(queries):
        qk = np.floor(query / cfg.voxel_size).astype(np.int64)
        in_hood = np.all(np.abs(skeys - qk) <= 1, axis=1)
        best = (np.linalg.norm(stored[in_hood] - query, axis=1).min()
                if in_hood.any() else np.inf)
        if np.isfinite(dist[i]):
            np.testing.assert_allclose(dist[i], np.linalg.norm(nn[i] - query),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(dist[i], best, rtol=1e-5, atol=1e-5)
        else:
            assert not in_hood.any()
    return nn, dist, found


def run_map_query(storage: str, device, on_example=None) -> int:
    """The map-query property over its examples; `on_example(store_pts,
    queries, result)` runs after each example's checks. Returns the number
    of examples."""
    count = 0

    @SET
    @seed(MAP_QUERY_SEED)
    @given(points_small, points_small)
    def prop(store_pts, queries):
        nonlocal count
        count += 1
        result = map_query_example(store_pts, queries, storage, device)
        if on_example is not None:
            on_example(store_pts, queries, result)

    prop()
    return count


def fuzz_config(cls=KISSConfig):
    """tests/test_properties.py's `_fuzz_config`."""
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 256
    cfg.engine.frame_capacity = 256
    cfg.engine.source_capacity = 128
    cfg.engine.map_capacity_log2 = 11
    cfg.engine.donate_state = False
    cfg.registration.max_num_iterations = 6
    return cfg


def garbage_example(pts, valid, device):
    """tests/test_properties.py:240: four frames of NaN floods, +-1e4
    outliers and random masks through register_frame (K1 and K2 on a CUDA
    device): every pose finite and SE(3) (R^T R within 1e-4 of I), sigma
    finite. Returns [(pose (4,4), sigma, iterations)] a frame."""
    cfg = fuzz_config()
    dev = torch.device(device)
    state = odometry.init_state(cfg, device=dev)
    ts = torch.zeros(256, dtype=torch.float32, device=dev)
    out = []
    for i in range(4):
        state, res = odometry.register_frame(cfg, state, torch.from_numpy(pts[i]).to(dev), ts,
                                             torch.from_numpy(valid[i]).to(dev))
        pose = res.pose.cpu().numpy()
        assert np.all(np.isfinite(pose)), pose
        r = pose[:3, :3]
        np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-4)
        sigma = res.sigma.cpu().numpy()
        assert np.all(np.isfinite(sigma))
        out.append((pose, float(sigma), int(res.num_iterations)))
    return out


def run_garbage(device, on_example=None) -> int:
    """The garbage fuzz over its examples; `on_example(pts, valid, frames)`
    runs after each example's checks. Returns the number of examples."""
    count = 0

    @FUZZ_SET
    @seed(GARBAGE_SEED)
    @given(garbage_points, garbage_valid)
    def prop(pts, valid):
        nonlocal count
        count += 1
        frames = garbage_example(pts, valid, device)
        if on_example is not None:
            on_example(pts, valid, frames)

    prop()
    return count


def scene_frames(garbage, replace, valid):
    """The garbage of `run_garbage` over a scene: a fixed cloud of 256
    points 2-45 m out, moving 0.2 m a frame, with each point where `replace`
    holds swapped for its garbage value (NaN, or anything within +-1e4 m,
    near values included), and `valid` masking points out. Returns the four
    frames (4, 256, 3) f32."""
    rng = np.random.default_rng(SCENE_SEED)
    base = rng.uniform(-30.0, 30.0, (4 * 256, 3)).astype(np.float32)
    r = np.linalg.norm(base, axis=1)
    base = base[(r > 2.0) & (r < 45.0)][:256]
    step = np.array([0.2, 0.05, 0.0], np.float32)
    frames = np.stack([base + step * i for i in range(4)])
    return np.where(replace[..., None], garbage, frames).astype(np.float32), valid


def run_garbage_in_scene(device, on_example=None) -> int:
    """The garbage fuzz over a scene (`scene_frames`): the same checks as
    `run_garbage`, on frames where enough points survive the crop that the
    Gauss-Newton loop runs (JAX's own fuzz draws points within +-1e4 m
    uniformly, so hardly one lands 1-50 m out and its frames crop to
    nothing). `on_example(pts, valid, frames)` as in `run_garbage`."""
    count = 0

    @FUZZ_SET
    @seed(SCENE_SEED)
    @given(garbage_points, garbage_valid, garbage_valid)
    def prop(garbage, replace, valid):
        nonlocal count
        count += 1
        pts, valid = scene_frames(garbage, replace, valid)
        frames = garbage_example(pts, valid, device)
        if on_example is not None:
            on_example(pts, valid, frames)

    prop()
    return count


def closed_loop_config(storage: str, cls=KISSConfig):
    """tests/test_quantized_map.py:89-101's config."""
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 2048
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 13
    cfg.engine.donate_state = False
    cfg.engine.map_storage = storage
    cfg.registration.max_num_iterations = 15
    return cfg


def closed_loop_frames():
    """tests/test_quantized_map.py's four frames: one cloud moving 0.25 m a
    frame along x, 0.05 along y."""
    rng = np.random.default_rng(11)
    base = rng.uniform(-30, 30, (2048, 3)).astype(np.float32)
    return [base + np.array([0.25 * i, 0.05 * i, 0], np.float32) for i in range(4)]


def closed_loop_poses(storage: str, device) -> np.ndarray:
    """The four frames' poses (4, 4, 4) with the map stored as `storage`."""
    cfg = closed_loop_config(storage)
    dev = torch.device(device)
    state = odometry.init_state(cfg, device=dev)
    ts = torch.zeros(2048, dtype=torch.float32, device=dev)
    valid = torch.ones(2048, dtype=torch.bool, device=dev)
    poses = []
    for pts in closed_loop_frames():
        state, res = odometry.register_frame(cfg, state, torch.from_numpy(pts).to(dev), ts,
                                             valid)
        poses.append(res.pose.cpu().numpy())
    return np.stack(poses)


EXAMPLES = Path(__file__).resolve().with_name("torch_property_examples.npz")


def recorded() -> dict:
    """The recorded examples: map_store, map_queries (E, 64, 3);
    garbage_points / scene_points (E, 4, 256, 3), garbage_valid /
    scene_valid (E, 4, 256); the recording's hypothesis_version."""
    with np.load(EXAMPLES) as f:
        return {k: f[k] for k in f.files}


def replay_map_query(storage: str, device, on_example=None) -> int:
    """`run_map_query` over the recorded examples."""
    ex = recorded()
    for store_pts, queries in zip(ex["map_store"], ex["map_queries"]):
        result = map_query_example(store_pts, queries, storage, device)
        if on_example is not None:
            on_example(store_pts, queries, result)
    return len(ex["map_store"])


def replay_garbage(which: str, device, on_example=None) -> int:
    """`run_garbage` ("garbage") or `run_garbage_in_scene` ("scene") over
    the recorded frames (the scene's as `scene_frames` made them)."""
    ex = recorded()
    for pts, valid in zip(ex[f"{which}_points"], ex[f"{which}_valid"]):
        frames = garbage_example(pts, valid, device)
        if on_example is not None:
            on_example(pts, valid, frames)
    return len(ex[f"{which}_points"])


def record(path=EXAMPLES) -> dict:
    """Draw every runner's examples on the CPU (at the default budgets) and
    write them to `path`."""
    import hypothesis

    if "KISS_PROP_EXAMPLES" in os.environ:
        raise SystemExit("record at the default example budget: unset KISS_PROP_EXAMPLES")
    out = {k: [] for k in ("map_store", "map_queries", "garbage_points", "garbage_valid",
                           "scene_points", "scene_valid")}

    def keep(*names):
        def hook(a, b, _):
            for name, x in zip(names, (a, b)):
                out[name].append(np.array(x))
        return hook

    run_map_query("f32", "cpu", keep("map_store", "map_queries"))
    run_garbage("cpu", keep("garbage_points", "garbage_valid"))
    run_garbage_in_scene("cpu", keep("scene_points", "scene_valid"))
    arrays = {k: np.stack(v) for k, v in out.items()}
    np.savez_compressed(path, hypothesis_version=np.array(hypothesis.__version__), **arrays)
    return arrays


def main(argv) -> int:
    """`python tests/torch_properties.py` records the examples;
    `--check` draws them into a scratch file instead and exits 1 unless they
    equal the recorded ones."""
    import tempfile

    torch.set_num_threads(1)
    if argv[1:] == ["--check"]:
        rec = recorded()
        with tempfile.TemporaryDirectory() as tmp:
            drawn = record(Path(tmp) / "drawn.npz")
        bad = [k for k, a in drawn.items()
               if not np.array_equal(a, rec[k], equal_nan=a.dtype.kind == "f")]
        print(f"drawn examples differ from {EXAMPLES.name}: {bad}" if bad
              else f"drawn examples equal {EXAMPLES.name}")
        return 1 if bad else 0
    for name, a in record().items():
        print(name, a.shape, a.dtype)
    print("wrote", EXAMPLES)
    return 0


if __name__ == "__main__":
    import sys

    raise SystemExit(main(sys.argv))
