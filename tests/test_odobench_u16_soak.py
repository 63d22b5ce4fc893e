"""The `ouster64-u16-soak` deployment on the CPU at a tiny size: the port at
`map_storage` u16 with `ground_align` 0.1 against its reference
(`odobench/reference/kiss_soak.py`), the reference's ground fit against
the port's, the ground-off control, the harness's refusal under `kiss.py`,
and the cell's two per-layer readers on a hand-made trace.

A 16 x 256 sensor, a 2^14-slot map and 8 frames; the limits are the cell's
own file."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from odobench.harness import REPO, Layout, unmodelled
from odobench.reference import kiss, kiss_soak
from odobench.reference.soak_control import GroundOff
from odobench.scans import Drive, Sensor
from odobench.trace import Trace

CELL = "ouster64-u16-soak.offline"
N_FRAMES = 8
SOAK_KISS = {
    "data": {"deskew": True, "max_range": 70.0, "min_range": 0.0},
    "mapping": {"voxel_size": 1.0, "max_points_per_voxel": 20},
    "adaptive_threshold": {"initial_threshold": 2.0, "min_motion_th": 0.1},
    "registration": {"max_num_iterations": 500, "convergence_criterion": 0.0001},
    "engine": {"max_points_per_frame": 4096, "frame_capacity": 4096, "source_capacity": 1024,
               "map_capacity_log2": 14, "probe_length": 16, "group_capacity": 16,
               "map_storage": "u16", "ground_align": 0.1},
}
SENSOR = {"n_beams": 16, "n_azimuth": 256, "elevation_deg": [-16.6, 16.6], "distort": True,
          "noise": 0.01, "dropout": 0.2}
QUANTUM = 1.0 / 65535.0


@pytest.fixture(scope="module")
def limits():
    return json.loads((REPO / "odobench" / "limits" / f"{CELL}.json").read_text())


@pytest.fixture(scope="module")
def drive():
    torch.set_num_threads(1)
    sensor = Sensor(**SENSOR, max_range=70.0)
    return Drive(sensor, N_FRAMES, world_seed=[2**32 + 5, 0, 0], noise_seed=17, speed=1.0,
                 accel_frames=4, turn_rate=0.02).render()


@pytest.fixture(scope="module")
def port(drive):
    """The port's chunked drive on the CPU: (poses (K, 4, 4), its state)."""
    from kiss_icp_tpu_torch.config.schema import config_from_dict
    from kiss_icp_tpu_torch.odometry import KissICP

    torch.set_num_threads(1)
    icp = KissICP(config_from_dict(SOAK_KISS), device="cpu")
    poses = []
    for a in range(0, N_FRAMES, 4):
        scans = drive[a:a + 4]
        poses.extend(icp.register_frames_chunked([s[0] for s in scans], [s[1] for s in scans]))
    return np.asarray(poses), icp


def _checks(params, drive, poses):
    """(median gap m, share of frames over 5 cm in %) of the registered
    frames 1.. against the reference following `poses`."""
    frames = list(range(1, N_FRAMES))
    out = kiss_soak.follow(params, drive, poses, frames)
    gaps = np.array([kiss_soak.pose_gap(params, out[k][0], poses[k]) for k in frames])
    return float(np.median(gaps)), 100.0 * float(np.mean(gaps > 0.05))


def test_the_port_is_within_the_cells_limits(drive, port, limits):
    poses, _ = port
    params = kiss_soak.Params.from_config(SOAK_KISS)
    assert params.map_storage == "u16" and params.ground_align == 0.1
    median, over = _checks(params, drive, poses)
    assert median <= limits["pose_gap_median_m"]
    assert over <= limits["frames_over_5cm_pct"]


def test_the_port_stores_u16_within_a_quantum_of_the_reference(drive, port):
    """The map payload is uint16, and each stored point's 16-bit offsets are
    within one quantum (v / 65535) of the reference's point at the same
    voxel and lane, the reference following the port's poses."""
    poses, icp = port
    m = icp.state.map
    assert m.points.dtype == torch.uint16
    live = m.counts > 0
    stored = (m.points[live].view(torch.int16).to(torch.int64) & 0xFFFF)

    params = kiss_soak.Params.from_config(SOAK_KISS)
    odo = kiss_soak.Odometry(params, kiss.Math())
    for k in range(N_FRAMES):
        # The port's world poses; its map is in its local frame.
        local = poses[k].copy()
        local[:3, 3] -= icp.origin
        odo.step(*drive[k], pose=local, register=False)
    corners = kiss_soak._unpack(odo.map.keys).double()[:, None, :]
    ref_q = torch.round((odo.map.pts - corners) / QUANTUM).to(torch.int64)
    ref = {tuple(c): (n, q) for c, n, q in zip(kiss_soak._unpack(odo.map.keys).tolist(),
                                               odo.map.cnt.tolist(), ref_q)}
    same, near, total = 0, 0, 0
    for key, n, q in zip(m.vkeys[live].tolist(), m.counts[live].tolist(), stored):
        total += n
        if tuple(key) not in ref or ref[tuple(key)][0] != n:
            continue
        d = torch.abs(q[:n] - ref[tuple(key)][1][:n]).amax(dim=1)
        same += int(torch.sum(d == 0))
        near += int(torch.sum(d <= 1))
    assert total > 5_000
    assert near >= 0.99 * total
    assert same >= 0.5 * total


def _tilted_plane(seed=6, n=6000):
    rng = np.random.default_rng(seed)
    r, th = rng.uniform(2, 32, n), rng.uniform(0, 2 * np.pi, n)
    x, y = r * np.cos(th), r * np.sin(th)
    z = 0.005 * x - 0.003 * y - 1.8 + rng.normal(0, 0.01, n)
    # Clutter above the ground that the band leaves out.
    z[: n // 10] += rng.uniform(1.0, 4.0, n // 10)
    return np.stack([x, y, z], 1)


def test_the_reference_ground_fit_agrees_with_the_port():
    from kiss_icp_tpu_torch.ops import ground

    pts = _tilted_plane()
    normal = kiss_soak.ground_normal(torch.from_numpy(pts))
    plane = ground.estimate_ground_plane(torch.from_numpy(pts.astype(np.float32)),
                                         torch.ones(len(pts), dtype=torch.bool))
    assert normal is not None and bool(plane.ok)
    want = np.array([-0.005, 0.003, 1.0]) / np.linalg.norm([-0.005, 0.003, 1.0])
    np.testing.assert_allclose(normal.numpy(), want, atol=2e-3)
    np.testing.assert_allclose(normal.numpy(), plane.normal_body.double().numpy(), atol=1e-5)

    pose = np.eye(4)
    pose[:3, 3] = [3.0, -2.0, 0.5]
    mth = kiss.Math()
    got = kiss_soak.level(mth, mth.tensor(pose), normal, 0.1).numpy()
    port_pose = ground.align_pose_to_ground(torch.from_numpy(pose.astype(np.float32)),
                                            plane, 0.1).double().numpy()
    np.testing.assert_allclose(got, port_pose, atol=1e-6)
    np.testing.assert_array_equal(got[:3, 3], pose[:3, 3])
    tilt = np.arccos(want[2])
    assert np.arccos(np.clip((np.trace(got[:3, :3]) - 1) / 2, -1, 1)) == pytest.approx(
        0.1 * tilt, rel=2e-2)
    # Too few points, and a wall: refused by both, the pose left as it was.
    few = torch.from_numpy(pts[:150])
    assert kiss_soak.ground_normal(few) is None
    wall = pts.copy()
    wall[:, 2] = 2.0 * wall[:, 0]
    assert kiss_soak.ground_normal(torch.from_numpy(wall)) is None
    assert not bool(ground.estimate_ground_plane(
        torch.from_numpy(wall.astype(np.float32)), torch.ones(len(pts), dtype=torch.bool)).ok)
    assert torch.equal(kiss_soak.level(mth, mth.tensor(pose), None, 0.1), mth.tensor(pose))


def test_the_ground_off_control_fails_the_limits(drive, limits):
    torch.set_num_threads(1)
    control = GroundOff(SOAK_KISS, "cpu")
    poses = control.chunk(drive)
    median, over = _checks(kiss_soak.Params.from_config(SOAK_KISS), drive, poses)
    assert median > limits["pose_gap_median_m"] or over > limits["frames_over_5cm_pct"]


def test_only_the_soak_reference_models_the_configuration():
    layout = Layout(REPO)
    config = layout.config("ouster64-u16-soak")
    assert layout.reference(config).__file__ == kiss_soak.__file__
    assert unmodelled(config["kiss"], kiss_soak.MODELS) == []
    assert sorted(unmodelled(config["kiss"], kiss.MODELS)) == [
        "kiss.engine.ground_align: 0.1", "kiss.engine.map_storage: 'u16'"]
    for value in (-0.1, float("nan"), "0.1", True):
        engine = dict(config["kiss"]["engine"], ground_align=value)
        assert unmodelled(dict(config["kiss"], engine=engine), kiss_soak.MODELS) == [
            f"kiss.engine.ground_align: {value!r}"]


# Two traced frames: a ground fit in each, K2 launched 3 times (one frame of
# 1 GN iteration, one of 0) for 30 us in all.
TRACE = Trace(
    device=[("nn27_kernel", 0.0, 10.0), ("nn27_kernel", 20.0, 10.0),
            ("nn27_kernel", 40.0, 10.0), ("linsys_kernel", 60.0, 5.0)],
    spans=[("odobench/dispatch_chunk", 0.0, 1000.0), ("kiss/ground", 100.0, 400.0),
           ("kiss/map_insert", 400.0, 500.0), ("kiss/ground", 600.0, 700.0)])
RECORD = {"queries": 1000, "voxels": 2000, "voxel_points": 20_000, "candidates": 300_000,
          "correspondences": 900}


def _ctx(metric):
    return SimpleNamespace(metric=metric, trace=TRACE, traced=[0, 1], iterations=[1, 0],
                           work={0: [RECORD], 1: [RECORD, RECORD]})


def test_ground_ms_reads_the_fit_spans():
    read = Layout(REPO).reader("ground_ms.offline").read
    assert read(_ctx("ground_ms.offline")) == pytest.approx(0.4 / 2)
    empty = SimpleNamespace(metric="ground_ms.offline", trace=Trace(), traced=[0], iterations=[1])
    assert read(empty) is None


def test_k2u16_roofline_counts_six_bytes_a_point():
    from odobench import work

    read = Layout(REPO).reader("k2u16_roofline.offline").read
    nbytes = 1000 * (12 + 1 + 12 + 4 + 1) + 2000 * 16 + 20_000 * 6
    least = max(nbytes / work.HBM_BYTES_PER_S, 8 * 300_000 / work.F32_FLOPS_PER_S)
    # Three launches (1 + 1 and 0 + 1), each of the same least time, in 30 us.
    assert read(_ctx("k2u16_roofline.offline")) == pytest.approx(100.0 * 3 * least / 30e-6)
    f32 = Layout(REPO).reader("k2_roofline.offline").read(_ctx("k2_roofline.offline"))
    assert f32 > read(_ctx("k2u16_roofline.offline"))
    bare = _ctx("k2u16_roofline.offline")
    bare.trace = Trace(spans=TRACE.spans)
    assert read(bare) is None
