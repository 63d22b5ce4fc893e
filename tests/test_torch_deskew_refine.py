"""The frame options engine.deskew_refine and engine.deskew_refine_map in the
port against the JAX package, and every option through the port's chunked
driver and CLI.

  * deskew_refine = 1 and 2: 6-frame drives (16x512 beams, 2^15-slot map)
    against JAX's KissICP, poses within atol 1e-4, iteration counts (base
    and refine passes summed) and drop counters equal.
  * deskew_refine_map: the same 6 frames, free, within atol 1e-4 and
    iterations equal up to frame 3 (0-based), drop counts equal on all.
    From frame 4 the drives part by ~1e-3 m: at frame 2 the refined deskew
    puts one point of the map cloud into another half voxel than JAX's
    (XLA's FMAs; float64 puts it on the port's side), and with JAX's map
    carried in after frame 2 the port gives JAX's poses and iterations on
    every later frame (ROADMAP Queue 3, known).
  * Without per-point stamps both options are inert, as in JAX.
  * A non-finite refine pass keeps the base pose and raises no fallback.
  * The chunked driver gives register_frame's bits with every option on;
    the CLI's poses equal the JAX CLI's.
"""

import numpy as np
import jax
import pytest
import torch
import yaml

from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.tools import cmd as jcmd
from kiss_icp_tpu_torch import convert, odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.ops import registration
from kiss_icp_tpu_torch.tools import cmd

torch.set_num_threads(1)

N_FRAMES = 6


def _config(cls, **engine):
    cfg = cls()
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 8192
    cfg.engine.frame_capacity = 8192
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 15
    for key, value in engine.items():
        setattr(cfg.engine, key, value)
    return cfg


def _scans(n=N_FRAMES, **kw):
    ds = SyntheticDataset(sequence=1, n_scans=n, n_beams=16, n_azimuth=512,
                          speed=1.0, accel_frames=6, **kw)
    return [ds[i] for i in range(n)]


@pytest.mark.parametrize("passes", [1, 2])
def test_refine_drive_matches_jax(passes):
    icp = odometry.KissICP(_config(KISSConfig, deskew_refine=passes), device="cpu")
    jicp = jodo.KissICP(_config(JaxConfig, deskew_refine=passes))
    base_iters = 0
    for i, (pts, stamps) in enumerate(_scans()):
        icp.register_frame(pts, stamps)
        jicp.register_frame(pts, stamps)
        np.testing.assert_allclose(icp.last_pose, jicp.last_pose, atol=1e-4, err_msg=f"frame {i}")
        assert icp.last_result.num_iterations == int(jicp.last_result.num_iterations)
        assert int(icp.last_result.num_correspondences) == \
            int(jicp.last_result.num_correspondences)
        assert icp.last_overflow() == jicp.last_overflow()
        assert not bool(icp.last_result.used_fallback)
        base_iters += icp.last_result.num_iterations
    assert base_iters > 60  # the refine passes ran (the single pass takes 79)


def _padded(pts, stamps, cap=8192):
    p, t, v = np.zeros((cap, 3), np.float32), np.zeros(cap, np.float32), np.zeros(cap, bool)
    p[:len(pts)], t[:len(pts)], v[:len(pts)] = pts, stamps, True
    return p, t, v


FLIP_FRAME = 2  # the frame whose map cloud the deskew rounding changes


@pytest.fixture(scope="module")
def refine_map_drives():
    """Free deskew_refine_map drives of the port and of JAX, per frame
    capacity: each frame's pose, iterations, downsample drops, previous
    pose and refined frame cloud; and JAX's state after FLIP_FRAME."""
    out = {}
    for cap in (8192, 2048):
        cfg = _config(KISSConfig, deskew_refine_map=True, frame_capacity=cap)
        jcfg = _config(JaxConfig, deskew_refine_map=True, frame_capacity=cap,
                       donate_state=False)
        step = jodo.make_step(jcfg)
        state, jstate = odometry.init_state(cfg, "cpu"), jodo.init_state(jcfg)
        runs = {"port": [], "jax": []}
        for i, scan in enumerate(_scans()):
            p, t, v = _padded(*scan)
            prev, jprev = state.pose.numpy().copy(), np.array(jstate.pose)
            state, res = odometry.register_frame(cfg, state, torch.from_numpy(p),
                                                 torch.from_numpy(t), torch.from_numpy(v))
            jstate, jres = step(jstate, p, t, v)
            for name, r, before in (("port", res, prev), ("jax", jres, jprev)):
                runs[name].append(dict(
                    pose=np.array(r.pose), iters=int(r.num_iterations), prev=before,
                    drops=int(r.num_dropped_downsample), scan=(p, t, v),
                    points=np.array(r.frame_points), valid=np.array(r.frame_valid)))
            if i == FLIP_FRAME:
                runs["jax_state"] = [np.asarray(x) for x in jax.tree_util.tree_flatten(jstate)[0]]
        out[cap] = (cfg, runs)
    return out


@pytest.mark.parametrize("frame_capacity", [8192, 2048])
def test_refine_map_free_drive_matches_jax(refine_map_drives, frame_capacity):
    """Free drives: every frame up to the one after FLIP_FRAME within atol
    1e-4, iterations equal; the downsample drops equal on every frame (with
    a 2048-point frame cloud the downsample drops voxels: the count is the
    base pass's, taken before the map-only pass rebuilds the cloud, as in
    JAX)."""
    _, runs = refine_map_drives[frame_capacity]
    for i, (got, ref) in enumerate(zip(runs["port"], runs["jax"])):
        if i <= FLIP_FRAME + 1:
            np.testing.assert_allclose(got["pose"], ref["pose"], atol=1e-4, err_msg=f"frame {i}")
            assert got["iters"] == ref["iters"], i
        assert got["drops"] == ref["drops"], i
    assert (runs["port"][-1]["drops"] > 0) == (frame_capacity < 8192)


def test_refine_map_flip_lies_on_the_port_side(refine_map_drives):
    """At FLIP_FRAME the refined deskew puts one point of the 16x512 scan
    into another half voxel than JAX's (XLA fuses the deskew into FMAs): a
    coordinate 1e-7 from a half-voxel boundary. The same deskew in float64,
    with the port's or with JAX's estimated motion, puts it in the port's
    half voxel."""
    from kiss_icp_tpu_torch.ops import preprocess, se3

    _, runs = refine_map_drives[8192]
    got, ref = runs["port"][FLIP_FRAME], runs["jax"][FLIP_FRAME]
    cell, jcell = np.floor(got["points"] / 0.5), np.floor(ref["points"] / 0.5)
    flipped = np.nonzero(np.any(cell != jcell, axis=1) & got["valid"])[0]
    assert len(flipped) == 1
    k = flipped[0]
    assert np.abs(got["points"][k] - ref["points"][k]).max() < 1e-6
    p, t, v = (torch.from_numpy(x) for x in got["scan"])
    for run in (got, ref):
        delta = (se3.inverse(torch.from_numpy(run["prev"]).double())
                 @ torch.from_numpy(run["pose"]).double())
        exact = preprocess.preprocess(p.double(), t.double(), v, delta, max_range=100.0,
                                      min_range=1.0, deskew=True).points[k].numpy()
        np.testing.assert_array_equal(np.floor(exact / 0.5), cell[k])


def test_refine_map_with_jax_map_after_the_flip_matches_jax(refine_map_drives):
    """The flip is the whole departure: the port's free drive, with JAX's
    map carried in after FLIP_FRAME, gives JAX's poses within atol 1e-4 and
    its iterations on every later frame."""
    cfg, runs = refine_map_drives[8192]
    jmap = convert.state_from_numpy(runs["jax_state"], cfg, "cpu").map
    state = odometry.init_state(cfg, "cpu")
    for i, ref in enumerate(runs["jax"]):
        state, res = odometry.register_frame(cfg, state, *(torch.from_numpy(x) for x in ref["scan"]))
        if i == FLIP_FRAME:
            state = state._replace(map=jmap)
        if i > FLIP_FRAME:
            np.testing.assert_allclose(res.pose.numpy(), ref["pose"], atol=1e-4,
                                       err_msg=f"frame {i}")
            assert res.num_iterations == ref["iters"], i


@pytest.mark.parametrize("option", [dict(deskew_refine_map=True), dict(deskew_refine=1)])
def test_options_without_stamps(option):
    """No per-point stamps: the deskew is inert. The map-only pass rebuilds
    the same cloud (bit-identical drive); the refine pass re-registers the
    same cloud from its converged pose (within 5e-3 m, at most 8 more
    iterations a frame, as tests/test_deskew_refine.py holds JAX)."""
    scans = [(pts, None) for pts, _ in _scans(5, distort=False)]
    runs = []
    for cfg in (_config(KISSConfig), _config(KISSConfig, **option)):
        icp = odometry.KissICP(cfg, device="cpu")
        poses, iters = [], []
        for pts, stamps in scans:
            icp.register_frame(pts, stamps)
            poses.append(icp.last_pose)
            iters.append(icp.last_result.num_iterations)
        runs.append((np.stack(poses), np.asarray(iters)))
    (p0, it0), (p1, it1) = runs
    if "deskew_refine_map" in option:
        np.testing.assert_array_equal(p0, p1)
        np.testing.assert_array_equal(it0, it1)
    else:
        np.testing.assert_allclose(p0, p1, atol=5e-3)
        assert np.all(it1 - it0 <= 8) and np.all(it1 >= it0)


def test_nonfinite_refine_pass_keeps_base_pose(monkeypatch):
    """The refine pass returns a NaN pose: the frame keeps the base pass's
    pose (projected onto SO(3) once more, as in JAX: last bits only), counts
    both passes' iterations, and raises no fallback."""
    cfg = _config(KISSConfig, deskew_refine=1)
    scans = _scans(2)
    ref = odometry.KissICP(_config(KISSConfig), device="cpu")
    for scan in scans:
        ref.register_frame(*scan)

    real = registration.align_points_to_map
    calls = []

    def nan_on_refine(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out.num_iterations)
        if len(calls) % 2 == 0:
            out = out._replace(pose=torch.full_like(out.pose, float("nan")))
        return out

    monkeypatch.setattr(registration, "align_points_to_map", nan_on_refine)
    icp = odometry.KissICP(cfg, device="cpu")
    for scan in scans:
        icp.register_frame(*scan)
        assert not bool(icp.last_result.used_fallback)
    np.testing.assert_allclose(icp.last_pose, ref.last_pose, rtol=0, atol=1e-9)
    assert icp.last_result.num_iterations == calls[-2] + calls[-1]


ALL_OPTIONS = dict(nn_mode="cached", deskew_refine=1, deskew_refine_map=True,
                   ground_align=0.1, gn_unroll=2)


def test_chunked_driver_with_every_option_matches_register_frame():
    scans = _scans(4)
    one = odometry.KissICP(_config(KISSConfig, **ALL_OPTIONS), device="cpu")
    for scan in scans:
        one.register_frame(*scan)
    chunked = odometry.KissICP(_config(KISSConfig, **ALL_OPTIONS), device="cpu")
    poses = np.concatenate([chunked.register_frames_chunked(
        [s[0] for s in part], [s[1] for s in part]) for part in (scans[:3], scans[3:])])
    np.testing.assert_array_equal(poses[-1], one.last_pose)
    assert int(chunked.last_chunk_summary.num_iterations[-1]) == one.last_result.num_iterations


@pytest.mark.parametrize("nn_mode", ["compact_loop", "cached"])
def test_cli_with_options_matches_jax_cli(tmp_path, monkeypatch, nn_mode):
    rng = np.random.default_rng(0)
    data = tmp_path / "scans"
    data.mkdir()
    base = rng.uniform(-30, 30, (4000, 4)).astype(np.float32)
    for i in range(3):
        scan = base.copy()
        scan[:, 0] += 0.5 * i
        scan.tofile(data / f"{i:04d}.bin")
    cfg = {
        "data": {"max_range": 60.0, "min_range": 1.0},
        "mapping": {"voxel_size": 0.5},
        "engine": dict(ALL_OPTIONS, nn_mode=nn_mode, max_points_per_frame=4096,
                       frame_capacity=4096, source_capacity=1024, map_capacity_log2=15),
        "registration": {"max_num_iterations": 20},
    }
    poses = {}
    monkeypatch.chdir(tmp_path)
    for name, main, extra in (("port", cmd.main, ["--device", "cpu"]), ("jax", jcmd.main, [])):
        out = tmp_path / f"results_{name}"
        cfg_file = tmp_path / f"{name}.yml"
        cfg_file.write_text(yaml.safe_dump(dict(cfg, out_dir=str(out))))
        assert main([str(data), "--config", str(cfg_file), *extra]) == 0
        poses[name] = np.load(out / "latest" / "scans_poses.npy")
    assert poses["port"].shape == (3, 4, 4)
    np.testing.assert_allclose(poses["port"], poses["jax"], atol=1e-4)
