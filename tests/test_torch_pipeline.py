"""Port pipeline, CLI and metrics (kiss_icp_tpu_torch.pipeline, tools/cmd.py,
metrics.py) end to end on the CPU, against the JAX package's.

  * the result files (.npy, KITTI with 12 columns, TUM with 8, config.yml,
    result_metrics.log, the `latest` symlink), windowing and its validation;
  * the pipeline's poses equal JAX's OdometryPipeline on the same synthetic
    drive at atol 1e-4 (as tests/test_torch_odometry.py holds poses), and
    the chunked driver equals the streaming one bit for bit;
  * the CLI's return codes, --version, --visualize and a full
    run on a directory of .bin scans with --device cpu, beside JAX's CLI;
  * metrics bit-equal to JAX's on random trajectories;
  * the golden of chip_smoke.py's cli phase is made with the current
    `verify_drive_config()` (tests/make_torch_golden.py remakes it).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from kiss_icp_tpu import metrics as jmetrics
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.pipeline import OdometryPipeline as JaxPipeline
from kiss_icp_tpu.tools import cmd as jcmd
from kiss_icp_tpu_torch import metrics
from kiss_icp_tpu_torch.config import load_config
from kiss_icp_tpu_torch.config.schema import KISSConfig, config_to_dict
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.pipeline import OdometryPipeline
from kiss_icp_tpu_torch.tools import cmd
from kiss_icp_tpu_torch.tools.profile_drive import verify_drive_config

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent.parent / "kiss_icp_tpu_torch" / "tools" / \
    "golden_cli_drive.json"


def _small_config(tmp_path, cls=KISSConfig, **engine):
    cfg = cls()
    cfg.out_dir = str(tmp_path / "results")
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 8192
    cfg.engine.frame_capacity = 8192
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 15
    cfg.registration.max_num_iterations = 30
    if cls is JaxConfig:
        cfg.engine.use_pallas = False
    for k, v in engine.items():
        setattr(cfg.engine, k, v)
    return cfg


def _dataset(n, seq=1):
    return SyntheticDataset(sequence=seq, n_scans=n, n_beams=16, n_azimuth=256,
                            max_range=50.0, accel_frames=4)


def test_pipeline_end_to_end(tmp_path):
    ds = SyntheticDataset(sequence=1, n_scans=6, n_beams=32, n_azimuth=256, max_range=50.0)
    pipeline = OdometryPipeline(ds, config=_small_config(tmp_path), device="cpu")
    d = pipeline.run().as_dict()
    assert "Average Frequency" in d and "Average Frequency (no warmup)" in d
    assert "Average Translation Error" in d  # ground truth available
    assert np.isfinite(d["Absolute Trajectory Error (ATE)"])
    assert d["Absolute Trajectory Error (ATE)"] < 1.0

    out, seq = pipeline.results_dir, ds.sequence_id
    for name in (f"{seq}_poses.npy", f"{seq}_gt.npy", f"{seq}_gt_kitti.txt",
                 f"{seq}_gt_tum.txt", "config.yml", "result_metrics.log"):
        assert (out / name).exists(), name
    assert (out.parent / "latest").resolve() == out.resolve()
    assert np.loadtxt(out / f"{seq}_kitti.txt").shape == (6, 12)
    assert np.loadtxt(out / f"{seq}_tum.txt").shape == (6, 8)
    np.testing.assert_array_equal(np.load(out / f"{seq}_poses.npy"), pipeline.poses)
    assert yaml.safe_load((out / "config.yml").read_text())["engine"]["map_capacity_log2"] == 15


def test_pipeline_n_scans_jump_and_validation(tmp_path):
    ds = _dataset(8, seq=2)
    pipeline = OdometryPipeline(ds, config=_small_config(tmp_path), n_scans=3, jump=2,
                                device="cpu")
    pipeline.run()
    assert pipeline.poses.shape == (3, 4, 4)
    np.testing.assert_array_equal(pipeline.gt_poses, ds.gt_poses[2:5])
    with pytest.raises(ValueError, match="jump"):
        OdometryPipeline(ds, config=_small_config(tmp_path), jump=99, device="cpu")
    with pytest.raises(ValueError, match="n-scans"):
        OdometryPipeline(ds, config=_small_config(tmp_path), n_scans=-2, device="cpu")
    # max_range / deskew overrides apply to a config instance too.
    p = OdometryPipeline(ds, config=_small_config(tmp_path), max_range=33.0, deskew=False,
                         device="cpu")
    assert p.config.data.max_range == 33.0 and p.config.data.deskew is False


def test_pipeline_matches_jax_pipeline(tmp_path):
    ds = SyntheticDataset(sequence=1, n_scans=6, n_beams=16, n_azimuth=512,
                          speed=1.0, accel_frames=6)
    ours = OdometryPipeline(ds, config=_small_config(tmp_path / "a"), device="cpu")
    ours.run()
    ref = JaxPipeline(ds, config=_small_config(tmp_path / "b", JaxConfig))
    ref.run()
    assert ours._effective_chunk == ref._effective_chunk == 6
    for i in range(6):
        np.testing.assert_allclose(ours.poses[i], ref.poses[i], atol=1e-4, err_msg=f"frame {i}")
    d, jd = ours.results.as_dict(), ref.results.as_dict()
    assert d.keys() == jd.keys()
    np.testing.assert_allclose(d["Absolute Trajectory Error (ATE)"],
                               jd["Absolute Trajectory Error (ATE)"], atol=1e-4)


def test_pipeline_chunked_matches_streaming_and_auto_chunk(tmp_path):
    ds = _dataset(5, seq=5)
    runs = {}
    for chunk in (1, 3, 0):  # streaming, chunks of 3, auto
        p = OdometryPipeline(ds, config=_small_config(tmp_path, pipeline_chunk=chunk),
                             device="cpu")
        p.run()
        runs[chunk] = p
    np.testing.assert_array_equal(runs[3].poses, runs[1].poses)
    np.testing.assert_array_equal(runs[0].poses, runs[1].poses)
    assert runs[0]._effective_chunk == 5  # min(16, n_scans)
    assert runs[0]._resolve_chunk(headless=False) == 1
    long = OdometryPipeline(_dataset(20, seq=5), config=_small_config(tmp_path), device="cpu")
    assert long._resolve_chunk(headless=True) == 16


def test_pipeline_profile_trace(tmp_path):
    """--profile writes a torch.profiler Chrome trace that holds the
    odometry's stage spans."""
    trace_dir = tmp_path / "trace"
    pipeline = OdometryPipeline(_dataset(2), config=_small_config(tmp_path),
                                profile_dir=trace_dir, device="cpu")
    pipeline.run()
    trace = json.loads((trace_dir / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "kiss/align" in names and "kiss/map_insert" in names


def test_pipeline_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OdometryPipeline(_dataset(2), config=_small_config(tmp_path))


def test_cli_validation_and_version(tmp_path, capsys):
    assert cmd.main([]) == 2
    assert cmd.main([str(tmp_path), "--dataloader", "kitti"]) == 2  # no --sequence
    assert cmd.main([str(tmp_path), "--dataloader", "rosbag", "--jump", "5"]) == 2
    assert cmd.main([str(tmp_path / "missing")]) == 1  # generic: no scans
    with pytest.raises(SystemExit) as exc:
        cmd.main(["--version"])
    assert exc.value.code == 0
    assert "kiss_icp_tpu_torch" in capsys.readouterr().out
    # --visualize on an empty directory: both CLIs fail on the data first.
    assert cmd.main([str(tmp_path), "--visualize"]) == \
        jcmd.main([str(tmp_path), "--visualize"]) == 1
    # A family with no data in the directory: both CLIs report it and exit 1.
    assert cmd.main([str(tmp_path), "--dataloader", "nclt"]) == \
        jcmd.main([str(tmp_path), "--dataloader", "nclt"]) == 1
    # Same flags as the JAX CLI, plus --device.
    ours = {a.dest for a in cmd._build_parser()._actions}
    theirs = {a.dest for a in jcmd._build_parser()._actions}
    assert ours - theirs == {"device"} and theirs <= ours


def test_cli_full_run_on_generic_dir(tmp_path, monkeypatch):
    """The CLI over a directory of .bin scans with --device cpu writes the
    result files; its poses equal the JAX CLI's on the same data."""
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
        "engine": {"max_points_per_frame": 4096, "frame_capacity": 4096,
                   "source_capacity": 1024, "map_capacity_log2": 15},
        "registration": {"max_num_iterations": 20},
    }
    poses = {}
    monkeypatch.chdir(tmp_path)
    for name, main, extra in (("port", cmd.main, ["--device", "cpu"]), ("jax", jcmd.main, [])):
        out = tmp_path / f"results_{name}"
        cfg_file = tmp_path / f"{name}.yml"
        cfg_file.write_text(yaml.safe_dump(dict(cfg, out_dir=str(out))))
        assert main([str(data), "--config", str(cfg_file), *extra]) == 0
        assert (out / "latest").exists()
        assert np.loadtxt(out / "latest" / "scans_kitti.txt").shape == (3, 12)
        poses[name] = np.load(out / "latest" / "scans_poses.npy")
    np.testing.assert_allclose(poses["port"], poses["jax"], atol=1e-4)


def test_dump_config(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cmd.dump_config() == 0
    written = yaml.safe_load((tmp_path / "kiss_icp_tpu_torch.yml").read_text())
    assert written == config_to_dict(load_config(None))
    assert written["mapping"]["voxel_size"] == 1.0


def _trajectory(rng, n):
    """A random 3D walk with small rotations, ~1 m a step."""
    from scipy.spatial.transform import Rotation

    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(1, n):
        step = np.eye(4)
        step[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.02, 3)).as_matrix()
        step[:3, 3] = [1.0, 0.0, 0.0] + rng.normal(0, 0.05, 3)
        poses[i] = poses[i - 1] @ step
    return poses


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    gt, est = _trajectory(rng, 320), _trajectory(rng, 320)
    assert metrics.seq_error(gt, est) == jmetrics.seq_error(gt, est)
    assert metrics.seq_error_stats(gt, est)[2] > 0  # segments were evaluated
    assert metrics.absolute_trajectory_error(gt, est) == \
        jmetrics.absolute_trajectory_error(gt, est)
    empty = np.zeros((0, 4, 4))
    assert metrics.absolute_trajectory_error(empty, empty) == (0.0, 0.0)


def test_golden_cli_drive_matches_verify_config():
    """chip_smoke.py's cli phase holds the card against this golden; it is
    only valid for the configuration the phase runs."""
    golden = json.loads(GOLDEN.read_text())
    assert golden["config"] == config_to_dict(verify_drive_config())
    n = golden["frames"]
    assert n >= 60 and golden["dataloader"] == "synthetic" and golden["sequence"] == 0
    assert len(golden["poses"]) == len(golden["iterations"]) == n
    assert all(len(p) == 12 for p in golden["poses"])
    assert golden["ate_margin"] == max(0.02, 2 * abs(golden["ate_port_cpu"] - golden["ate_jax"]))
    assert golden["frame_tol"] == max(1e-3, 2 * max(golden["port_cpu_translation_diff"][:12]))
    assert abs(sum(golden["port_cpu_iterations"]) - sum(golden["iterations"])) <= \
        0.05 * sum(golden["iterations"])
