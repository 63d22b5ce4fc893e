"""The port's host tools against the JAX package's, on the CPU.

  * capacity_plan: the same measurements and plans from the same frames
    (tests/test_capacity_plan.py's cases), and the same CLI output.
  * eval: run_sequence and the metrics table over a short synthetic drive
    (tests/test_eval_harness.py), poses within 1e-4 of JAX's.
  * error_budget and op_breakdown: schema and arithmetic only, on a tiny
    drive. They report measured times, which these tests never compare
    with a bound or with each other.
"""

import json

import numpy as np
import pytest
import torch

from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.datasets.synthetic import SyntheticDataset as JaxSynthetic
from kiss_icp_tpu.tools import capacity_plan as jcp
from kiss_icp_tpu.tools import error_budget as jeb
from kiss_icp_tpu.tools import eval as jeval
from kiss_icp_tpu_torch.config.parser import load_config
from kiss_icp_tpu_torch.config.schema import KISSConfig, config_to_dict
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.tools import capacity_plan as cp
from kiss_icp_tpu_torch.tools import error_budget as eb
from kiss_icp_tpu_torch.tools import eval as peval
from kiss_icp_tpu_torch.tools import op_breakdown as ob

torch.set_num_threads(1)


# --- capacity_plan ----------------------------------------------------------

def test_measure_and_plan_match_jax():
    rng = np.random.default_rng(0)
    frames = [np.concatenate([rng.uniform(-60, 60, (3000, 3)),
                              [[np.nan, 1.0, 1.0], [0.2, 0.0, 0.0]]]) for _ in range(3)]
    for args in ((1.0, 1.0, 100.0), (0.5, 2.0, 50.0)):
        ours, theirs = cp.measure_frames(frames, *args), jcp.measure_frames(frames, *args)
        assert [vars(s) for s in ours] == [vars(s) for s in theirs]
    poses = [np.eye(4) for _ in frames]
    for i, p in enumerate(poses):
        p[:3, 3] = [3.0 * i, 0.5 * i, 0.0]
    assert cp.estimate_map_voxels(frames, poses, 1.0, 1.0, 100.0) == \
        jcp.estimate_map_voxels(frames, poses, 1.0, 1.0, 100.0)
    stats = [cp.FrameStats(raw=50000, cropped=40000, frame_ds=5000, source_ds=1300),
             cp.FrameStats(raw=48000, cropped=39000, frame_ds=4800, source_ds=1100)]
    jstats = [jcp.FrameStats(**vars(s)) for s in stats]
    for kw in (dict(headroom=1.5, map_voxels=60000, map_storage="u16"), dict(headroom=2.0)):
        assert cp.plan(stats, **kw).as_dict() == jcp.plan(jstats, **kw).as_dict()
    with pytest.raises(ValueError):
        cp.plan([])


def test_plan_for_dataset_matches_jax():
    kw = dict(sequence=1, n_scans=6, n_beams=32, n_azimuth=256, max_range=50.0)
    cfg, jcfg = KISSConfig(), JaxConfig()
    for c in (cfg, jcfg):
        c.data.max_range = 50.0
        c.data.min_range = 1.0
        c.mapping.voxel_size = 0.5
    ours = cp.plan_for_dataset(SyntheticDataset(**kw), cfg, samples=4)
    theirs = jcp.plan_for_dataset(JaxSynthetic(**kw), jcfg, samples=4)
    assert ours.as_dict() == theirs.as_dict()
    assert ours.map_capacity_log2 is not None and ours.stats["frames_sampled"] == 4


def test_capacity_cli_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    for i in range(3):
        pts = rng.uniform(-40, 40, size=(2000, 3)).astype(np.float32)
        np.hstack([pts, np.zeros((2000, 1), np.float32)]).tofile(tmp_path / f"{i:06d}.bin")
    argv = [str(tmp_path), "--dataloader", "generic", "--samples", "3", "--headroom", "2.0"]
    outs = []
    for tool in (cp, jcp):
        assert tool.main(argv) == 0
        captured = capsys.readouterr()
        outs.append((json.loads(captured.out), captured.err))
    assert outs[0] == outs[1]
    assert outs[0][0]["stats"]["frames_sampled"] == 3


# --- eval -------------------------------------------------------------------

def _eval_config(cls, tmp_path):
    cfg = cls()
    cfg.out_dir = str(tmp_path / "results")
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 4096
    cfg.engine.frame_capacity = 4096
    cfg.engine.source_capacity = 1024
    cfg.engine.map_capacity_log2 = 14
    cfg.registration.max_num_iterations = 15
    return cfg


def test_eval_run_sequence_and_table_match_jax(tmp_path):
    kw = dict(n_scans=4, n_beams=16, n_azimuth=128, max_range=50.0)
    ours, theirs = {}, {}
    for seq in (0, 1):
        peval.run_sequence(ours, lambda s: SyntheticDataset(sequence=s, **kw), seq,
                           config=_eval_config(KISSConfig, tmp_path / "port"), device="cpu")
        jeval.run_sequence(theirs, lambda s: JaxSynthetic(sequence=s, **kw), seq,
                           config=_eval_config(JaxConfig, tmp_path / "jax"))
    assert set(ours) == set(theirs) == {"0", "1"}
    for seq in ours:
        assert ours[seq]["poses"].shape == (4, 4, 4)
        np.testing.assert_allclose(ours[seq]["poses"], theirs[seq]["poses"], atol=1e-4)
        np.testing.assert_array_equal(ours[seq]["gt_poses"], theirs[seq]["gt_poses"])
        assert set(ours[seq]["metrics"]) == set(theirs[seq]["metrics"])
    table = peval.print_metrics_table(ours)
    assert table.splitlines()[0] == jeval.print_metrics_table(theirs).splitlines()[0]
    assert "| **avg** |" in table and "| 0 |" in table and "| 1 |" in table
    assert peval.print_metrics_table({}) == "(no results)"


def test_eval_main_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _eval_config(KISSConfig, tmp_path)
    from kiss_icp_tpu_torch.config.parser import write_config

    write_config(cfg, tmp_path / "cfg.yml")
    rc = peval.main(["--dataloader", "synthetic", "--sequences", "0", "--n-scans", "2",
                     "--config", str(tmp_path / "cfg.yml"), "--device", "cpu"])
    assert rc == 0
    assert "| 0 |" in capsys.readouterr().out


# --- error_budget -----------------------------------------------------------

N_TINY, CHUNK_TINY, CAP = 10, 5, 4096


def _tiny_config(**overrides):
    cfg = load_config(None)
    cfg.data.max_range = 30.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = CAP
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 14
    for key, val in overrides.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, val)
    return cfg


@pytest.fixture(scope="module")
def tiny_scans():
    ds = SyntheticDataset(sequence=0, n_scans=N_TINY, n_beams=16, n_azimuth=256,
                          max_range=30.0, speed=0.6, accel_frames=4, distort=True)
    pts = np.zeros((N_TINY, CAP, 3), np.float32)
    ts = np.zeros((N_TINY, CAP), np.float32)
    valid = np.zeros((N_TINY, CAP), bool)
    for i in range(N_TINY):
        p, t = ds[i]
        n = min(len(p), CAP)
        pts[i, :n], ts[i, :n], valid[i, :n] = p[:n], t[:n], True
    return np.asarray(ds.gt_poses[:N_TINY], np.float64), pts, ts, valid


@pytest.fixture
def tiny_tool(monkeypatch):
    monkeypatch.setattr(eb, "N_FRAMES", N_TINY)
    monkeypatch.setattr(eb, "CHUNK", CHUNK_TINY)
    monkeypatch.setattr(eb, "_bench_config", _tiny_config)
    return eb


SCHEMA_KEYS = {"name", "kitti_seg_pct", "kitti_seg_deg_per_m", "n_segments", "ate_trans_m",
               "ate_rot_rad", "iters_p50", "iters_p95", "drops", "finite", "wall_s"}


def _shared(theirs: dict, ours: dict) -> dict:
    """`theirs` cut to the keys `ours` has (the JAX schema has a few more)."""
    return {k: _shared(v, ours[k]) if isinstance(v, dict) else v
            for k, v in theirs.items() if k in ours}


def test_error_budget_config_is_the_jax_fallback(monkeypatch):
    """The port's cell config equals the JAX tool's frozen fallback (what it
    uses without the repo-root harness), with and without overrides. That
    is the verify drive's config (tools/profile_drive.verify_drive_config)
    except nn_live_capacity_log2 (14 against 15), which only the compact
    modes read and no cell sets."""
    from kiss_icp_tpu_torch.tools.profile_drive import verify_drive_config

    monkeypatch.setattr(jeb, "_bench_module", lambda: None)
    for over in ({}, {"data.deskew": False, "engine.map_storage": "u16",
                      "mapping.max_points_per_voxel": 40}):
        ours = config_to_dict(eb._bench_config(**over))
        assert ours == _shared(config_to_dict(jeb._bench_config(**over)), ours)
    verify = config_to_dict(verify_drive_config())
    ours = config_to_dict(eb._bench_config())
    assert verify["engine"].pop("nn_live_capacity_log2") == 15
    assert ours["engine"].pop("nn_live_capacity_log2") == 14
    assert verify == ours
    assert eb.CELLS == jeb.CELLS


def test_error_budget_cell_schema_and_metrics(tiny_tool, tiny_scans):
    from kiss_icp_tpu_torch import metrics
    from kiss_icp_tpu_torch.odometry import init_state, make_chunked_step

    res = tiny_tool.run_cell("shipped", tiny_scans, {}, device="cpu")
    assert set(res) == SCHEMA_KEYS
    assert res["name"] == "shipped" and res["finite"] is True and res["drops"] == 0
    assert res["iters_p50"] <= res["iters_p95"] and res["n_segments"] == 0
    # The cell's numbers are the metrics module's on the same trajectory.
    gt, pts, ts, valid = tiny_scans
    cfg = _tiny_config()
    chunk, state, est = make_chunked_step(cfg), init_state(cfg, "cpu"), []
    for c in range(N_TINY // CHUNK_TINY):
        sl = slice(c * CHUNK_TINY, (c + 1) * CHUNK_TINY)
        state, summary = chunk(state, *(torch.from_numpy(a[sl]) for a in (pts, ts, valid)))
        est.append(summary.poses.double().numpy())
    ate_rot, ate_trans = metrics.absolute_trajectory_error(gt, np.concatenate(est))
    assert res["ate_trans_m"] == round(float(ate_trans), 4)
    assert res["ate_rot_rad"] == round(float(ate_rot), 5)
    off = tiny_tool.run_cell("deskew_off", tiny_scans, {"data.deskew": False}, device="cpu")
    assert off["ate_trans_m"] != res["ate_trans_m"]


def test_error_budget_main_table_and_json(tiny_tool, tiny_scans, tmp_path, capsys,
                                          monkeypatch):
    monkeypatch.setattr(eb, "_world_scans", lambda cap, **kw: tiny_scans)
    json_out, md_out = tmp_path / "cells.jsonl", tmp_path / "table.md"
    assert tiny_tool.main(["--cells", "shipped,u16", "--json-out", str(json_out),
                           "--out", str(md_out), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in json_out.read_text().splitlines()]
    assert [r["name"] for r in rows] == ["shipped", "u16"]
    table = capsys.readouterr().out
    assert md_out.read_text().strip() in table.strip()
    for r in rows:
        assert set(r) == SCHEMA_KEYS
        line = next(ln for ln in table.splitlines() if ln.startswith(f"| {r['name']} "))
        assert f"{r['kitti_seg_pct']:.3f}" in line and f"{r['ate_trans_m']:.3f}" in line
        assert f"{r['iters_p50']:.0f}/{r['iters_p95']:.0f}" in line


# --- op_breakdown -----------------------------------------------------------

def test_op_breakdown_schema_and_arithmetic():
    """The JAX tool's keys (tests/test_op_breakdown.py), the parts model's
    arithmetic, and the profiler's counts; no measured time is compared."""
    cfg = _tiny_config()
    res = ob.run_breakdown(cfg, ob._scans(cfg, 6), profile=3, device="cpu")
    for key in ("config", "device", "map_points", "mean_gn_iters_steady", "frame_fused_ms",
                "parts_us", "gn_total_us", "model_frame_ms", "model_vs_fused_pct",
                "shares_pct"):
        assert key in res, key
    parts = res["parts_us"]
    assert set(parts) == {"preprocess", "downsample_frame", "downsample_source", "nn_query",
                          "gn_iteration", "insert", "trim"}
    assert all(np.isfinite(v) and v >= 0 for v in parts.values())
    assert res["map_points"] > 0 and res["mean_gn_iters_steady"] > 0
    model_us = (parts["preprocess"] + parts["downsample_frame"] + parts["downsample_source"]
                + res["gn_total_us"] + parts["insert"] + parts["trim"])
    assert abs(model_us - res["model_frame_ms"] * 1e3) < 2.0
    # (gn_iteration is rounded to 0.1 us before it is multiplied.)
    assert abs(res["gn_total_us"] - res["mean_gn_iters_steady"] * parts["gn_iteration"]) \
        <= 0.05 * res["mean_gn_iters_steady"] + 0.1
    assert abs(sum(res["shares_pct"].values()) - 100.0) < 1.0
    # One K1 call an iteration, one K2 call more a frame (the final count).
    calls = res["operator_calls_per_frame"]
    assert calls["linsys"] == res["mean_gn_iters_steady"]
    assert calls["nn27"] == calls["linsys"] + 1
    assert res["kernels"] is None and res["idle_share"] is None
    assert "measured frame" in ob.render_table(res) and json.dumps(res)


def test_op_breakdown_soak_overrides_and_main(monkeypatch, capsys):
    assert ob._soak_overrides("soak") == {"engine.map_storage": "u16",
                                          "data.max_range": 70.0}
    assert ob._soak_overrides("headline") == {}
    monkeypatch.setattr(eb, "_bench_config", _tiny_config)
    assert ob.main(["--config", "headline", "--frames", "4", "--profile", "2",
                    "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert res["config"] == "headline" and res["n_frames"] == 4
