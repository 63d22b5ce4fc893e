"""Accuracy error budget: one knob ablated at a time on one synthetic drive.

Port of the JAX package's `tools/error_budget.py`. It decomposes the long
drive's accuracy into attributable sources by changing one pipeline knob
(config ablations) or one property of the synthetic world (world ablations)
at a time on the same 240-frame drive, each cell run through the port's
`make_chunked_step`:

  config ablations: deskew_off, u16 map storage, iters_30, conv_3e-5,
    ppv_40, voxel_0.75, and the candidate fixes (refine_1, map_refine,
    range_70, ground_0.1 and their u16 combinations);
  world ablations: noise_free, no_dropout, no_distort.

Each cell reports the KITTI segment metric (Metrics.cpp:141-156 protocol),
Umeyama ATE, the iteration tail and the drops. Run:

    python -m kiss_icp_tpu_torch.tools.error_budget [--out FILE] [--device cpu]

Accuracy is deterministic per (world, config); the device only changes wall
time. Departures from the JAX tool:
  * The config is `_bench_config`: the JAX tool's frozen fallback
    (`kiss_icp_tpu/tools/error_budget.py`, `_bench_config` without the
    repo-root harness), built on the verify drive's config
    (`tools/profile_drive.verify_drive_config`), from which it differs only
    in nn_live_capacity_log2 (14 against 15: read by the compact modes,
    set by no cell); tests hold it to both. The port does not import the
    repo-root `bench.py`, which is the JAX harness.
  * No re-roll of slow first chunks: the JAX tool re-jits a perturbed
    program to draw a fresh compile on a remote TPU; the port compiles
    nothing, so there is nothing to re-draw.
  * The worlds are rendered in each run, with no cache on disk.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

N_FRAMES = 240
CHUNK = 24


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _world_scans(cap: int, **world_kw):
    """(gt (K,4,4) f64, points (K,cap,3) f32, stamps (K,cap), valid
    (K,cap)) of a (possibly ablated) synthetic drive of N_FRAMES frames."""
    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset

    kw = dict(sequence=0, n_scans=N_FRAMES, speed=1.0, accel_frames=30)
    kw.update(world_kw)
    ds = SyntheticDataset(**kw)
    pts = np.zeros((N_FRAMES, cap, 3), np.float32)
    ts = np.zeros((N_FRAMES, cap), np.float32)
    valid = np.zeros((N_FRAMES, cap), bool)
    t0 = time.perf_counter()
    for i in range(N_FRAMES):
        p, t = ds[i]
        n = min(len(p), cap)
        pts[i, :n] = p[:n]
        if len(t):
            ts[i, :n] = t[:n]
        valid[i, :n] = True
        if (i + 1) % 60 == 0:
            log(f"  world {world_kw or 'default'} frame {i + 1}/{N_FRAMES} "
                f"({time.perf_counter() - t0:.0f}s)")
    return np.asarray(ds.gt_poses[:N_FRAMES], np.float64), pts, ts, valid


def _bench_config(**overrides):
    """The drive's config with ablation overrides applied as dotted keys,
    e.g. {'data.deskew': False}."""
    from kiss_icp_tpu_torch.tools.profile_drive import verify_drive_config

    cfg = verify_drive_config()
    cfg.engine.map_storage = "f32"
    cfg.engine.probe_length = 16
    cfg.engine.nn_mode = "gather27"
    cfg.engine.nn_live_capacity_log2 = 14
    cfg.engine.donate_state = True
    cfg.engine.use_pallas = "auto"
    for key, val in overrides.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, val)
    return cfg


def run_cell(name: str, scans, overrides: dict, device=None) -> dict:
    """One ablation cell: the whole drive in chunks of CHUNK frames ->
    accuracy, iteration tail and drops (the JAX tool's keys)."""
    import torch

    from kiss_icp_tpu_torch import metrics
    from kiss_icp_tpu_torch.odometry import init_state, make_chunked_step, resolve_device

    gt, pts, ts, valid = scans
    cfg = _bench_config(**overrides)
    dev = resolve_device(device)
    chunk = make_chunked_step(cfg)
    state = init_state(cfg, dev)
    summaries = []
    t_run = time.perf_counter()
    for c in range(N_FRAMES // CHUNK):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        state, summary = chunk(state, *(torch.from_numpy(a[sl]).to(dev)
                                        for a in (pts, ts, valid)))
        summaries.append(summary)
    est = np.concatenate([s.poses.double().cpu().numpy() for s in summaries], axis=0)
    wall = time.perf_counter() - t_run

    iters = np.concatenate([s.num_iterations.cpu().numpy() for s in summaries])
    drops = int(sum(int(s.num_dropped_downsample.sum()) + int(s.num_dropped_map_voxels.sum())
                    for s in summaries))
    ate_rot, ate_trans = metrics.absolute_trajectory_error(gt, est)
    seg_t, seg_r, n_seg = metrics.seq_error_stats(gt, est)
    out = {
        "name": name,
        "kitti_seg_pct": round(float(seg_t), 4),
        "kitti_seg_deg_per_m": round(float(seg_r), 5),
        "n_segments": int(n_seg),
        "ate_trans_m": round(float(ate_trans), 4),
        "ate_rot_rad": round(float(ate_rot), 5),
        "iters_p50": float(np.percentile(iters, 50)),
        "iters_p95": float(np.percentile(iters, 95)),
        "drops": drops,
        "finite": bool(np.all(np.isfinite(est))),
        "wall_s": round(wall, 1),
    }
    log(f"[{name}] seg={out['kitti_seg_pct']}% ate={out['ate_trans_m']} m "
        f"iters p50/p95={out['iters_p50']:.0f}/{out['iters_p95']:.0f} "
        f"drops={drops} ({wall:.0f}s)")
    return out


# (cell name, world kwargs, config overrides): the JAX tool's cells.
CELLS = [
    ("shipped", {}, {}),
    ("deskew_off", {}, {"data.deskew": False}),
    ("u16", {}, {"engine.map_storage": "u16"}),
    ("iters_30", {}, {"registration.max_num_iterations": 30}),
    ("conv_3e-5", {}, {"registration.convergence_criterion": 3e-5}),
    ("ppv_40", {}, {"mapping.max_points_per_voxel": 40,
                    "engine.group_capacity": 32}),
    ("voxel_0.75", {}, {"mapping.voxel_size": 0.75}),
    ("noise_free", {"noise": 0.0}, {}),
    ("no_dropout", {"dropout": 0.0}, {}),
    ("no_distort", {"distort": False}, {}),
    ("refine_1", {}, {"engine.deskew_refine": 1}),
    ("u16_refine", {}, {"engine.deskew_refine": 1,
                        "engine.map_storage": "u16"}),
    ("map_refine", {}, {"engine.deskew_refine_map": True}),
    ("u16_map_refine", {}, {"engine.deskew_refine_map": True,
                            "engine.map_storage": "u16"}),
    ("range_70", {}, {"data.max_range": 70.0}),
    ("u16_range70", {}, {"engine.map_storage": "u16",
                         "data.max_range": 70.0}),
    ("u16_v075", {}, {"engine.map_storage": "u16",
                      "mapping.voxel_size": 0.75}),
    ("u16_range60", {}, {"engine.map_storage": "u16",
                         "data.max_range": 60.0}),
    ("u16_range80", {}, {"engine.map_storage": "u16",
                         "data.max_range": 80.0}),
    ("u16_range70_ground01", {}, {"engine.map_storage": "u16",
                                  "data.max_range": 70.0,
                                  "engine.ground_align": 0.1}),
    ("ground_0.1", {}, {"engine.ground_align": 0.1}),
]


def render_table(results) -> str:
    lines = ["| cell | seg trans % | seg rot deg/m | ATE m | iters p50/p95 | drops |",
             "|---|---|---|---|---|---|"]
    for r in results:
        lines.append(
            f"| {r['name']} | {r['kitti_seg_pct']:.3f} "
            f"| {r['kitti_seg_deg_per_m']:.5f} | {r['ate_trans_m']:.3f} "
            f"| {r['iters_p50']:.0f}/{r['iters_p95']:.0f} | {r['drops']} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    global N_FRAMES
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="append the markdown table to this file")
    ap.add_argument("--json-out", default=None,
                    help="write raw cell dicts as JSON lines")
    ap.add_argument("--cells", default=None,
                    help="comma-separated subset of cell names")
    ap.add_argument("--frames", type=int, default=None,
                    help=f"drive length (default {N_FRAMES})")
    ap.add_argument("--device", default="cuda",
                    help="Torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    if args.frames:
        N_FRAMES = int(args.frames)

    want = set(args.cells.split(",")) if args.cells else None
    cells = [c for c in CELLS if want is None or c[0] in want]
    cap = int(_bench_config().engine.max_points_per_frame)
    results = []
    for name, world_kw, overrides in cells:
        res = run_cell(name, _world_scans(cap, **world_kw), overrides, device=args.device)
        results.append(res)
        if args.json_out:
            with open(args.json_out, "a") as f:
                f.write(json.dumps(res) + "\n")
    table = render_table(results)
    print(table)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n" + table + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
