"""Per-stage decomposition of steady-state odometry frames, by measurement.

Port of the JAX package's `tools/op_breakdown.py`. The JAX tool times each
stage as its own XLA program; the port runs eagerly, so the stages are
measured where they run: a drive through `KissICP.register_frame` whose
last `profile` frames run under `torch.profiler`, which records the
`kiss/<stage>` spans of `odometry.register_frame` (host time, and the
device time of the kernels each span launched), the registered K1 and K2
operators (`kiss_icp_torch::linsys` / `::nn27`) and, on the card, the two
kernels' device time (as tools/profile_drive.py reads them):

    preprocess        span kiss/preprocess (deskew + range crop)
    downsample_frame  the frame's first kiss/downsample span (0.5 x voxel)
    downsample_source its second kiss/downsample span (1.5 x voxel)
    nn_query          one call of the K2 operator (host us)
    gn_iteration      span kiss/align per Gauss-Newton iteration
    insert, trim      spans kiss/map_insert, kiss/map_trim

Every part is host microseconds per frame (per call for nn_query, per
iteration for gn_iteration): the host issues the work and the device idles
most of a frame (`idle_share`). The parts model `preprocess +
downsample_frame + downsample_source + mean_iters * gn_iteration + insert +
trim` is compared with the measured frame (`frame_fused_ms`, the JAX key:
here the wall time of a whole `register_frame` under the profiler); the
residual is the wrapper's own work outside the spans. On the card a GN
loop trip after the first on a map replays a CUDA graph (ops/control.py),
which calls no operator on the host: `operator_calls_per_frame` counts the
host's calls (the final count's K2, a captured trip's), and `kernels` the
launches the card ran. The spans nested in
these (`kiss/gn_trip`, `kiss/sync/*`, ...) are rows of their own in
`parts_device_us` and add nothing to the parts. Times under the profiler
are slower than without it; compare parts with parts.

Usage:
    python -m kiss_icp_tpu_torch.tools.op_breakdown [--config soak|headline]
        [--frames N] [--profile P] [--device cpu] [--json-out F] [--out F]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _soak_overrides(kind: str) -> dict:
    if kind == "soak":
        return {"engine.map_storage": "u16", "data.max_range": 70.0}
    return {}


def _scans(cfg, n_frames):
    """n_frames scans of the synthetic drive at the config's scale."""
    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset

    cap = int(cfg.engine.max_points_per_frame)
    ds = SyntheticDataset(sequence=0, n_scans=n_frames,
                          n_beams=min(64, max(16, cap // 1024)),
                          n_azimuth=min(1024, max(256, cap // 64)),
                          max_range=float(cfg.data.max_range),
                          speed=1.0, accel_frames=min(30, n_frames // 2))
    return [ds[i] for i in range(n_frames)]


def run_breakdown(cfg, scans, profile: int = 4, device=None, config: str = "custom") -> dict:
    """Drive `scans` through KissICP on `device` (default CUDA), profile the
    last `profile` frames, and return the breakdown (JSON-serialisable;
    `config` names the configuration in it)."""
    import torch

    from kiss_icp_tpu_torch.odometry import KissICP
    from kiss_icp_tpu_torch.tools.profile_drive import breakdown

    icp = KissICP(cfg, device=device)
    cuda = icp.device.type == "cuda"
    n_plain = len(scans) - profile
    if n_plain < 1 or profile < 1:
        raise ValueError(f"{len(scans)} scans cannot warm up and profile {profile} frames")
    for pts, stamps in scans[:n_plain]:
        icp.register_frame(pts, stamps)
    if cuda:
        torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    iters = []
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for pts, stamps in scans[n_plain:]:
            icp.register_frame(pts, stamps)  # reads the frame's points: a sync
            iters.append(int(icp.last_result.num_iterations))
        wall_ms = (time.perf_counter() - t0) * 1e3 / profile
    events = prof.events()
    device_ms, stages, _, _, kernels = breakdown(events, profile)

    def host_us(name):
        return stages.get(name, {}).get("host_ms", 0.0) * 1e3

    # The two downsample spans of a frame, in the order they ran.
    ds = sorted((e for e in events if e.name == "kiss/downsample"),
                key=lambda e: e.time_range.start)
    ds_us = [sum(e.time_range.elapsed_us() for e in ds[i::2]) / profile for i in (0, 1)]
    ops = {name: [e.time_range.elapsed_us() for e in events
                  if e.name == f"kiss_icp_torch::{name}"] for name in ("nn27", "linsys")}
    mean_iters = float(np.mean(iters))
    total_iters = max(sum(iters), 1)
    parts = {
        "preprocess": host_us("preprocess"),
        "downsample_frame": ds_us[0],
        "downsample_source": ds_us[1],
        "nn_query": float(np.mean(ops["nn27"])) if ops["nn27"] else 0.0,
        "gn_iteration": host_us("align") * profile / total_iters,
        "insert": host_us("map_insert"),
        "trim": host_us("map_trim"),
    }
    gn_total = mean_iters * parts["gn_iteration"]
    model_us = (parts["preprocess"] + parts["downsample_frame"] + parts["downsample_source"]
                + gn_total + parts["insert"] + parts["trim"])
    res = {
        "config": config,
        "device": torch.cuda.get_device_name(icp.device) if cuda else "cpu",
        "n_frames": len(scans),
        "profiled_frames": profile,
        "map_points": int(icp.state.map.total_points),
        "mean_gn_iters_steady": round(mean_iters, 2),
        "frame_fused_ms": round(wall_ms, 4),
        "parts_us": {k: round(v, 1) for k, v in parts.items()},
        "parts_device_us": {k: round(st["device_ms"] * 1e3, 1) for k, st in stages.items()},
        "gn_total_us": round(gn_total, 1),
        "model_frame_ms": round(model_us / 1e3, 4),
        "model_vs_fused_pct": round(100.0 * model_us / (wall_ms * 1e3), 1),
        "shares_pct": {
            "gn_loop": round(100.0 * gn_total / model_us, 1),
            "preprocess": round(100.0 * parts["preprocess"] / model_us, 1),
            "downsample": round(100.0 * (parts["downsample_frame"]
                                         + parts["downsample_source"]) / model_us, 1),
            "insert_trim": round(100.0 * (parts["insert"] + parts["trim"]) / model_us, 1),
        },
        "operator_calls_per_frame": {k: len(v) / profile for k, v in ops.items()},
        "kernels": kernels if cuda else None,
        "idle_share": round(1.0 - device_ms / wall_ms, 4) if cuda else None,
    }
    return res


def render_table(res: dict) -> str:
    parts = res["parts_us"]
    model_us = res["model_frame_ms"] * 1e3
    lines = ["| op | us/frame | share of model |", "|---|---|---|"]
    rows = [
        ("preprocess", parts["preprocess"]),
        ("downsample 0.5v", parts["downsample_frame"]),
        ("downsample 1.5v", parts["downsample_source"]),
        (f"GN loop ({res['mean_gn_iters_steady']:.1f} it x "
         f"{parts['gn_iteration']:.0f} us; one NN query call {parts['nn_query']:.0f} us)",
         res["gn_total_us"]),
        ("insert", parts["insert"]),
        ("trim", parts["trim"]),
    ]
    for name, us in rows:
        lines.append(f"| {name} | {us:.0f} | {100.0 * us / model_us:.1f}% |")
    lines.append(f"| **parts model** | {model_us:.0f} | "
                 f"{res['model_vs_fused_pct']:.1f}% of the measured frame |")
    lines.append(f"| **measured frame** | {res['frame_fused_ms'] * 1e3:.0f} | 100% |")
    return "\n".join(lines)


def main(argv=None) -> int:
    from kiss_icp_tpu_torch.tools.error_budget import _bench_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="soak", choices=["soak", "headline"])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--profile", type=int, default=4,
                    help="profile the last N frames of the drive")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--out", default=None,
                    help="append the markdown table to this file")
    args = ap.parse_args(argv)

    cfg = _bench_config(**_soak_overrides(args.config))
    res = run_breakdown(cfg, _scans(cfg, args.frames), args.profile, args.device, args.config)
    table = render_table(res)
    print(table)
    print(json.dumps(res))
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(json.dumps(res) + "\n")
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n" + table + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
