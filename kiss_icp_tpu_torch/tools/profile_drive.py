"""Where a frame's time goes on the GPU: a profiled drive of the main path.

    python -m kiss_icp_tpu_torch.tools.profile_drive [--frames 12] [--profile 4]
                                                     [--trace DIR]

Drives the verify drive (synthetic 64 x 1024 LiDAR, sequence 0, the config
of `verify_drive_config`) through `KissICP.register_frame` on CUDA and
profiles the last `--profile` frames with torch.profiler. Prints, for those
frames: wall ms per frame (host clock; every frame ends in a device sync),
device busy ms per frame and the device's idle share; host and device ms of
each `kiss/` span (kiss_icp_tpu_torch/trace.py: the frame, its stages, its
loop trips and host reads), a nested span its own row, its time also inside
its parent's; the device
ops and the top-level host ops that take the most time, and each of the
port's own kernels. The last line is the same as JSON. With `--trace`, the chrome trace is written there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from kiss_icp_tpu_torch.config import load_config
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.odometry import KissICP


def verify_drive_config():
    """The benchmark drive's configuration: defaults (100 m range, 1 m
    voxels, deskew on) with min_range 1, 65536 points per scan, a 16384-point
    frame cloud, an 8192-point ICP source and a 2^19-slot map."""
    cfg = load_config(None)
    cfg.data.min_range = 1.0
    cfg.engine.max_points_per_frame = 65536
    cfg.engine.frame_capacity = 16384
    cfg.engine.source_capacity = 8192
    cfg.engine.map_capacity_log2 = 19
    return cfg


# The port's own kernels (csrc/), reported whether or not they make the top 10.
PORT_KERNELS = ("nn27_kernel", "linsys_kernel")


def breakdown(events, frames: int):
    """(device busy ms, {stage: {host_ms, device_ms}}, top device ops, top
    host ops, the port's kernels) per frame, from the profiler's event list. Device busy time is
    the sum of kernel, copy and fill durations on the card (one stream, so
    they do not overlap); GPU-side copies of the profiler spans are left out."""
    dev, host, stages = {}, {}, {}
    for e in events:
        us = e.time_range.elapsed_us()
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith("kiss/"):
                n, t = dev.get(e.name, (0, 0.0))
                dev[e.name] = (n + 1, t + us)
        elif e.name.startswith("kiss/"):
            st = stages.setdefault(e.name[5:], {"host_ms": 0.0, "device_ms": 0.0})
            st["host_ms"] += us / 1e3 / frames
            # device_time_total: the kernels this span's ops launched.
            st["device_ms"] += e.device_time_total / 1e3 / frames
        elif e.cpu_parent is None or e.cpu_parent.name.startswith("kiss/"):
            n, t = host.get(e.name, (0, 0.0))
            host[e.name] = (n + 1, t + us)

    def rows(items):
        return [{"name": k[:90], "calls_per_frame": n / frames,
                 "ms_per_frame": t / 1e3 / frames} for k, (n, t) in items]

    def top(d):
        return rows(sorted(d.items(), key=lambda kv: -kv[1][1])[:10])

    busy = sum(t for _, t in dev.values()) / 1e3 / frames
    ours = rows((k, v) for k, v in dev.items() if any(n in k for n in PORT_KERNELS))
    return busy, stages, top(dev), top(host), ours


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--profile", type=int, default=4,
                    help="profile the last N frames of the drive")
    ap.add_argument("--trace", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_drive: no CUDA device is available")

    ds = SyntheticDataset(sequence=0, n_scans=args.frames, speed=1.0, accel_frames=30)
    scans = [ds[i] for i in range(args.frames)]
    icp = KissICP(verify_drive_config())
    n_plain = args.frames - args.profile
    for pts, stamps in scans[:n_plain]:
        icp.register_frame(pts, stamps)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for pts, stamps in scans[n_plain:]:
            icp.register_frame(pts, stamps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.profile
    if args.trace is not None:
        args.trace.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace / "profile_drive.json"))

    device_ms, stages, top_dev, top_host, ours = breakdown(prof.events(), args.profile)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0]
    print(f"profile_drive: {args.profile} frames after {n_plain} on {smi}; "
          f"wall {wall_ms:.3f} ms/frame, device busy {device_ms:.3f} ms/frame, "
          f"idle share {1 - device_ms / wall_ms:.3f}")
    for stage, t in stages.items():
        print(f"  stage {stage:12s} host {t['host_ms']:8.3f} ms  device "
              f"{t['device_ms']:8.3f} ms per frame")
    for kind, rows in (("device", top_dev), ("host", top_host), ("kernel", ours)):
        for k in rows:
            print(f"  {kind} {k['ms_per_frame']:8.3f} ms/frame "
                  f"{k['calls_per_frame']:7.1f} calls  {k['name']}")
    print(json.dumps({"device": name, "card": smi, "frames": args.profile, "wall_ms": wall_ms,
                      "device_ms": device_ms, "idle_share": 1 - device_ms / wall_ms,
                      "iterations": int(icp.last_result.num_iterations),
                      "stages": stages, "top_device": top_dev, "top_host": top_host,
                      "port_kernels": ours}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
