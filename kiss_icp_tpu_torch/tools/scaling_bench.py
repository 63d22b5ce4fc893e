"""Scaling curve of the multi-process batched runner (or the pod program).

Port of `kiss_icp_tpu/tools/scaling_bench.py`. B sequences of the same
synthetic frames run data-parallel over N processes for N in {1, 2, 4}
(`--devices`), each process a rank of a gloo process group
(parallel/multihost.py: KISS_COORDINATOR, KISS_NUM_PROCESSES,
KISS_PROCESS_ID) advancing its B / N sequences; the poses are gathered over
gloo on the host. By default the ranks run on the CUDA card; `--device cpu`
runs them on the CPU.

READ THE NUMBER CORRECTLY: all N processes share ONE device (and this
host's cores), so sequence-frames/s cannot improve with N. A FLAT curve
means the multi-process runner adds no overhead (no collective, no host
sync beyond the pose gather); it is NOT a hardware scaling measurement.

`--drive` feeds windows of the port's bench drive (tools/bench.py's
240-frame scan cache: real rendered scans, one 60-frame offset per
sequence, stride-subsampled to the child config's 4096 points) instead of
the random cloud, when that cache is warm; a cold cache runs the random
cloud, and the row says which (`"drive"`).

Each process count runs in fresh child processes (the process group is
fixed at start-up), under `--timeout` seconds; a child that fails or times
out fails the run (exit code 1). Output: one JSON line per run, with each
rank's device and kernel launches, and a summary JSON (also written to
`--out`), with the cross-run pose parity.

Usage:  python -m kiss_icp_tpu_torch.tools.scaling_bench [--out FILE]
        [--batch 8] [--frames 12] [--devices 1,2,4] [--pod] [--drive]
        [--device cuda|cpu] [--timeout 600]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

_CHILD_ENV = "KISS_SCALING_CHILD"
PARITY_BAND_M = 0.01


def _child_config():
    from kiss_icp_tpu_torch.config.schema import KISSConfig

    cfg = KISSConfig()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 4096
    cfg.engine.frame_capacity = 4096
    cfg.engine.source_capacity = 1024
    cfg.engine.map_capacity_log2 = 15
    cfg.engine.donate_state = False
    cfg.registration.max_num_iterations = 20
    return cfg


def _frames(b, k, n, seed=0):
    """(K, B, N, 3) scans: one random cloud, each sequence at its own
    velocity (the JAX tool's frames)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    pts = np.zeros((k, b, n, 3), np.float32)
    for i in range(b):
        vel = np.array([0.25 + 0.05 * i, 0.02 * i, 0], np.float32)
        for j in range(k):
            pts[j, i] = base + vel * j
    return pts


def _drive_frames(b, k, n):
    """(K, B, n, 3) points, (K, B, n) stamps and valid flags: windows of the
    bench's cached 240-frame drive, sequence i from frame 60 i, each scan
    stride-subsampled to n points (the JAX tool's windows). None when that
    cache is cold."""
    from kiss_icp_tpu_torch.odometry import subsample_to_capacity
    from kiss_icp_tpu_torch.tools import bench

    if not bench._scan_cache_ready(bench._config(), 240):
        return None
    _, cpts, cts, cvalid = bench._scans(bench._config(), 240)
    pts = np.zeros((k, b, n, 3), np.float32)
    ts = np.zeros((k, b, n), np.float32)
    valid = np.zeros((k, b, n), bool)
    for i in range(b):
        o = (60 * i) % (cpts.shape[0] - k)
        for j in range(k):
            full = cpts[o + j][cvalid[o + j]]
            stamps = cts[o + j][cvalid[o + j]]
            f, t, _ = subsample_to_capacity(full, stamps, n)
            m = len(f)
            pts[j, i, :m] = f
            if t is not None and len(t) == m:
                ts[j, i, :m] = t
            valid[j, i, :m] = True
    return pts, ts, valid


def child(batch: int, k: int, use_pod: bool, device: str, use_drive: bool = False) -> dict:
    """One rank: drive the B sequences' K frames (this rank's share) once to
    warm up, then three times timed between barriers. Returns the row
    (rank 0's is the run's)."""
    import torch
    import torch.distributed as dist

    from kiss_icp_tpu_torch.kernels import linsys, nn27
    from kiss_icp_tpu_torch.parallel import multihost

    spec = multihost.initialize_from_env()
    n_proc, rank = spec.num_processes, spec.process_id
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_proc))
    cfg = _child_config()
    n = cfg.engine.max_points_per_frame
    drive = _drive_frames(batch, k, n) if use_drive else None
    if drive is None:
        pts = _frames(batch, k, n)
        frames = [[pts[j, i] for j in range(k)] for i in range(batch)]
        stamps = None
    else:
        pts, ts, valid = drive
        frames = [[pts[j, i][valid[j, i]] for j in range(k)] for i in range(batch)]
        stamps = [[ts[j, i][valid[j, i]] for j in range(k)] for i in range(batch)]
    lb = batch // n_proc
    mine = range(rank * lb, (rank + 1) * lb)

    if use_pod:
        from kiss_icp_tpu_torch.parallel import pod

        def run():
            po = pod.PodOdometry(cfg, batch, mesh=pod.make_pod_mesh(n_proc, 2, device))
            return po.register_chunks(frames, stamps)[:, -1]
    else:
        def run():
            mh = multihost.MultihostBatchedOdometry(cfg, batch, device=device)
            poses = None
            for j in range(k):
                poses = mh.register_frames(
                    [frames[i][j] for i in mine],
                    None if stamps is None else [stamps[i][j] for i in mine])
            return poses

    def barrier():
        if dist.is_initialized():
            dist.barrier()

    t0 = time.perf_counter()
    run()
    compile_s = time.perf_counter() - t0
    best, poses = 0.0, None
    for _ in range(3):
        barrier()
        linsys.build_linear_system.launches = 0
        nn27.query_nearest.launches = 0
        t0 = time.perf_counter()
        poses = run()
        barrier()
        best = max(best, batch * k / (time.perf_counter() - t0))
    launches = {"k1": linsys.build_linear_system.launches, "k2": nn27.query_nearest.launches}
    dev = torch.device(device if device != "cuda" else "cuda:0")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"rank {rank}/{n_proc}: device {dev} ({name}), {lb} sequences, launches K1 "
          f"{launches['k1']} / K2 {launches['k2']} in the last run", flush=True)
    row = {
        "devices": n_proc,
        "batch": batch,
        "frames": k,
        "seq_frames_per_s": best,
        "compile_s": compile_s,
        "program": "pod(seq,map)" if use_pod else "batched(seq)",
        "drive": drive is not None,
        "device": str(dev),
        "device_name": name,
        "launches_rank0": launches,
        "final_translations": np.asarray(poses, np.float64)[:, :3, 3].tolist(),
    }
    if dist.is_initialized():
        dist.destroy_process_group()
    return row


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(n: int, args) -> dict:
    """N child processes of one run; the row, or {"devices": n, "error": ...}
    when a child fails or outlives `args.timeout` (every child is killed)."""
    port = _free_port()
    cmd = [sys.executable, "-m", "kiss_icp_tpu_torch.tools.scaling_bench",
           "--batch", str(args.batch), "--frames", str(args.frames), "--device", args.device]
    if args.pod:
        cmd.append("--pod")
    if args.drive:
        cmd.append("--drive")
    procs = []
    for rank in range(n):
        env = dict(os.environ, **{_CHILD_ENV: str(n), "KISS_NUM_PROCESSES": str(n),
                                  "KISS_PROCESS_ID": str(rank), "KISS_DIST_BACKEND": "gloo",
                                  "KISS_COORDINATOR": f"127.0.0.1:{port}",
                                  "KISS_DIST_TIMEOUT": str(args.timeout)})
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + args.timeout
    outs, error = [], None
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(0.1, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        error = f"timeout after {args.timeout} s"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        stdout, stderr = out
        for ln in stdout.splitlines():
            if ln.startswith("rank "):
                print(ln, file=sys.stderr, flush=True)
        if p.returncode != 0 and error is None:
            error = f"rank {rank} rc={p.returncode}: {stderr[-2000:]}"
    if error is not None:
        print(f"devices={n}: FAILED {error}", file=sys.stderr, flush=True)
        return {"devices": n, "error": error}
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")]
    return json.loads(line[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write summary JSON here")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--devices", default="1,2,4",
                    help="process counts (the processes share one device)")
    ap.add_argument("--pod", action="store_true",
                    help="measure the composed (seq, map) pod program (map axis 2)")
    ap.add_argument("--drive", action="store_true",
                    help="windows of the bench's cached 240-frame drive (real scans) "
                         "instead of the random cloud, when that cache is warm")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a run's processes may take together")
    args = ap.parse_args(argv)

    if _CHILD_ENV in os.environ:
        out = child(args.batch, args.frames, args.pod, args.device, args.drive)
        if int(os.environ.get("KISS_PROCESS_ID", "0")) == 0:
            print(json.dumps(out), flush=True)
        return 0

    if args.device != "cpu":
        # Build the kernels here, once, so that the children never race on
        # the build directory.
        from kiss_icp_tpu_torch.kernels import _build

        _build.build_all()
    sizes = [int(s) for s in args.devices.split(",")]
    bad = [s for s in sizes if s < 1 or args.batch % s]
    if bad:
        print(f"batch {args.batch} does not split over {bad} processes", file=sys.stderr)
        return 2
    rows = []
    for n in sizes:
        row = run_processes(n, args)
        rows.append(row)
        if "error" not in row:
            print(json.dumps(row), flush=True)

    ok = [r for r in rows if "seq_frames_per_s" in r]
    summary = {
        "note": (
            f"all processes share one device ({args.device}) and this host's "
            f"cores (os.cpu_count()={os.cpu_count()}); a FLAT curve means the "
            "multi-process runner adds no overhead; it is NOT a hardware "
            "scaling measurement."
        ),
        "physical_cores": os.cpu_count(),
        "rows": rows,
    }
    if ok:
        smallest = min(ok, key=lambda r: r["devices"])
        key = f"vs_{smallest['devices']}dev"
        for r in ok:
            r[key] = r["seq_frames_per_s"] / smallest["seq_frames_per_s"]
    # Every run drove the same sequences: their final translations agree
    # whatever the process count (each rank's rows are its own).
    if len(ok) >= 2:
        ref = np.asarray(ok[0]["final_translations"])
        parity = max(float(np.max(np.abs(np.asarray(r["final_translations"]) - ref)))
                     for r in ok[1:])
        summary["parity_max_m"] = parity
        summary["parity_band_m"] = PARITY_BAND_M
        summary["parity_ok"] = bool(parity <= PARITY_BAND_M)
        print(f"cross-run pose parity: max |dt| = {parity:.2e} m (band {PARITY_BAND_M}) -> "
              f"{'OK' if summary['parity_ok'] else 'FAIL'}", file=sys.stderr)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    failed = len(ok) < len(rows) or not summary.get("parity_ok", True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
