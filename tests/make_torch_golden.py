"""Make the JAX golden of chip_smoke.py's `cli` phase.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_torch_golden.py [--frames 100]

Runs the JAX package (use_pallas off) and the port's plain path (device
"cpu"), both on the CPU, over the first N scans of synthetic sequence 0 at
full width (64 x 1024 beams, deskew on: the data of the CLI's `--dataloader
synthetic --sequence 0`) with `kiss_icp_tpu_torch.tools.profile_drive.
verify_drive_config()`, each through its chunked driver in chunks of 16 (the
CLI's auto chunk), and writes `kiss_icp_tpu_torch/tools/golden_cli_drive.json`:

  config            the configuration, as `config_to_dict` gives it
  poses             JAX's world poses, the top 3 x 4 of each, row-major
  iterations        JAX's GN iterations per frame
  ate_jax           JAX's ATE against the ground truth (m)
  ate_port_cpu      the port's ATE on the CPU (m)
  ate_margin        max(0.02, 2 |ate_port_cpu - ate_jax|): the spread of two
                    faithful implementations, which the card's ATE must keep
  port_cpu_iterations, port_cpu_translation_diff (m, per frame),
  port_cpu_max_pose_diff    the port's CPU run beside JAX's
  frame_tol         max(1e-3, 2 x the port's largest CPU departure from JAX
                    over frames 1-12), which the card's frames 1-12 must keep:
                    two faithful implementations part by more than 1e-3 m
                    there, because a GN convergence check that 1e-6 m of
                    rounding flips adds an iteration and the drive amplifies it

Rerun it whenever `verify_drive_config()` changes: tests/test_torch_pipeline.py
fails until the golden's config matches it.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from kiss_icp_tpu import metrics as jmetrics
from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import config_from_dict as jax_config_from_dict
from kiss_icp_tpu_torch import metrics, odometry
from kiss_icp_tpu_torch.config.schema import config_to_dict
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.tools.profile_drive import verify_drive_config

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "kiss_icp_tpu_torch" / "tools" / "golden_cli_drive.json"
CHUNK = 16


def drive(icp, scans, label):
    poses, iters = [], []
    t0 = time.perf_counter()
    for a in range(0, len(scans), CHUNK):
        part = scans[a:a + CHUNK]
        poses.extend(icp.register_frames_chunked([s[0] for s in part], [s[1] for s in part]))
        iters.extend(int(x) for x in np.asarray(icp.last_chunk_summary.num_iterations))
        print(f"{label}: {a + len(part)} frames, {time.perf_counter() - t0:.0f} s", flush=True)
    return np.asarray(poses), iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=100)
    args = ap.parse_args(argv)

    cfg = verify_drive_config()
    jcfg = jax_config_from_dict(config_to_dict(cfg))
    jcfg.engine.use_pallas = False
    ds = SyntheticDataset(sequence=0)  # what the CLI's factory builds
    scans = [ds[i] for i in range(args.frames)]
    gt = ds.gt_poses[:args.frames]

    jposes, jiters = drive(jodo.KissICP(jcfg), scans, "jax")
    torch.set_num_threads(4)
    pposes, piters = drive(odometry.KissICP(cfg, device="cpu"), scans, "port-cpu")

    ate_jax = jmetrics.absolute_trajectory_error(gt, jposes)[1]
    ate_port = metrics.absolute_trajectory_error(gt, pposes)[1]
    golden = {
        "frames": args.frames,
        "dataloader": "synthetic",
        "sequence": 0,
        "chunk": CHUNK,
        "config": config_to_dict(cfg),
        "poses": [[float(x) for x in p[:3].ravel()] for p in jposes],
        "iterations": jiters,
        "ate_jax": float(ate_jax),
        "ate_port_cpu": float(ate_port),
        "ate_margin": max(0.02, 2.0 * abs(float(ate_port) - float(ate_jax))),
        "port_cpu_iterations": piters,
        "port_cpu_translation_diff": [
            float(x) for x in np.linalg.norm(pposes[:, :3, 3] - jposes[:, :3, 3], axis=1)],
        "port_cpu_max_pose_diff": float(np.abs(pposes - jposes).max()),
    }
    golden["frame_tol"] = max(1e-3, 2.0 * max(golden["port_cpu_translation_diff"][:12]))
    GOLDEN.write_text(json.dumps(golden, indent=1) + "\n")
    print(json.dumps({k: v for k, v in golden.items()
                      if k not in ("poses", "config", "iterations", "port_cpu_iterations",
                                   "port_cpu_translation_diff")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
