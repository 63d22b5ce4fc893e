"""Poses and iteration counts of the verify drive, to compare two trees.

    python kiss_icp_tpu_torch/tools/drive_poses.py --out A.json [--against B.json]

Drives the 12-frame verify drive (synthetic 64 x 1024 LiDAR, sequence 0,
the config of `verify_drive_config`) through `KissICP.register_frame` on
CUDA and writes each frame's pose, iteration count and translation error to
`--out` as JSON. With `--against`, also prints the largest difference of any
pose entry and of any translation against that file, and the frames whose
iteration counts differ.

Run by path, the script imports whichever `kiss_icp_tpu_torch` comes first
on the path, so `PYTHONPATH=<other checkout>` drives another tree's package
(for example the parent commit's) with the same drive.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.odometry import KissICP
from kiss_icp_tpu_torch.tools.profile_drive import verify_drive_config


def drive(frames: int) -> dict:
    ds = SyntheticDataset(sequence=0, n_scans=frames, speed=1.0, accel_frames=30)
    icp = KissICP(verify_drive_config())
    poses, iters = [], []
    for i in range(frames):
        icp.register_frame(*ds[i])
        poses.append(icp.last_pose)
        iters.append(int(icp.last_result.num_iterations))
    poses = np.stack(poses)
    err = np.linalg.norm(poses[:, :3, 3] - ds.gt_poses[:frames, :3, 3], axis=1)
    return {"poses": poses.tolist(), "iterations": iters, "errors_m": err.tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--against", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("drive_poses: no CUDA device is available")
    import kiss_icp_tpu_torch

    result = drive(args.frames)
    result["package"] = str(Path(kiss_icp_tpu_torch.__file__).parent)
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result))
    print(f"drive_poses: {result['package']} on {result['card']}: iterations "
          f"{result['iterations']}, max error {max(result['errors_m']):.6f} m")
    if args.against is not None:
        other = json.loads(args.against.read_text())
        a, b = np.array(result["poses"]), np.array(other["poses"])
        moved = [i for i, (x, y) in enumerate(zip(result["iterations"], other["iterations"]))
                 if x != y]
        print(f"drive_poses: against {args.against}: max |pose entry diff| "
              f"{np.abs(a - b).max():.3e}, max |translation diff| "
              f"{np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1).max():.3e} m, "
              f"iterations differ at frames {moved} "
              f"({[result['iterations'][i] for i in moved]} vs "
              f"{[other['iterations'][i] for i in moved]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
