"""A rank of the port's two-process gloo tests (tests/test_torch_multihost.py).

Launched with KISS_COORDINATOR / KISS_NUM_PROCESSES / KISS_PROCESS_ID set;
`multihost.initialize_from_env` joins the ranks into a gloo process group.
Every rank makes the same deterministic inputs and feeds its own share; rank
0 writes what the parent compares to an .npz (argv[2]). Modes (argv[1]):

  batched  MultihostBatchedOdometry over the ("seq", "pts") grid of the two
           ranks (2 x 1: each rank its own sequences), then over 1 x 2 (the
           same sequences on both ranks, each row's normal equations summed
           over the two ranks' blocks of its source); a CUDA-side payload on
           the gloo group raises.
  sharded  a map-sharded drive with engine.map_shards = 4 as 2 ranks x 2
           local shards: frames, a cross-shard re-base, more frames, a
           checkpoint (gathered from both ranks, written by rank 0).

Usage: python tests/torch_multihost_worker.py MODE OUT.npz
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kiss_icp_tpu_torch.config.schema import KISSConfig  # noqa: E402
from kiss_icp_tpu_torch.parallel import multihost  # noqa: E402

GLOBAL_BATCH = 8
N_POINTS = 512
N_FRAMES = 3
SHARDS = 4
REBASE_SHIFT = np.array([3, -2, 1], np.int32)


def batched_config(cls=KISSConfig):
    """tests/multihost_worker.py's config."""
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = N_POINTS
    cfg.engine.frame_capacity = N_POINTS
    cfg.engine.source_capacity = 256
    cfg.engine.map_capacity_log2 = 12
    cfg.engine.donate_state = False
    cfg.registration.max_num_iterations = 8
    return cfg


def global_frames():
    """N_FRAMES lists of GLOBAL_BATCH scans, the same in every process."""
    rng = np.random.default_rng(7)
    base = [rng.uniform(-30, 30, (N_POINTS, 3)).astype(np.float32)
            for _ in range(GLOBAL_BATCH)]
    shifts = [0.0, 0.25, 0.55]
    return [[s + np.array([shifts[f], 0.02 * i, 0], np.float32) for i, s in enumerate(base)]
            for f in range(N_FRAMES)]


def sharded_config(cls=KISSConfig):
    """tests/test_sharded_engine.py's config at map_shards = 4."""
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 2048
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 14
    cfg.engine.map_shards = SHARDS
    cfg.registration.max_num_iterations = 12
    return cfg


def sharded_scans(k=5, n=1800, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    return [base + np.array([0.3, 0.05, 0.0], np.float32) * i for i in range(k)]


def sharded_drive(icp, ckpt_path):
    """The drive both the ranks and the parent run: 3 frames, a re-base,
    2 frames, a checkpoint. Returns (poses (5,4,4) f64, iterations)."""
    scans = sharded_scans()
    poses, iters = [], []
    for i, f in enumerate(scans):
        if i == 3:
            icp._apply_rebase(REBASE_SHIFT)
        icp.register_frame_lazy(f)
        poses.append(icp.last_pose)
        iters.append(int(icp.last_result.num_iterations))
    icp.save_checkpoint(ckpt_path)
    return np.stack(poses), np.asarray(iters)


def main() -> int:
    torch.set_num_threads(1)
    mode, out = sys.argv[1], sys.argv[2]
    spec = multihost.initialize_from_env()
    assert spec.is_multiprocess and spec.num_processes == 2, spec
    rank = spec.process_id
    if mode == "batched":
        from kiss_icp_tpu_torch.parallel.batch import make_mesh

        cfg = batched_config()
        mh = multihost.MultihostBatchedOdometry(cfg, GLOBAL_BATCH, device="cpu")
        assert mh.mesh.shape == {"seq": 2, "pts": 1}, mh.mesh.shape
        lb = mh.local_batch
        assert lb == GLOBAL_BATCH // 2
        poses = None
        for frames in global_frames():
            poses = mh.register_frames(frames[rank * lb:(rank + 1) * lb])
        pts_mesh = make_mesh(2, pts_shards=2, device="cpu")
        assert pts_mesh.shape == {"seq": 1, "pts": 2}, pts_mesh.shape
        mh2 = multihost.MultihostBatchedOdometry(cfg, GLOBAL_BATCH, mesh=pts_mesh)
        assert mh2.local_batch == GLOBAL_BATCH
        poses_pts = None
        for frames in global_frames():
            poses_pts = mh2.register_frames(frames)
        try:
            mh.mesh.axis("seq").gather(torch.empty(1, device="meta"))
        except RuntimeError as e:
            assert "gloo" in str(e), e
        else:
            raise AssertionError("a non-CPU payload crossed the gloo group")
        if rank == 0:
            np.savez(out, poses=poses, poses_pts=poses_pts)
    elif mode == "sharded":
        from kiss_icp_tpu_torch import odometry

        icp = odometry.create_odometry(sharded_config(), device="cpu")
        ax = icp.mesh.axis("map")
        assert (ax.extent, ax.ranks, ax.local, ax.offset) == (SHARDS, 2, 2, 2 * rank), ax
        assert icp.state.total_points.shape == (2,)
        poses, iters = sharded_drive(icp, out + ".ckpt.npz")
        occupancy = icp.shard_occupancy()
        if rank == 0:
            np.savez(out, poses=poses, iters=iters, occupancy=occupancy)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    print(f"worker {rank}: ok ({multihost.launch_info()})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
