"""A rank of the port's two-process gloo tests (tests/test_torch_multihost.py,
tests/test_torch_pod_2proc.py).

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
  unroll   `unroll_drive` (map_shards = 4 as 2 ranks x 2) at each
           engine.gn_unroll of argv[3] ("2,3,4"): poses_u<u>, iters_u<u>.
  pod      the pod program over a ("seq", "map") grid of 2 x 4, "seq" across
           the two ranks and each sequence's 4 shards in its rank
           (tests/pod_worker.py's layout and scans): one chunked step of the
           global (B, K) scans, each rank taking its own rows; the poses and
           iterations gathered over "seq".

Usage: python tests/torch_multihost_worker.py MODE OUT.npz [UNROLLS] (or
`launch` from a test, which starts both ranks).
"""

import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from kiss_icp_tpu_torch.config.schema import KISSConfig  # noqa: E402
from kiss_icp_tpu_torch.parallel import multihost  # noqa: E402

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(mode, out, timeout_s, unrolls=()):
    """Both ranks of this worker in `mode` (at each of `unrolls`, when
    given), from a test; fails on a rank's non-zero exit or on `timeout_s`
    (every rank is killed then). Returns what rank 0 wrote to `out`."""
    import numpy as np

    extra = [",".join(str(u) for u in unrolls)] if unrolls else []
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, KISS_COORDINATOR=f"127.0.0.1:{port}", KISS_NUM_PROCESSES="2",
                   KISS_PROCESS_ID=str(pid), KISS_DIST_BACKEND="gloo",
                   KISS_DIST_TIMEOUT=str(timeout_s), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), mode,
                                       str(out)] + extra, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(0.1, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed (rc={p.returncode}):\n{stdout}\n{stderr}"
        assert ": ok (process" in stdout
    return np.load(out)


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


def unroll_config(unroll, cls=KISSConfig):
    """tests/test_registration.py:148-159's config at map_shards = 4 and
    engine.gn_unroll = `unroll`."""
    cfg = cls()
    cfg.data.max_range = 30.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 4096
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 14
    cfg.engine.map_shards = SHARDS
    cfg.engine.gn_unroll = unroll
    return cfg


def unroll_drive(icp, k=4):
    """k frames of tests/test_registration.py's drive (16 x 256 beams), whose
    solves take 5-9 iterations. Returns (poses (k,4,4) f64, iterations)."""
    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset

    ds = SyntheticDataset(sequence=0, n_scans=k, n_beams=16, n_azimuth=256,
                          max_range=30.0, speed=1.0, accel_frames=3)
    poses, iters = [], []
    for i in range(k):
        icp.register_frame(*ds[i])
        poses.append(icp.last_pose)
        iters.append(int(icp.last_result.num_iterations))
    return np.stack(poses), np.asarray(iters)


POD_BATCH = 4  # tests/pod_worker.py: GLOBAL_BATCH, N_SEQ x N_MAP
POD_SEQ, POD_MAP = 2, 4


def pod_scans():
    """tests/pod_worker.py's `global_scans`: (B, K, N, 3), each sequence at
    its own velocity over one base cloud."""
    rng = np.random.default_rng(13)
    base = rng.uniform(-30, 30, (N_POINTS, 3)).astype(np.float32)
    pts = np.zeros((POD_BATCH, N_FRAMES, N_POINTS, 3), np.float32)
    for i in range(POD_BATCH):
        vel = np.array([0.2 + 0.08 * i, 0.02 * i, 0], np.float32)
        for j in range(N_FRAMES):
            pts[i, j] = base + vel * j
    return pts, np.zeros(pts.shape[:3], np.float32), np.ones(pts.shape[:3], bool)


def pod_run(device="cpu"):
    """One chunked pod step of `pod_scans` on a POD_SEQ x POD_MAP grid (over
    the process group's ranks when there is one). Returns the global poses
    (B, K, 4, 4) and iterations (B, K), gathered over "seq"."""
    from kiss_icp_tpu_torch.parallel import pod

    cfg = batched_config()  # tests/pod_worker.py's worker_config too
    mesh = pod.make_pod_mesh(POD_SEQ, POD_MAP, device=device)
    step = pod.make_pod_chunked_step(cfg, mesh)
    _, res = step(pod.init_pod_state(cfg, mesh, POD_BATCH), *pod_scans())
    seq = mesh.axis(pod.SEQ_AXIS)
    return seq.gather_host(res.pose).numpy(), seq.gather_host(res.num_iterations).numpy()


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
    elif mode == "unroll":
        from kiss_icp_tpu_torch import odometry

        arrays = {}
        for u in (int(x) for x in sys.argv[3].split(",")):
            icp = odometry.create_odometry(unroll_config(u), device="cpu")
            assert icp.mesh.axis("map").local == 2
            arrays[f"poses_u{u}"], arrays[f"iters_u{u}"] = unroll_drive(icp)
        if rank == 0:
            np.savez(out, **arrays)
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
    elif mode == "pod":
        poses, iters = pod_run()
        if rank == 0:
            np.savez(out, poses=poses, iters=iters)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    print(f"worker {rank}: ok ({multihost.launch_info()})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
