"""Multi-process runs of the port (kiss_icp_tpu_torch.parallel.multihost and
the grid of parallel/grid.py), on the CPU.

The counterparts of tests/test_multihost.py (the environment contract, the
single-process runner), then two real two-process launches over gloo
(tests/torch_multihost_worker.py), each with its own 30 s timeout; a rank
that fails or hangs fails its test:

  * the batched runner over 2 ranks (2 x 1, then 1 x 2 "pts") against one
    process's BatchedOdometry within 1e-5 m (tests/test_multihost_2proc.py:73)
    and against JAX's runner within 1e-4 m;
  * a map-sharded drive (engine.map_shards = 4) as 2 ranks x 2 local shards,
    with a cross-shard re-base and a checkpoint: poses, iterations,
    occupancy and the checkpoint bit-identical to the drive as 1 x 4 in one
    process (the reductions keep their index order), and its first frames
    within 1e-4 m of JAX's sharded engine.
The JAX references run here, in the parent.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_multihost_worker as w
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.odometry import create_odometry as jax_create_odometry
from kiss_icp_tpu.parallel import multihost as jmultihost
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.io import checkpoint
from kiss_icp_tpu_torch.parallel import multihost
from kiss_icp_tpu_torch.parallel.batch import BatchedOdometry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
RANK_TIMEOUT_S = 30


def test_spec_from_env_defaults():
    spec = multihost.spec_from_env({})
    assert spec == multihost.MultihostSpec(None, 1, 0)
    assert not spec.is_multiprocess
    assert jmultihost.spec_from_env({}).num_processes == spec.num_processes


def test_spec_from_env_multiprocess():
    env = {"KISS_COORDINATOR": "10.0.0.1:8476", "KISS_NUM_PROCESSES": "4",
           "KISS_PROCESS_ID": "2"}
    spec = multihost.spec_from_env(env)
    assert spec.is_multiprocess
    assert spec.coordinator == "10.0.0.1:8476" and spec.process_id == 2
    j = jmultihost.spec_from_env(env)
    assert (spec.coordinator, spec.num_processes, spec.process_id) == \
        (j.coordinator, j.num_processes, j.process_id)


def test_initialize_requires_coordinator_and_a_named_backend(monkeypatch):
    with pytest.raises(ValueError, match="KISS_COORDINATOR"):
        multihost.initialize_from_env({"KISS_NUM_PROCESSES": "2"})
    env = {"KISS_NUM_PROCESSES": "2", "KISS_COORDINATOR": "127.0.0.1:1"}
    with pytest.raises(ValueError, match="gloo or nccl"):
        multihost.initialize_from_env(dict(env, KISS_DIST_BACKEND="mpi"))
    # NCCL takes one card a rank: rank 1 on a machine of one card raises
    # before it joins anything.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card a rank"):
        multihost.initialize_from_env(dict(env, KISS_DIST_BACKEND="nccl",
                                           KISS_PROCESS_ID="1"))


def test_initialize_single_process_is_noop():
    spec = multihost.initialize_from_env({})
    assert not spec.is_multiprocess
    assert not torch.distributed.is_initialized()


def test_singleprocess_batched_matches_plain_batched():
    """The runner in one process equals the plain batched path (and JAX's
    runner at the batched tolerance)."""
    cfg, jcfg = w.batched_config(), w.batched_config(JaxConfig)
    b = 8
    rng = np.random.default_rng(3)
    scans = [rng.uniform(-30, 30, (512, 3)).astype(np.float32) for _ in range(b)]
    mh = multihost.MultihostBatchedOdometry(cfg, global_batch=b, device="cpu")
    assert mh.local_batch == b
    plain = BatchedOdometry(cfg, batch=b, device="cpu")
    jmh = jmultihost.MultihostBatchedOdometry(jcfg, global_batch=b)
    for shift in (0.0, 0.3):
        frames = [s + np.array([shift, 0, 0], np.float32) for s in scans]
        poses_mh = mh.register_frames(frames)
        poses_plain = plain.register_frames(frames)
        poses_jax = jmh.register_frames(frames)
    assert poses_mh.shape == (b, 4, 4) and np.all(np.isfinite(poses_mh))
    np.testing.assert_array_equal(poses_mh, poses_plain)
    np.testing.assert_allclose(poses_mh, poses_jax, atol=1e-4)


def test_launch_info_runs():
    info = multihost.launch_info()
    assert "process 0/1" in info and info.split(",")[0] == jmultihost.launch_info().split(",")[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(mode, out):
    """Both ranks of the worker; fails on a rank's non-zero exit or on
    RANK_TIMEOUT_S (every rank is killed then)."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, KISS_COORDINATOR=f"127.0.0.1:{port}", KISS_NUM_PROCESSES="2",
                   KISS_PROCESS_ID=str(pid), KISS_DIST_BACKEND="gloo",
                   KISS_DIST_TIMEOUT=str(RANK_TIMEOUT_S), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, mode, str(out)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    deadline = time.monotonic() + RANK_TIMEOUT_S
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


def test_two_process_batched_matches_one_process(tmp_path):
    got = _launch("batched", tmp_path / "batched.npz")
    cfg = w.batched_config()
    one = BatchedOdometry(cfg, batch=w.GLOBAL_BATCH, device="cpu")
    jmh = jmultihost.MultihostBatchedOdometry(w.batched_config(JaxConfig),
                                              global_batch=w.GLOBAL_BATCH)
    for frames in w.global_frames():
        ref = one.register_frames(frames)
        jref = jmh.register_frames(frames)
    for key in ("poses", "poses_pts"):
        assert got[key].shape == (w.GLOBAL_BATCH, 4, 4)
        np.testing.assert_allclose(got[key], ref, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(got[key], jref, atol=1e-4, err_msg=key)


def test_two_rank_sharded_drive_bit_identical_to_one_process(tmp_path):
    got = _launch("sharded", tmp_path / "sharded.npz")
    icp = odometry.create_odometry(w.sharded_config(), device="cpu")
    assert icp.mesh.axis("map").ranks == 1
    poses, iters = w.sharded_drive(icp, str(tmp_path / "one.ckpt.npz"))
    np.testing.assert_array_equal(got["poses"], poses)
    np.testing.assert_array_equal(got["iters"], iters)
    np.testing.assert_array_equal(got["occupancy"], icp.shard_occupancy())
    cfg = w.sharded_config()
    with np.load(tmp_path / "one.ckpt.npz") as a, \
            np.load(str(tmp_path / "sharded.npz") + ".ckpt.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert checkpoint.load_checkpoint(tmp_path / "one.ckpt.npz", cfg, "cpu").pose.shape == (4, 4)
    # The frames before the re-base against JAX's sharded engine.
    jicp = jax_create_odometry(w.sharded_config(JaxConfig))
    for i, f in enumerate(w.sharded_scans()[:3]):
        jicp.register_frame_lazy(f)
        np.testing.assert_allclose(poses[i], jicp.last_pose, atol=1e-4)


def test_scaling_bench_one_process_on_the_cpu(tmp_path):
    """tools/scaling_bench.py with one process (no process group) on the
    CPU: the JSON schema of the JAX tool, the launch note, the rank line,
    poses equal to one BatchedOdometry of the same frames; the numbers
    themselves are host timings and are not asserted."""
    from kiss_icp_tpu_torch.tools import scaling_bench

    out = tmp_path / "scaling.json"
    proc = subprocess.run(
        [sys.executable, "-m", "kiss_icp_tpu_torch.tools.scaling_bench", "--devices", "1",
         "--batch", "2", "--frames", "2", "--device", "cpu", "--timeout", "120",
         "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "rank 0/1: device cpu" in proc.stderr
    summary = __import__("json").loads(out.read_text())
    assert set(summary) >= {"note", "physical_cores", "rows"} and "NOT" in summary["note"]
    (row,) = summary["rows"]
    assert {"devices", "batch", "frames", "seq_frames_per_s", "compile_s", "program",
            "final_translations", "vs_1dev"} <= set(row)
    assert (row["devices"], row["batch"], row["frames"], row["vs_1dev"]) == (1, 2, 2, 1.0)
    cfg = scaling_bench._child_config()
    frames = scaling_bench._frames(2, 2, cfg.engine.max_points_per_frame)
    bo = BatchedOdometry(cfg, 2, device="cpu")
    for j in range(2):
        ref = bo.register_frames(list(frames[j]))
    np.testing.assert_array_equal(np.asarray(row["final_translations"]), ref[:, :3, 3])
