"""OdometryPipeline: dataset loop, timing, evaluation, result writing.

Equivalent of the reference driver (python/kiss_icp/pipeline.py:41-217): iterate
the dataset, time `register_frame`, collect poses, evaluate KITTI seq error +
ATE when GT is available, and write poses (.npy + KITTI text + TUM text),
config, and a metrics log into a timestamped results dir with a `latest`
symlink.

The port of the JAX package's `pipeline.py`. The first device call builds the
CUDA kernels (nvcc, a few seconds), so FPS statistics are reported both with
and without warmup frames; per-frame host timing brackets the device step
including the host->device transfer, matching what a user experiences. The
engine runs on `device` (None means CUDA, as every entry point of the port).
"""

from __future__ import annotations

import datetime
import os
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

from kiss_icp_tpu_torch import metrics as metrics_mod
from kiss_icp_tpu_torch.config.parser import load_config, write_config
from kiss_icp_tpu_torch.odometry import create_odometry
from kiss_icp_tpu_torch.tools.pipeline_results import PipelineResults
from kiss_icp_tpu_torch.tools.progress_bar import get_progress_bar
from kiss_icp_tpu_torch.tools.visualizer import StubVisualizer


class OdometryPipeline:
    def __init__(
        self,
        dataset,
        config: Optional[Path] = None,
        visualizer=None,
        *,
        max_range: Optional[float] = None,
        deskew: Optional[bool] = None,
        n_scans: int = -1,
        jump: int = 0,
        profile_dir: Optional[Path] = None,
        resume_from: Optional[Path] = None,
        save_checkpoint: bool = False,
        checkpoint_every: int = 0,
        device=None,
    ):
        self._dataset = dataset
        if isinstance(config, (str, Path, type(None))):
            self.config = load_config(config, max_range=max_range,
                                      deskew=deskew)
        else:
            self.config = config
            # The overrides apply on EVERY config path — silently ignoring
            # them for an instance argument would run under different
            # cropping/deskew than the caller asked for.
            if max_range is not None:
                self.config.data.max_range = float(max_range)
            if deskew is not None:
                self.config.data.deskew = bool(deskew)
        self.odometry = create_odometry(self.config, device=device)

        # Frame windowing (reference pipeline.py:50-56).
        if jump < 0 or jump > len(dataset):
            raise ValueError(
                f"--jump {jump} is outside the dataset (len {len(dataset)})")
        if n_scans < -1:
            raise ValueError(
                f"--n-scans {n_scans} is invalid (-1 = all, else >= 0)")
        self._n_scans = len(dataset) - jump if n_scans == -1 else min(len(dataset) - jump, n_scans)
        self._first = jump
        self._last = self._first + self._n_scans

        self.poses = np.zeros((self._n_scans, 4, 4))
        self.exec_times = np.zeros(self._n_scans)
        self.results = PipelineResults()
        self.total_dropped_downsample = 0
        self.total_dropped_map_voxels = 0
        self.total_dropped_input = 0
        self.total_dropped_oob = 0
        self._warned_overflow_downsample = False
        self._warned_overflow_map = False
        self._warned_overflow_input = False
        self._warned_overflow_oob = False

        if visualizer is None:
            visualizer = StubVisualizer()
        self.visualizer = visualizer

        self.gt_poses = getattr(dataset, "gt_poses", None)
        if self.gt_poses is not None:
            self.gt_poses = np.asarray(self.gt_poses)[self._first : self._last]
        self.dataset_name = type(dataset).__name__
        self.dataset_sequence = getattr(dataset, "sequence_id", Path(str(getattr(dataset, "data_dir", ""))).name)

        self._profile_dir = profile_dir
        self._save_checkpoint = save_checkpoint
        self._checkpoint_every = int(checkpoint_every)
        if resume_from is not None:
            # Exact resume: restores pose, motion model, adaptive threshold
            # and the local map (io/checkpoint.py); typically paired with
            # --jump to skip the frames already covered by the checkpoint.
            self.odometry.load_checkpoint(resume_from)

    # --- Public API ------------------------------------------------------
    def run(self) -> PipelineResults:
        if self._profile_dir is not None:
            # Host and device timeline (torch.profiler, with the port's kiss/*
            # spans: each frame, its stages, its loop trips and its host
            # reads; see trace.py) as a Chrome trace, viewable in Perfetto.
            # The spans are recorded only while this profiler runs. The
            # reference's only tracing is host wall-clock around
            # register_frame (pipeline.py:100-103).
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.odometry.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                self._run_pipeline()
            self._profile_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(self._profile_dir / "trace.json"))
        else:
            self._run_pipeline()
        self._run_evaluation()
        self._create_output_dir()
        self._write_result_poses()
        self._write_gt_poses()
        self._write_cfg()
        self._write_log()
        if self._save_checkpoint:
            self.odometry.save_checkpoint(self.results_dir / "checkpoint.npz")
        return self.results

    # --- Core loop (reference pipeline.py:97-113) ------------------------
    def _unpack(self, item):
        if isinstance(item, tuple):
            frame, timestamps = item
        else:
            frame, timestamps = item, np.array([])
        return np.asarray(frame), np.asarray(timestamps)

    def _run_pipeline(self):
        # Without a live visualizer, the big per-frame point outputs never
        # need to reach the host: only the 4x4 pose is read.
        headless = type(self.visualizer) is StubVisualizer
        chunk = self._effective_chunk = self._resolve_chunk(headless)
        if headless and chunk > 1:
            self._run_pipeline_chunked(chunk)
            return
        for idx in get_progress_bar(self._first, self._last, "Odometry"):
            frame, timestamps = self._unpack(self._dataset[idx])
            t0 = time.perf_counter_ns()
            self.odometry.register_frame_lazy(frame, timestamps)
            pose = self.odometry.last_pose  # waits for the step to finish
            t1 = time.perf_counter_ns()
            i = idx - self._first
            self.poses[i] = pose
            self.exec_times[i] = t1 - t0
            self._check_overflow(*self.odometry.last_overflow())
            # Rolling-origin envelope check: the pose was just materialized,
            # so the check is read-free (see odometry.KissICP.maybe_rebase).
            self.odometry.maybe_rebase(pose[:3, 3])
            self._maybe_checkpoint(i + 1)
            if not headless:
                self.visualizer.update(
                    self.odometry.last_frame(),
                    self.odometry.last_source(),
                    self.odometry,
                    pose,
                )

    def _resolve_chunk(self, headless: bool) -> int:
        """Effective frames per chunk. engine.pipeline_chunk = 0 (auto, the
        default) selects the chunked driver for headless runs, sized 16 but
        never beyond the sequence, as the JAX package does. A live
        visualizer always runs per-frame (it must see every frame's
        clouds), and pipeline_chunk = 1 forces streaming explicitly (the
        latency shape)."""
        chunk = int(getattr(self.config.engine, "pipeline_chunk", 0))
        if chunk <= 0:
            chunk = min(16, max(1, self._n_scans)) if headless else 1
        return chunk

    def _run_pipeline_chunked(self, chunk: int):
        """Advance the sequence `chunk` frames per call, in the JAX
        package's order: dispatch chunk i, pack chunk i+1, then read chunk
        i's poses. In JAX the packing overlaps the device's work on chunk i,
        because its dispatch is asynchronous. In the port, `dispatch_chunk`
        returns only after the host has issued all K frames (the GN loop
        reads one scalar per loop trip), so that overlap window is empty:
        packing runs after the device work, not beside it. The order is kept
        for when the chunk runs without host reads. Per-frame times are the
        chunk average of dispatch-to-dispatch wall, i.e. honest end-to-end
        throughput."""
        idx = self._first
        bar = get_progress_bar(0, self._n_scans, "Odometry (chunked)")
        done = 0

        def build(at: int):
            k = min(chunk, self._last - at)
            frames, stamps = [], []
            for j in range(k):
                f, t = self._unpack(self._dataset[at + j])
                frames.append(f)
                stamps.append(t)
            return self.odometry.build_chunk(frames, stamps)

        chunk_in, dropped = build(idx)
        t_prev = time.perf_counter_ns()
        while idx < self._last:
            k = chunk_in.num_frames
            i0 = idx - self._first
            summary = self.odometry.dispatch_chunk(chunk_in, dropped)
            in_drop = dropped
            idx += k
            # The JAX package's overlap window (empty here, see above).
            chunk_in, dropped = build(idx) if idx < self._last else (None, 0)
            # Read the chunk's poses (waits for the device).
            self.poses[i0 : i0 + k] = self.odometry.summary_poses(summary)
            t_now = time.perf_counter_ns()
            self.exec_times[i0 : i0 + k] = (t_now - t_prev) / k
            t_prev = t_now
            self._check_overflow(
                int(summary.num_dropped_downsample.sum()),
                int(summary.num_dropped_map_voxels.sum()),
                in_drop,
                int(summary.num_oob_points.sum()),
            )
            # Rolling-origin envelope check at the chunk boundary: the
            # chunk's poses are on the host and the next chunk is packed but
            # not yet dispatched.
            self.odometry.maybe_rebase(self.poses[i0 + k - 1, :3, 3])
            done += k
            self._maybe_checkpoint(done)
            try:
                bar.update(k)
            except AttributeError:
                pass
        try:
            bar.close()
        except AttributeError:
            pass

    def _check_overflow(self, dropped_downsample: int, dropped_map: int,
                        dropped_input: int = 0, dropped_oob: int = 0):
        """Surface silent capacity overflow: the reference's std::vector-backed
        structures are unbounded (VoxelHashMap.cpp:97-119); our fixed-shape
        buffers drop on overflow, which degrades accuracy and MUST be loud."""
        self.total_dropped_input += dropped_input
        if dropped_input and not self._warned_overflow_input:
            self._warned_overflow_input = True
            warnings.warn(
                f"input scan exceeded engine.max_points_per_frame: "
                f"{dropped_input} points stride-subsampled away this frame — "
                "raise engine.max_points_per_frame to keep the full scan "
                "(accuracy degrades silently otherwise)",
                RuntimeWarning,
                stacklevel=3,
            )
        self.total_dropped_downsample += dropped_downsample
        self.total_dropped_map_voxels += dropped_map
        if dropped_downsample and not self._warned_overflow_downsample:
            self._warned_overflow_downsample = True
            warnings.warn(
                f"voxel downsample dropped {dropped_downsample} voxels this "
                "frame: raise engine.frame_capacity / engine.source_capacity "
                "(accuracy degrades silently otherwise)",
                RuntimeWarning,
                stacklevel=3,
            )
        self.total_dropped_oob += dropped_oob
        if dropped_oob and not self._warned_overflow_oob:
            self._warned_overflow_oob = True
            warnings.warn(
                f"{dropped_oob} points fell outside the ±16383-voxel world "
                "envelope this frame — the drive outran the rolling-origin "
                "re-base. Enable/lower engine.rebase_trigger_voxels (0 "
                "disables auto-rebase) so the map follows the trajectory.",
                RuntimeWarning,
                stacklevel=3,
            )
        if dropped_map and not self._warned_overflow_map:
            self._warned_overflow_map = True
            warnings.warn(
                f"voxel map dropped {dropped_map} voxels this frame: "
                "raise engine.map_capacity_log2 / engine.probe_length — "
                "accuracy degrades silently otherwise. (With a compact "
                "nn_mode this can also mean the live-voxel view overflowed, "
                "counted as the JAX package counts it; the port queries the "
                "sparse map, so accuracy is unaffected; raise "
                "engine.nn_live_capacity_log2.)",
                RuntimeWarning,
                stacklevel=3,
            )

    # --- Evaluation (reference pipeline.py:171-192) -----------------------
    def _fps(self, skip_warmup: int = 0) -> float:
        times = self.exec_times[skip_warmup:]
        total = float(np.sum(times)) * 1e-9
        return float(len(times) / total) if total > 0 else 0.0

    def _run_evaluation(self):
        if self.gt_poses is not None and len(self.gt_poses) == len(self.poses):
            avg_tra, avg_rot = metrics_mod.seq_error(self.gt_poses, self.poses)
            ate_rot, ate_trans = metrics_mod.absolute_trajectory_error(
                self.gt_poses, self.poses
            )
            self.results.append(
                desc="Average Translation Error", units="%", value=avg_tra
            )
            self.results.append(
                desc="Average Rotational Error", units="deg/m", value=avg_rot
            )
            self.results.append(
                desc="Absolute Trajectory Error (ATE)", units="m", value=ate_trans
            )
            self.results.append(
                desc="Absolute Rotational Error (ARE)", units="rad", value=ate_rot
            )
        fps = self._fps()
        # "no warmup" must skip everything the first device call buried in
        # its timing bracket: the nvcc build of the kernels at first use
        # (and the CUDA context's first allocations). In chunked mode the
        # chunk average spreads it over the first CHUNK's frames, so the
        # whole first chunk is skipped, as the JAX package skips XLA
        # compilation.
        chunk = int(getattr(self, "_effective_chunk", 1))
        warm = 2 if chunk <= 1 else chunk
        fps_hot = self._fps(skip_warmup=min(warm, max(0, len(self.exec_times) - 1)))
        self.results.append(desc="Average Frequency", units="Hz", value=fps, trunc=True)
        self.results.append(
            desc="Average Runtime", units="ms", value=1000.0 / fps if fps > 0 else 0.0,
            trunc=True,
        )
        self.results.append(
            desc="Average Frequency (no warmup)", units="Hz", value=fps_hot, trunc=True
        )
        if self.total_dropped_downsample or self.total_dropped_map_voxels:
            self.results.append(
                desc="Dropped voxels (capacity overflow)", units="count",
                value=self.total_dropped_downsample + self.total_dropped_map_voxels,
            )
        if self.total_dropped_input:
            self.results.append(
                desc="Dropped input points (max_points_per_frame)", units="count",
                value=self.total_dropped_input,
            )
        if self.total_dropped_oob:
            self.results.append(
                desc="Dropped points (world envelope)", units="count",
                value=self.total_dropped_oob,
            )

    # --- Output writing (reference pipeline.py:115-169,194-217) -----------
    @staticmethod
    def save_poses_kitti_format(filename, poses: np.ndarray):
        kitti = np.asarray(poses)[:, :3].reshape(len(poses), -1)
        np.savetxt(f"{filename}_kitti.txt", kitti)

    @staticmethod
    def save_poses_tum_format(filename, poses: np.ndarray, timestamps=None):
        from scipy.spatial.transform import Rotation

        poses = np.asarray(poses)
        if timestamps is None:
            timestamps = np.arange(len(poses), dtype=np.float64)
        quats = Rotation.from_matrix(poses[:, :3, :3]).as_quat()  # x y z w
        with open(f"{filename}_tum.txt", "w") as f:
            for ts, pose, q in zip(timestamps, poses, quats):
                t = pose[:3, 3]
                f.write(
                    f"{float(ts)} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n"
                )

    def _calibrate(self, poses: np.ndarray) -> np.ndarray:
        if hasattr(self._dataset, "apply_calibration"):
            return self._dataset.apply_calibration(poses)
        return poses

    def _timestamps(self):
        if hasattr(self._dataset, "get_frames_timestamps"):
            try:
                return np.asarray(self._dataset.get_frames_timestamps()).ravel()[
                    self._first : self._last
                ]
            except Exception:
                return None
        return None

    def _write_result_poses(self):
        np.save(self.results_dir / f"{self.dataset_sequence}_poses.npy", self.poses)
        calibrated = self._calibrate(self.poses)
        stem = self.results_dir / str(self.dataset_sequence)
        self.save_poses_kitti_format(stem, calibrated)
        self.save_poses_tum_format(stem, calibrated, self._timestamps())

    def _write_gt_poses(self):
        if self.gt_poses is None:
            return
        np.save(self.results_dir / f"{self.dataset_sequence}_gt.npy", self.gt_poses)
        calibrated = self._calibrate(self.gt_poses)
        stem = self.results_dir / f"{self.dataset_sequence}_gt"
        self.save_poses_kitti_format(stem, calibrated)
        self.save_poses_tum_format(stem, calibrated, self._timestamps())

    def _write_cfg(self):
        write_config(self.config, self.results_dir / "config.yml")

    def _write_log(self):
        self.results.log_to_file(
            self.results_dir / "result_metrics.log",
            f"kiss_icp_tpu_torch results: {self.dataset_name} {self.dataset_sequence}",
        )

    def _maybe_checkpoint(self, frames_done: int):
        """Periodic crash-recovery checkpoint (atomic write; see
        io/checkpoint.py). Resume with --resume-from <ckpt> --jump <frames>.
        Threshold-based so chunked mode checkpoints at the first chunk
        boundary past each multiple."""
        n = self._checkpoint_every
        if n <= 0:
            return
        if not hasattr(self, "_next_ckpt"):
            self._next_ckpt = n
        if frames_done >= self._next_ckpt:
            self._create_output_dir()
            self.odometry.save_checkpoint(self.results_dir / "checkpoint.npz")
            while self._next_ckpt <= frames_done:
                self._next_ckpt += n

    def _create_output_dir(self):
        """results/<timestamp>/ with a `latest` symlink (pipeline.py:204-217).
        Idempotent: periodic checkpoints may need the dir before run-end."""
        if hasattr(self, "results_dir"):
            return
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        base = Path(self.config.out_dir).absolute()
        self.results_dir = base / stamp
        latest = base / "latest"
        self.results_dir.mkdir(parents=True, exist_ok=True)
        try:
            if latest.is_symlink() or latest.exists():
                latest.unlink()
            os.symlink(self.results_dir, latest)
        except OSError:
            pass

    def print_(self):
        self.results.print_()
