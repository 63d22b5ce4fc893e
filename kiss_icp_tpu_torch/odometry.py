"""KISS-ICP odometry: the per-frame orchestration.

Port of the core of `kiss_icp_tpu/odometry.py` (reference KissICP.cpp:35-68 /
kiss_icp.py:43-75): `register_frame(config, state, scan) -> (state, result)`
deskews, downsamples twice, registers against the local map with the
adaptive threshold, and updates the map. PyTorch runs eagerly, so the step is
plain Python over device tensors; the ICP loop and the map's claim rounds
read one scalar per iteration.

The map is updated IN PLACE (2^19 slots by default): the state passed to
`register_frame` shares its map tensors with the state it returns and must
not be used afterwards.

`KissICP` is the stateful wrapper (numpy in/out). Entry points run on the GPU
unless the caller asks for the CPU: `device=None` means CUDA and fails loudly
on a machine without a card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from kiss_icp_tpu_torch.config.schema import KISSConfig, check_supported
from kiss_icp_tpu_torch.ops import (hash_map, preprocess, registration, se3,
                                    threshold, voxel)


class OdometryState(NamedTuple):
    """Everything that evolves frame to frame (device tensors)."""

    pose: torch.Tensor  # (4, 4) float32 — world_T_body of the last scan
    delta: torch.Tensor  # (4, 4) float32 — body motion between the last two scans
    threshold: threshold.ThresholdState
    map: hash_map.VoxelMap


class FrameResult(NamedTuple):
    pose: torch.Tensor  # (4, 4)
    frame_points: torch.Tensor  # (N, 3) deskewed input scan (padded)
    frame_valid: torch.Tensor  # (N,)
    source_points: torch.Tensor  # (S, 3) ICP source / keypoints (padded, body frame)
    source_valid: torch.Tensor  # (S,)
    sigma: torch.Tensor  # () adaptive threshold used this frame
    num_iterations: int  # ICP iterations run
    num_correspondences: torch.Tensor  # () correspondences at convergence
    num_dropped_downsample: torch.Tensor  # () voxels lost to frame/source capacity
    num_dropped_map_voxels: torch.Tensor  # () new voxels lost to map probe overflow
    num_oob_points: torch.Tensor  # () points outside the world key envelope
    used_fallback: torch.Tensor  # () bool — non-finite registration, pose predicted


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. A CUDA device on a machine without one raises: the
    port never drops to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch path on the CPU")
    return dev


def map_config(config: KISSConfig) -> hash_map.MapConfig:
    """Static map parameters derived from the runtime config."""
    return hash_map.MapConfig(
        voxel_size=float(config.mapping.voxel_size),
        max_distance=float(config.data.max_range),
        max_points_per_voxel=int(config.mapping.max_points_per_voxel),
        capacity_log2=int(config.engine.map_capacity_log2),
        probe_length=int(config.engine.probe_length),
        group_capacity=int(config.engine.group_capacity),
        storage=str(config.engine.map_storage),
    )


def init_state(config: KISSConfig, device=None) -> OdometryState:
    """pose = delta = I, empty map, threshold seeded from initial_threshold
    (reference kiss_icp.py:34-41, Threshold.cpp:30-36)."""
    dev = resolve_device(device)
    return OdometryState(
        pose=se3.identity(device=dev),
        delta=se3.identity(device=dev),
        threshold=threshold.init_state(
            config.adaptive_threshold.initial_threshold, device=dev),
        map=hash_map.create_map(map_config(config), device=dev),
    )


def _sigma_for_frame(config: KISSConfig, state: OdometryState) -> torch.Tensor:
    """Adaptive sigma, or the fixed override when configured
    (reference threshold.py:29-43)."""
    fixed = config.adaptive_threshold.fixed_threshold
    if fixed is not None:
        return torch.tensor(float(fixed), dtype=torch.float32,
                            device=state.pose.device)
    return threshold.compute_threshold(state.threshold)


def register_frame(
    config: KISSConfig,
    state: OdometryState,
    points: torch.Tensor,
    timestamps: torch.Tensor,
    valid: torch.Tensor,
) -> Tuple[OdometryState, FrameResult]:
    """One odometry step (reference KissICP.cpp:35-68 / kiss_icp.py:43-75).

    points (N, 3) f32, timestamps (N,) f32, valid (N,) bool, on the state's
    device. The map is updated in place (see the module docstring). Each
    stage runs under a `kiss/<stage>` profiler span (tools/profile_drive.py
    reads them; without a profiler they cost a few microseconds a frame).
    """
    check_supported(config)
    mcfg = map_config(config)
    vsize = float(config.mapping.voxel_size)

    # 1.-5. Deskew with the constant-velocity model, crop, double voxel
    #    downsample, adaptive threshold, robust ICP from the constant-
    #    velocity initial guess.
    sigma = _sigma_for_frame(config, state)
    initial_guess = state.pose @ state.delta
    with record_function("kiss/preprocess"):
        prep = preprocess.preprocess(
            points, timestamps, valid, state.delta,
            max_range=float(config.data.max_range),
            min_range=float(config.data.min_range),
            deskew=bool(config.data.deskew),
        )
    with record_function("kiss/downsample"):
        frame_ds = voxel.voxel_downsample(
            prep.points, prep.valid, voxel_size=vsize * 0.5,
            capacity=int(config.engine.frame_capacity))
        source = voxel.voxel_downsample(
            frame_ds.points, frame_ds.valid, voxel_size=vsize * 1.5,
            capacity=int(config.engine.source_capacity))
    with record_function("kiss/align"):
        align = registration.align_points_to_map(
            mcfg, state.map, source.points, source.valid, initial_guess,
            3.0 * sigma, sigma,
            max_iterations=int(config.registration.max_num_iterations),
            convergence=float(config.registration.convergence_criterion),
            nn_mode=str(config.engine.nn_mode),
        )
    # Degraded-mode guard: a non-finite registration falls back to the
    # constant-velocity prediction; `used_fallback` surfaces it.
    pose_finite = torch.all(torch.isfinite(align.pose))
    new_pose = torch.where(pose_finite, align.pose, initial_guess)
    # Project the rotation back onto SO(3) every frame (se3.orthonormalize).
    new_pose = se3.orthonormalize(new_pose)

    # 6.-7. Model deviation feeds the threshold estimator.
    model_deviation = se3.inverse(initial_guess) @ new_pose
    new_threshold = threshold.update_model_deviation(
        state.threshold, model_deviation,
        max_range=float(config.data.max_range),
        min_motion_th=float(config.adaptive_threshold.min_motion_th),
    )

    # 8. Merge the scan into the local map, then trim far voxels
    #    (reference VoxelHashMap::Update, VoxelHashMap.cpp:83-95).
    with record_function("kiss/map_insert"):
        world_points = se3.transform(new_pose, frame_ds.points)
        new_map, insert_stats = hash_map.insert(mcfg, state.map, world_points,
                                                frame_ds.valid)
    with record_function("kiss/map_trim"):
        new_map = hash_map.trim(mcfg, new_map, new_pose[:3, 3])

    # 9. Constant-velocity bookkeeping.
    new_state = OdometryState(
        pose=new_pose,
        delta=se3.inverse(state.pose) @ new_pose,
        threshold=new_threshold,
        map=new_map,
    )
    result = FrameResult(
        pose=new_pose,
        frame_points=prep.points,
        frame_valid=prep.valid,
        source_points=source.points,
        source_valid=source.valid,
        sigma=sigma,
        num_iterations=align.num_iterations,
        num_correspondences=align.num_correspondences,
        num_dropped_downsample=frame_ds.num_dropped + source.num_dropped,
        num_dropped_map_voxels=insert_stats.num_dropped_voxels,
        num_oob_points=insert_stats.num_oob_points,
        used_fallback=~pose_finite,
    )
    return new_state, result


def subsample_to_capacity(frame, timestamps, cap: int):
    """Deterministic stride subsample of a scan above the padded-buffer
    capacity (head truncation would angularly bias an azimuth-ordered scan).

    Returns (frame, timestamps, n_dropped). Timestamps whose length does not
    match the scan are passed through untouched."""
    frame = np.asarray(frame)
    n = frame.shape[0]
    if n <= cap:
        return frame, timestamps, 0
    sel = np.linspace(0, n - 1, cap).astype(np.int64)
    if timestamps is not None and len(timestamps) == n:
        timestamps = np.asarray(timestamps)[sel]
    return frame[sel], timestamps, n - cap


class KissICP:
    """Stateful wrapper: numpy scans in, numpy poses out (reference
    kiss_icp.py:33-80, KissICP.hpp:56-96)."""

    def __init__(self, config: KISSConfig, device=None):
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self._capacity = int(config.engine.max_points_per_frame)
        # Points discarded by _pad's stride subsample (input scan larger
        # than engine.max_points_per_frame).
        self.last_input_dropped = 0
        self.total_input_dropped = 0
        self.state = init_state(config, self.device)
        self.last_result: Optional[FrameResult] = None

    def _pad(
        self, frame: np.ndarray, timestamps: Optional[np.ndarray]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        cap = self._capacity
        frame, timestamps, dropped = subsample_to_capacity(
            frame, timestamps, cap)
        self.last_input_dropped = dropped
        self.total_input_dropped += dropped
        n = frame.shape[0]
        pts = np.zeros((cap, 3), np.float32)
        pts[:n] = frame[:, :3]
        ts = np.zeros((cap,), np.float32)
        if timestamps is not None and len(timestamps) == n:
            ts[:n] = timestamps
        valid = np.zeros((cap,), bool)
        valid[:n] = True
        return pts, ts, valid

    def register_frame(
        self, frame: np.ndarray, timestamps: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (deskewed frame, ICP source) as compact numpy arrays,
        mirroring the reference API (kiss_icp.py:43-75)."""
        self.register_frame_lazy(frame, timestamps)
        out = self.last_frame(), self.last_source()
        self.maybe_rebase()
        return out

    def register_frame_lazy(self, frame, timestamps=None) -> FrameResult:
        """Advance one frame without copying the point outputs to the host
        (`last_frame()` / `last_source()` do that when needed)."""
        pts, ts, valid = self._pad(np.asarray(frame), timestamps)
        dev = self.device
        self.state, res = register_frame(
            self.config, self.state,
            torch.from_numpy(pts).to(dev), torch.from_numpy(ts).to(dev),
            torch.from_numpy(valid).to(dev))
        self.last_result = res
        return res

    def last_frame(self) -> np.ndarray:
        res = self.last_result
        return res.frame_points[res.frame_valid].cpu().numpy()

    def last_source(self) -> np.ndarray:
        res = self.last_result
        return res.source_points[res.source_valid].cpu().numpy()

    def last_overflow(self) -> Tuple[int, int, int, int]:
        """(downsample voxel drops, map voxel drops, input point drops,
        out-of-envelope point drops) of the last frame."""
        res = self.last_result
        return (
            int(res.num_dropped_downsample),
            int(res.num_dropped_map_voxels),
            self.last_input_dropped,
            int(res.num_oob_points),
        )

    def maybe_rebase(self, world_translation=None) -> bool:
        """The rolling-origin re-base trigger: a no-op until the pose
        translation exceeds `engine.rebase_trigger_voxels` voxels (inf-norm).
        The re-base itself is not ported yet, so a firing trigger raises
        instead of going on with a map near its key envelope."""
        trig = int(self.config.engine.rebase_trigger_voxels)
        if trig <= 0:
            return False
        v = float(self.config.mapping.voxel_size)
        if world_translation is None:
            local_t = self.state.pose[:3, 3].double().cpu().numpy()
        else:
            local_t = np.asarray(world_translation, np.float64)
        if float(np.max(np.abs(local_t))) < trig * v:
            return False
        raise NotImplementedError(
            "the pose left the rolling-origin re-base trigger "
            f"({trig} voxels); hash_map.rebase is not ported yet "
            "(ROADMAP item 8)")

    @property
    def last_pose(self) -> np.ndarray:
        return self.state.pose.double().cpu().numpy()

    @property
    def last_delta(self) -> np.ndarray:
        return self.state.delta.cpu().numpy()

    def local_map_points(self) -> np.ndarray:
        pts, mask = hash_map.extract_points(map_config(self.config), self.state.map)
        return pts[mask].double().cpu().numpy()
