"""KISS-ICP odometry: the per-frame orchestration.

Port of the core of `kiss_icp_tpu/odometry.py` (reference KissICP.cpp:35-68 /
kiss_icp.py:43-75): `register_frame(config, state, scan) -> (state, result)`
deskews, downsamples twice, registers against the local map with the
adaptive threshold, and updates the map. PyTorch runs eagerly, so the step is
plain Python over device tensors; the ICP loop and the map's claim rounds
read one scalar per iteration.

The map is updated IN PLACE (2^19 slots by default): the state passed to
`register_frame` shares its map tensors with the state it returns and must
not be used afterwards. A frame's result and the state it returns share the
pose tensor, so nothing updates a pose in place: `rebase_state` builds a new
one.

`make_chunked_step` advances K frames a call (PyTorch has no `lax.scan`: a
Python loop over the same `register_frame`, state on the device throughout),
and `rebase_state` rolls the world origin forward so that long drives stay
inside the map's key envelope.

`KissICP` is the stateful wrapper (numpy in/out), with the rolling origin,
the chunked API and checkpoints. Entry points run on the GPU unless the
caller asks for the CPU: `device=None` means CUDA and fails loudly on a
machine without a card.
"""

from __future__ import annotations

import warnings
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


def rebase_state(config: KISSConfig, state: OdometryState, shift_vox
                 ) -> Tuple[OdometryState, torch.Tensor]:
    """Roll the world origin forward by `shift_vox` voxels (int (3,)): the
    map rebuilds around shifted keys (hash_map.rebase) and the pose
    translation shifts by the same voxel multiple, computed in f32. `delta`
    and the adaptive threshold are translation-invariant and untouched. The
    caller adds `shift_vox * voxel_size` to its world origin, so reported
    poses do not move (KissICP.maybe_rebase).

    Out of place: the returned state holds a new pose tensor and a new map,
    so a FrameResult or ChunkSummary that shares the old pose is unchanged.

    Returns (state, () int32 voxels dropped by the rebuild)."""
    mcfg = map_config(config)
    dev = state.pose.device
    shift = torch.as_tensor(shift_vox).to(device=dev, dtype=torch.int32)
    new_map, dropped = hash_map.rebase(mcfg, state.map, shift)
    pose = state.pose.clone()
    pose[:3, 3] -= shift.to(torch.float32) * voxel.f32_scalar(mcfg.voxel_size, dev)
    return state._replace(pose=pose, map=new_map), dropped


class ChunkSummary(NamedTuple):
    """Per-frame scalars of a K-frame chunk, stacked on the device."""

    poses: torch.Tensor  # (K, 4, 4)
    sigmas: torch.Tensor  # (K,)
    num_iterations: torch.Tensor  # (K,) int32
    num_correspondences: torch.Tensor  # (K,)
    num_dropped_downsample: torch.Tensor  # (K,)
    num_dropped_map_voxels: torch.Tensor  # (K,)
    num_oob_points: torch.Tensor  # (K,)
    used_fallback: torch.Tensor  # (K,) bool


def make_chunked_step(config: KISSConfig):
    """A K-frame advance: `step(state, points (K,N,3), timestamps (K,N),
    valid (K,N)) -> (state, ChunkSummary)`, inputs on the state's device.

    The JAX package scans the frames inside one XLA program; PyTorch has no
    `lax.scan`, so this is a Python loop over `register_frame` whose state
    never leaves the device. Only the per-frame GN loop's one scalar a
    iteration reaches the host; the summary's scalars are stacked on the
    device."""

    def chunk(state, points, timestamps, valid):
        results = []
        for i in range(points.shape[0]):
            state, res = register_frame(config, state, points[i], timestamps[i], valid[i])
            results.append(res)

        def stacked(name):
            return torch.stack([getattr(r, name) for r in results])

        return state, ChunkSummary(
            poses=stacked("pose"),
            sigmas=stacked("sigma"),
            num_iterations=torch.tensor([r.num_iterations for r in results],
                                        dtype=torch.int32, device=points.device),
            num_correspondences=stacked("num_correspondences"),
            num_dropped_downsample=stacked("num_dropped_downsample"),
            num_dropped_map_voxels=stacked("num_dropped_map_voxels"),
            num_oob_points=stacked("num_oob_points"),
            used_fallback=stacked("used_fallback"),
        )

    return chunk


# Bytes a point takes in a packed chunk: 3 f32 coordinates, 1 f32 stamp and
# the valid flag.
_POINT_BYTES = 17


def chunk_views(packed: torch.Tensor, k: int, cap: int):
    """(points (K,cap,3) f32, timestamps (K,cap) f32, valid (K,cap) bool):
    views of one packed chunk buffer of K * cap * 17 bytes, on its device."""
    n = k * cap
    return (packed[:12 * n].view(torch.float32).view(k, cap, 3),
            packed[12 * n:16 * n].view(torch.float32).view(k, cap),
            packed[16 * n:].view(torch.bool).view(k, cap))


class PackedChunk(NamedTuple):
    """K padded scans in one host buffer (pinned when the engine runs on
    CUDA) and its numpy views; `dispatch_chunk` moves it in one copy."""

    packed: torch.Tensor  # (K * cap * 17,) uint8
    points: np.ndarray  # (K, cap, 3) float32
    timestamps: np.ndarray  # (K, cap) float32
    valid: np.ndarray  # (K, cap) bool

    @property
    def num_frames(self) -> int:
        return self.points.shape[0]


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


def create_odometry(config: KISSConfig, device=None) -> "KissICP":
    """Engine factory used by the pipeline and the CLI. The map-sharded
    engine of the JAX package (`engine.map_shards > 1`) is not ported yet:
    `check_supported` refuses it (ROADMAP item 16)."""
    check_supported(config)
    return KissICP(config, device=device)


class KissICP:
    """Stateful wrapper: numpy scans in, numpy poses out (reference
    kiss_icp.py:33-80, KissICP.hpp:56-96)."""

    def __init__(self, config: KISSConfig, device=None):
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self._capacity = int(config.engine.max_points_per_frame)
        # Points discarded by the stride subsample (input scan larger than
        # engine.max_points_per_frame).
        self.last_input_dropped = 0
        self.total_input_dropped = 0
        # World origin of the engine's local frame (rolling-origin re-base):
        # the state stays near the origin so voxel keys stay inside their
        # +-16383-voxel envelope on drives of any length; reported poses are
        # origin + local. float64, so kilometres of offset never round.
        self.origin = np.zeros(3, np.float64)
        self.total_rebase_dropped = 0
        self.state = init_state(config, self.device)
        self.last_result: Optional[FrameResult] = None
        self.last_chunk_summary: Optional[ChunkSummary] = None
        self.last_chunk_input_dropped = 0
        self._chunk_step = None

    def _pad_into(self, frame: np.ndarray, timestamps, pts: np.ndarray,
                  ts: np.ndarray, valid: np.ndarray) -> None:
        """Write one scan into padded (cap, ...) buffers, stride-subsampled
        when it is above capacity (the drop is counted)."""
        frame, timestamps, dropped = subsample_to_capacity(
            frame, timestamps, self._capacity)
        self.last_input_dropped = dropped
        self.total_input_dropped += dropped
        n = frame.shape[0]
        pts[:n] = frame[:, :3]
        pts[n:] = 0.0
        ts[:] = 0.0
        if timestamps is not None and len(timestamps) == n:
            ts[:n] = timestamps
        valid[:n] = True
        valid[n:] = False

    def build_chunk(self, frames, timestamps_list=None) -> Tuple[PackedChunk, int]:
        """Pack K numpy scans into one padded chunk buffer, 17 B a point
        (pinned host memory when the engine runs on CUDA, so that
        `dispatch_chunk` moves it in one asynchronous copy).

        Returns `(chunk, input_dropped)`: the stride-subsample loss of scans
        above max_points_per_frame in THIS chunk."""
        k, cap = len(frames), self._capacity
        packed = torch.empty(k * cap * _POINT_BYTES, dtype=torch.uint8,
                             pin_memory=self.device.type == "cuda")
        pts, ts, valid = (v.numpy() for v in chunk_views(packed, k, cap))
        drops_before = self.total_input_dropped
        for i, f in enumerate(frames):
            t = None if timestamps_list is None else timestamps_list[i]
            self._pad_into(np.asarray(f), t, pts[i], ts[i], valid[i])
        return PackedChunk(packed, pts, ts, valid), self.total_input_dropped - drops_before

    def _to_device(self, chunk: PackedChunk):
        packed = chunk.packed.to(self.device, non_blocking=True)
        return chunk_views(packed, chunk.num_frames, self._capacity)

    def register_frame(
        self, frame: np.ndarray, timestamps: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (deskewed frame, ICP source) as compact numpy arrays,
        mirroring the reference API (kiss_icp.py:43-75), then checks the
        rolling-origin trigger."""
        self.register_frame_lazy(frame, timestamps)
        out = self.last_frame(), self.last_source()
        self.maybe_rebase()
        return out

    def register_frame_lazy(self, frame, timestamps=None) -> FrameResult:
        """Advance one frame without copying the point outputs to the host
        (`last_frame()` / `last_source()` do that when needed). Does not
        re-base: drivers call `maybe_rebase` where they read the pose."""
        chunk, _ = self.build_chunk([frame], [timestamps])
        pts, ts, valid = self._to_device(chunk)
        self.state, res = register_frame(self.config, self.state, pts[0], ts[0], valid[0])
        self.last_result = res
        return res

    def dispatch_chunk(self, chunk: PackedChunk, input_dropped: int = 0) -> ChunkSummary:
        """Run one K-frame chunk (`build_chunk`) and return its summary on
        the device. It returns once the host has issued all K frames: the
        GN loop reads one scalar per iteration, so unlike the JAX package's
        asynchronous dispatch there is no window in which the host could
        pack the next chunk while the device works. `summary_poses` reads
        the poses."""
        self.last_chunk_input_dropped = input_dropped
        if self._chunk_step is None:
            self._chunk_step = self._make_chunk_step()
        self.state, summary = self._chunk_step(self.state, *self._to_device(chunk))
        self.last_chunk_summary = summary
        return summary

    def summary_poses(self, summary: ChunkSummary) -> np.ndarray:
        """A chunk's (K, 4, 4) world poses on the host, f64: local poses plus
        the rolling origin, which moves only in `maybe_rebase`, so every pose
        of a chunk shares the origin it ran under."""
        poses = self._summary_poses(summary).double().cpu().numpy()
        poses[:, :3, 3] += self.origin
        return poses

    def register_frames_chunked(self, frames, timestamps_list=None) -> np.ndarray:
        """Advance K frames and return their (K, 4, 4) world poses; the
        state stays on the device throughout the chunk."""
        chunk, dropped = self.build_chunk(frames, timestamps_list)
        summary = self.dispatch_chunk(chunk, dropped)
        poses = self.summary_poses(summary)
        # Poses are on the host and nothing is in flight: the point at
        # which the chunked path checks the envelope.
        self.maybe_rebase(poses[-1, :3, 3])
        return poses

    def _make_chunk_step(self):
        return make_chunked_step(self.config)

    def _summary_poses(self, summary: ChunkSummary) -> torch.Tensor:
        """The stacked (K, 4, 4) local poses of a chunk summary."""
        return summary.poses

    def last_frame(self) -> np.ndarray:
        res = self.last_result
        return res.frame_points[res.frame_valid].cpu().numpy()

    def last_source(self) -> np.ndarray:
        res = self.last_result
        return res.source_points[res.source_valid].cpu().numpy()

    def last_overflow(self) -> Tuple[int, int, int, int]:
        """(downsample voxel drops, map voxel drops, input point drops,
        out-of-envelope point drops) of the last frame. The fourth stays 0
        while `engine.rebase_trigger_voxels` > 0 (the default) re-bases."""
        res = self.last_result
        return (
            int(res.num_dropped_downsample),
            int(res.num_dropped_map_voxels),
            self.last_input_dropped,
            int(res.num_oob_points),
        )

    def maybe_rebase(self, world_translation=None) -> bool:
        """Roll the world origin once the local pose translation exceeds
        `engine.rebase_trigger_voxels` voxels (inf-norm; 0 disables): the map
        rebuilds around shifted keys, the pose shifts, and `self.origin`
        absorbs the offset, so reported world poses are continuous.

        Pass a world translation already on the host (the last pose of a
        chunk) to avoid a read; with none, the local pose is read from the
        device. Returns True when a re-base was applied."""
        trig = int(self.config.engine.rebase_trigger_voxels)
        if trig <= 0:
            return False
        v = float(self.config.mapping.voxel_size)
        if world_translation is None:
            local_t = self.state.pose[:3, 3].double().cpu().numpy()
        else:
            local_t = np.asarray(world_translation, np.float64) - self.origin
        if float(np.max(np.abs(local_t))) < trig * v:
            return False
        # Voxel-aligned: u16 rows stay bit-identical, f32 rows and the pose
        # shift by an exact voxel multiple.
        shift_vox = np.floor(local_t / v).astype(np.int32)
        dropped = self._apply_rebase(shift_vox)
        self.origin = self.origin + shift_vox.astype(np.float64) * v
        self.total_rebase_dropped += dropped
        if dropped:
            warnings.warn(
                f"rolling-origin re-base dropped {dropped} voxels during "
                "the table rebuild — the map is over-full for its "
                "capacity_log2/probe_length; raise them.",
                RuntimeWarning, stacklevel=2,
            )
        return True

    def _apply_rebase(self, shift_vox: np.ndarray) -> int:
        """Re-base this engine's state; returns the voxels the rebuild
        dropped."""
        self.state, dropped = rebase_state(self.config, self.state, shift_vox)
        return int(dropped)

    def save_checkpoint(self, path) -> None:
        """Persist the full odometry state and the rolling origin
        (io/checkpoint.py; the JAX package's format)."""
        from kiss_icp_tpu_torch.io import checkpoint

        checkpoint.save_checkpoint(path, self.state, self.config,
                                   extras={"origin": self.origin})

    def load_checkpoint(self, path) -> None:
        """Restore a state saved by either package, validated against this
        engine's config, onto this engine's device; a checkpoint without an
        origin (written before re-bases existed) means origin zero."""
        from kiss_icp_tpu_torch.io import checkpoint

        self.state = checkpoint.load_checkpoint(path, self.config, self.device)
        self.origin = np.asarray(
            checkpoint.load_extra(path, "origin", np.zeros(3)), np.float64)

    @property
    def last_pose(self) -> np.ndarray:
        """World pose of the last frame: local pose + rolling origin."""
        pose = self.state.pose.double().cpu().numpy()
        pose[:3, 3] += self.origin
        return pose

    @property
    def last_delta(self) -> np.ndarray:
        return self.state.delta.cpu().numpy()

    def local_map_points(self) -> np.ndarray:
        """The local map's points in the world frame (f64)."""
        pts, mask = hash_map.extract_points(map_config(self.config), self.state.map)
        return pts[mask].double().cpu().numpy() + self.origin
