"""Configuration schema of the PyTorch port.

Same sections, keys and defaults as `kiss_icp_tpu/config/schema.py`, so one
YAML file drives both packages (`config/basic.yaml`, `config/advanced.yaml`).
The `engine` section keeps the JAX package's fixed capacities: the port keeps
fixed-shape padded buffers, so point budgets, map capacity and probe length
stay first-class configuration.

Every key of the JAX package runs on the port; `engine.map_shards > 1`
selects the map-sharded engine (parallel/sharded_engine.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class DataConfig:
    max_range: float = 100.0
    min_range: float = 0.0
    deskew: bool = True


@dataclass
class MappingConfig:
    voxel_size: Optional[float] = None  # default: derived as max_range / 100
    max_points_per_voxel: int = 20


@dataclass
class RegistrationConfig:
    max_num_iterations: int = 500
    convergence_criterion: float = 1e-4
    # Kept for config-file compatibility with the reference; unused.
    max_num_threads: int = 0


@dataclass
class AdaptiveThresholdConfig:
    fixed_threshold: Optional[float] = None
    initial_threshold: float = 2.0
    min_motion_th: float = 0.1


@dataclass
class EngineConfig:
    """Static capacities of the padded buffers and the voxel hash map."""

    # Padded capacity for raw input scans (points per frame).
    max_points_per_frame: int = 131072
    # Capacity of the 0.5*voxel downsampled cloud used for map updates.
    frame_capacity: int = 65536
    # Capacity of the 1.5*voxel downsampled cloud used as ICP source.
    source_capacity: int = 8192
    # Voxel hash-map capacity as log2 of slot count (open addressing over
    # bucket-aligned probe windows).
    map_capacity_log2: int = 19
    # Probe window length (slots scanned per lookup; a power of two).
    probe_length: int = 16
    # Max same-frame insert candidates considered per map voxel.
    group_capacity: int = 16
    # True: a step updates the caller's map in place (the state passed in
    # must not be used again). False: it inserts into a copy and leaves the
    # caller's state as it was (odometry.register_frame, make_step,
    # make_chunked_step). KissICP owns its state and always donates.
    donate_state: bool = True
    # Accepted for compatibility only. The path a tensor takes is decided by
    # its device: a CUDA tensor always runs the CUDA kernels, a CPU tensor
    # their plain PyTorch versions.
    use_pallas: object = "auto"
    # Point-store layout of the voxel map: "f32" absolute coordinates, or
    # "u16" voxel-relative 16-bit fixed point (ops/hash_map.MapConfig).
    map_storage: str = "f32"
    # Data-association strategy (ops/registration.align_points_to_map):
    #   "gather27", "pallas_fused" — the fused 27-voxel NN kernel
    #                    (kernels/nn27.py) on CUDA tensors.
    #   "loop27"       — the same kernel on CUDA tensors (the mode promises
    #                    results bit-identical to gather27); the sequential
    #                    27-offset loop (hash_map.query_nearest_loop) on CPU
    #                    tensors.
    #   "compact", "compact_loop" — the same query as gather27. The JAX
    #                    package queries a dense view of the live voxels
    #                    instead, with the same answers; the port builds
    #                    the view once per frame (ops/compact_map.py) only
    #                    to count the live voxels it cannot hold into
    #                    FrameResult.num_dropped_map_voxels, as JAX does.
    #   "cached"       — each source point's `assoc_cache_size` nearest
    #                    candidates gathered once, GN re-selecting within
    #                    them, re-gathered once any point moved more than
    #                    `assoc_refresh_dist` (<= 0: 0.25 voxel). Not
    #                    bit-identical to the others.
    nn_mode: str = "gather27"
    assoc_cache_size: int = 8
    assoc_refresh_dist: float = -1.0
    nn_live_capacity_log2: int = 15
    nn_probe_length: int = 8
    # Frames per call of the chunked driver; 0 = auto (16 for headless
    # pipeline runs), 1 = one frame a call.
    pipeline_chunk: int = 0
    # Deskew refinement passes: re-deskew the raw scan with the motion ICP
    # just estimated and re-register from the converged pose (0 = reference
    # semantics).
    deskew_refine: int = 0
    # Re-deskew only the map-update cloud with the estimated motion.
    deskew_refine_map: bool = False
    # Gauss-Newton iterations per ICP loop trip, and so per host read of
    # the convergence test (ops/registration.gauss_newton_loop; below 1
    # reads as 1, as in the JAX package). Same trajectory and iteration
    # counts as 1: an iteration whose solve has converged keeps its state,
    # so a solve runs up to gn_unroll - 1 such frozen iterations (their
    # kernel launches included) at its end. Every loop JAX unrolls follows
    # it; nn_mode "cached" and parallel/sharded_icp.py stay at 1, as there.
    gn_unroll: int = 1
    # Ground-plane attitude stabilization strength (0 = off, reference
    # semantics; ops/ground.py).
    ground_align: float = 0.0
    # Rolling-origin re-base trigger, in voxels (inf-norm of the local pose
    # translation): past it, KissICP.maybe_rebase rolls the world origin
    # forward (hash_map.rebase). 0 disables the check.
    rebase_trigger_voxels: int = 4096
    # Map sharding: > 1 splits the voxel map's slots into this many shards
    # (parallel/sharded_engine.py; a power of two below the capacity). On
    # one card every shard sits on it; across the ranks of a process group
    # each rank holds its share.
    map_shards: int = 1

    @property
    def map_capacity(self) -> int:
        return 1 << self.map_capacity_log2


@dataclass
class KISSConfig:
    out_dir: str = "results"
    data: DataConfig = field(default_factory=DataConfig)
    registration: RegistrationConfig = field(default_factory=RegistrationConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    adaptive_threshold: AdaptiveThresholdConfig = field(default_factory=AdaptiveThresholdConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)


def _update_dataclass(obj: Any, values: Dict[str, Any], path: str = "") -> None:
    field_names = {f.name for f in dataclasses.fields(obj)}
    for key, val in values.items():
        # Real fields only: read-only properties (engine.map_capacity) must
        # be reported as unknown keys, not fail on setattr.
        if key not in field_names:
            raise ValueError(f"Unknown config key: {path}{key}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur):
            if not isinstance(val, dict):
                raise ValueError(
                    f"Config section '{path}{key}' must be a mapping, got "
                    f"{type(val).__name__} ({val!r})"
                )
            _update_dataclass(cur, val, path=f"{path}{key}.")
        else:
            # Coerce to the current value's scalar type: YAML/env sources
            # deliver strings/ints where the schema holds floats/bools.
            if cur is not None and val is not None \
                    and not isinstance(val, type(cur)):
                try:
                    if isinstance(cur, bool):
                        if isinstance(val, str):
                            val = val.strip().lower() in ("1", "true", "yes",
                                                          "on")
                        else:
                            val = bool(val)
                    elif isinstance(cur, int):
                        val = int(val)
                    elif isinstance(cur, float):
                        val = float(val)
                    elif isinstance(cur, str):
                        val = str(val)
                except (TypeError, ValueError) as e:
                    raise ValueError(
                        f"Config key '{path}{key}' expects "
                        f"{type(cur).__name__}, got {val!r}"
                    ) from e
            setattr(obj, key, val)


def config_from_dict(values: Dict[str, Any]) -> KISSConfig:
    cfg = KISSConfig()
    _update_dataclass(cfg, values or {})
    return cfg


def config_to_dict(cfg: KISSConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
