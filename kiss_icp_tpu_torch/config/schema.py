"""Configuration schema of the PyTorch port.

Same sections, keys and defaults as `kiss_icp_tpu/config/schema.py`, so one
YAML file drives both packages (`config/basic.yaml`, `config/advanced.yaml`).
The `engine` section keeps the JAX package's fixed capacities: the port keeps
fixed-shape padded buffers, so point budgets, map capacity and probe length
stay first-class configuration.

Keys whose feature is not ported yet are accepted with their defaults and
refused by `check_supported` when set to anything else (see ROADMAP.md).
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
    # Accepted for compatibility; the port updates the map in place always.
    donate_state: bool = True
    # Accepted for compatibility only. The path a tensor takes is decided by
    # its device: a CUDA tensor always runs the CUDA kernels, a CPU tensor
    # their plain PyTorch versions.
    use_pallas: object = "auto"
    # Point-store layout of the voxel map: "f32" absolute coordinates, or
    # "u16" voxel-relative 16-bit fixed point (ops/hash_map.MapConfig).
    map_storage: str = "f32"
    # Data-association strategy. "gather27" (default) and "pallas_fused"
    # both run the fused 27-voxel NN kernel (kernels/nn27.py); the other
    # modes of the JAX package are not ported yet.
    nn_mode: str = "gather27"
    assoc_cache_size: int = 8
    assoc_refresh_dist: float = -1.0
    nn_live_capacity_log2: int = 15
    nn_probe_length: int = 8
    # Frames per device execution of the chunked driver (not ported yet).
    pipeline_chunk: int = 0
    # Deskew refinement passes (not ported yet; must stay 0).
    deskew_refine: int = 0
    deskew_refine_map: bool = False
    # GN iterations per loop trip in the JAX package; exactly equivalent to
    # 1, so the port accepts it and changes nothing.
    gn_unroll: int = 1
    # Ground-plane attitude stabilization (not ported yet; must stay 0).
    ground_align: float = 0.0
    # Rolling-origin re-base trigger, in voxels (inf-norm of the local pose
    # translation). The re-base itself is not ported yet: the port raises
    # when the trigger fires. 0 disables the check.
    rebase_trigger_voxels: int = 4096
    # Map sharding over several devices (not ported yet; must stay 1).
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


# nn_mode values that run the fused NN kernel; every other mode of the JAX
# package waits for ROADMAP item 14.
SUPPORTED_NN_MODES = ("gather27", "pallas_fused")


def check_supported(cfg: KISSConfig) -> None:
    """Raise NotImplementedError for a config that asks for a feature the
    port does not have yet, naming the ROADMAP item that brings it."""
    e = cfg.engine
    if e.nn_mode not in SUPPORTED_NN_MODES:
        raise NotImplementedError(
            f"engine.nn_mode={e.nn_mode!r} is not ported yet (ROADMAP item 14);"
            f" use one of {SUPPORTED_NN_MODES}")
    if int(e.deskew_refine) > 0 or bool(e.deskew_refine_map):
        raise NotImplementedError(
            "engine.deskew_refine / deskew_refine_map are not ported yet "
            "(ROADMAP item 13)")
    if float(e.ground_align) > 0.0:
        raise NotImplementedError(
            "engine.ground_align is not ported yet (ROADMAP item 13)")
    if int(e.map_shards) > 1:
        raise NotImplementedError(
            "engine.map_shards > 1 is not ported yet (ROADMAP item 16)")


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
