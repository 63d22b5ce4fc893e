"""Config loading: defaults <- environment (`kiss_icp_tpu_torch_*`) <- YAML file.

Same layering and derived defaults as the reference loader
(python/kiss_icp/config/parser.py:41-90): env vars may hold JSON values, the YAML
file wins over env, `voxel_size` defaults to `max_range / 100`, and an inverted
min/max range is clamped back to 0.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

from kiss_icp_tpu_torch.config.schema import KISSConfig, config_from_dict, config_to_dict

ENV_PREFIX = "kiss_icp_tpu_torch_"


def _env_source() -> Dict[str, Any]:
    import dataclasses as _dc
    import warnings

    # Only ingest env vars that name a real top-level config key: the env
    # namespace is shared with unrelated variables; a stray
    # `export kiss_icp_tpu_torch_x=1` must not crash every load_config()
    # call — pydantic-settings in the reference likewise ignores undeclared
    # keys).
    known = {f.name for f in _dc.fields(KISSConfig)}
    values: Dict[str, Any] = {}
    for key, raw in os.environ.items():
        lowered = key.lower()
        if not lowered.startswith(ENV_PREFIX):
            continue
        name = lowered[len(ENV_PREFIX):]
        if name not in known:
            warnings.warn(
                f"ignoring environment variable {key}: '{name}' is not a "
                f"config section ({sorted(known)})",
                stacklevel=2,
            )
            continue
        try:
            values[name] = json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            values[name] = raw
    return values


def _yaml_source(config_file: Optional[Union[str, Path]]) -> Dict[str, Any]:
    if config_file is None:
        return {}
    import yaml

    with open(config_file) as f:
        return yaml.safe_load(f) or {}


def load_config(
    config_file: Optional[Union[str, Path]] = None,
    *,
    max_range: Optional[float] = None,
    deskew: Optional[bool] = None,
) -> KISSConfig:
    """Load a KISSConfig from defaults, environment, and an optional YAML file."""
    cfg = KISSConfig()
    for source in (_env_source(), _yaml_source(config_file)):
        if source:
            merged = config_to_dict(cfg)
            _deep_merge(merged, source)
            cfg = config_from_dict(merged)

    # CLI-style overrides (reference parser.py:67-72).
    if max_range is not None:
        cfg.data.max_range = max_range
    if deskew is not None:
        cfg.data.deskew = deskew

    # Sanity clamp: min_range > max_range makes no sense (parser.py:73-75).
    if cfg.data.min_range > cfg.data.max_range:
        cfg.data.min_range = 0.0

    # Derived default voxel size (parser.py:78-79).
    if cfg.mapping.voxel_size is None:
        cfg.mapping.voxel_size = float(cfg.data.max_range) / 100.0
    return cfg


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for key, val in src.items():
        if isinstance(val, dict) and isinstance(dst.get(key), dict):
            _deep_merge(dst[key], val)
        else:
            dst[key] = val


def write_config(cfg: KISSConfig, filename: Union[str, Path]) -> None:
    import yaml

    with open(filename, "w") as f:
        yaml.safe_dump(config_to_dict(cfg), f, default_flow_style=False)
