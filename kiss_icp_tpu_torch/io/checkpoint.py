"""Odometry state checkpoint / resume, in the JAX package's file format.

Format: one ``.npz`` holding the state's twelve arrays as ``leaf_0`` ...
``leaf_11`` in the order `jax.tree_util` flattens the JAX package's
OdometryState (pose, delta, threshold.{model_sse, sse_comp, num_samples},
map.{vkeys, fprints, counts, points, total_points, num_dropped_voxels,
num_oob_points}; written out by hand in `convert.LEAF_NAMES`), a JSON
metadata record of the map geometry, and ``extra_<name>`` arrays of host-side
engine state such as the rolling origin. The map-sharded engine's state
(`engine.map_shards` = D > 1) has the same twelve leaves, its three counters
(D,) per shard, and its record names D. A checkpoint written by either
package loads in the other.

Loading validates every array's shape and dtype against the target config
and fails loudly on a mismatch: a checkpoint is only valid for the engine
capacities it was written with.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from kiss_icp_tpu_torch import convert

FORMAT_VERSION = 1


def _metadata(config) -> dict:
    e = config.engine
    return {
        "format_version": FORMAT_VERSION,
        "voxel_size": float(config.mapping.voxel_size),
        "max_points_per_voxel": int(config.mapping.max_points_per_voxel),
        "map_capacity_log2": int(e.map_capacity_log2),
        "map_storage": str(e.map_storage),
        "probe_length": int(e.probe_length),
        # The map-sharded engine of the JAX package lays its slots out
        # differently: a checkpoint loads only into the geometry that wrote it.
        "map_shards": int(e.map_shards),
    }


def _state_arrays(state) -> dict:
    return {f"leaf_{i}": a for i, a in enumerate(convert.state_to_numpy(state))}


def _atomic_write(path, arrays: dict) -> None:
    """Write to a temporary name ending in .npz (so savez keeps it), then
    rename: a crash mid-write never leaves a truncated checkpoint, and the
    file lands at exactly `path`."""
    path = Path(path)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp.npz")
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)


def save_state(path, state) -> None:
    """Write an `odometry.OdometryState` (or the map-sharded engine's
    `ShardedMapState`, the same twelve leaves) to `path` (no metadata): one
    device-to-host copy of the map, stored compressed."""
    _atomic_write(path, _state_arrays(state))


def save_checkpoint(path, state, config, extras=None) -> None:
    """`save_state` plus the metadata record used for mismatch diagnostics.

    `extras`: optional {name: array} of engine-side host state, stored as
    ``extra_<name>`` (outside the leaf count); read back with `load_extra`.
    """
    arrays = _state_arrays(state)
    arrays["metadata_json"] = np.frombuffer(
        json.dumps(_metadata(config)).encode(), dtype=np.uint8)
    for name, value in (extras or {}).items():
        arrays[f"extra_{name}"] = np.asarray(value)
    _atomic_write(path, arrays)


def load_extra(path, name, default=None):
    """An ``extras`` array stored by `save_checkpoint`, or `default` when the
    checkpoint predates the field."""
    with np.load(Path(path)) as data:
        key = f"extra_{name}"
        return data[key] if key in data.files else default


def load_checkpoint(path, config, device=None):
    """Load an odometry state saved by `save_checkpoint` / `save_state` (of
    either package) onto `device` (None means CUDA), validated against
    `config`.

    Raises ``ValueError`` when the checkpoint was written under other engine
    capacities, map storage or shard count than `config` describes.
    """
    path = Path(path)
    with np.load(path) as data:
        saved_meta = None
        if "metadata_json" in data:
            saved_meta = json.loads(bytes(data["metadata_json"]).decode())
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [data[f"leaf_{i}"] for i in range(n)]

    expected = convert._expected(config)
    if saved_meta is not None:
        want = _metadata(config)
        # A key added to the record after a checkpoint was written compares
        # against the value its writer implicitly had (the schema default).
        defaults = {"map_shards": 1}
        mismatches = {
            k: (saved_meta.get(k, defaults.get(k)), want[k])
            for k in want
            if saved_meta.get(k, defaults.get(k)) != want[k]
        }
        if mismatches:
            raise ValueError(
                f"checkpoint {path} was written under a different map "
                f"configuration: {mismatches} (saved, current). Re-run with "
                "the matching config or rebuild the map."
            )
    if len(leaves) == len(expected) - 1:
        # Files written before the map gained its num_oob_points counter
        # (the JAX package's round 5) have one leaf fewer: the counter is
        # filled with zeros at its place.
        i = convert.LEAF_NAMES.index("num_oob_points")
        shape, dtype = expected[i]
        leaves = leaves[:i] + [np.zeros(shape, dtype)] + leaves[i:]
    if len(leaves) != len(expected):
        raise ValueError(
            f"checkpoint {path} has {len(leaves)} arrays, expected "
            f"{len(expected)} — produced by an incompatible version?"
        )
    for i, (got, (want_shape, want_dtype)) in enumerate(zip(leaves, expected)):
        if tuple(got.shape) != want_shape or got.dtype != want_dtype:
            raise ValueError(
                f"checkpoint {path} leaf {i}: shape/dtype "
                f"{got.shape}/{got.dtype} does not match the current config's "
                f"{want_shape}/{np.dtype(want_dtype)} (engine capacities must match)."
            )
    return convert.state_from_numpy(leaves, config, device)
