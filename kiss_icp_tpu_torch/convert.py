"""The odometry state carried between the JAX package and the port.

The state is the whole model: there are no weights, the voxel map is the
learned part. `state_to_numpy` / `state_from_numpy` map the port's
`OdometryState` to and from the flat list of numpy arrays in the order
`jax.tree_util.tree_flatten` gives the JAX package's `OdometryState` (the
order its checkpoints store as leaf_0 ... leaf_11):

    pose, delta, model_sse, sse_comp, num_samples,
    vkeys, fprints, counts, points, total_points, num_dropped_voxels,
    num_oob_points

A batched state (parallel/batch.py: every leaf stacked on a leading B, as
the JAX package's `init_batched_state`) crosses the same way, each array
with its leading B.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.odometry import OdometryState, map_config, resolve_device
from kiss_icp_tpu_torch.ops import hash_map, threshold

LEAF_NAMES = (
    "pose", "delta", "model_sse", "sse_comp", "num_samples",
    "vkeys", "fprints", "counts", "points", "total_points",
    "num_dropped_voxels", "num_oob_points",
)


def _expected(config: KISSConfig):
    mcfg = map_config(config)
    c, p = mcfg.capacity, mcfg.max_points_per_voxel
    pdt = np.uint16 if mcfg.storage == "u16" else np.float32
    f32, i32 = np.float32, np.int32
    return [((4, 4), f32), ((4, 4), f32), ((), f32), ((), f32), ((), f32),
            ((c, 3), i32), ((c,), i32), ((c,), i32), ((c, p, 3), pdt),
            ((), i32), ((), i32), ((), i32)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # PyTorch has few CUDA kernels for uint16: u16 points cross as int16 bits.
    if t.dtype == torch.uint16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.detach().cpu().numpy()


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A copy of `a` on `dev` (u16 crosses as its int16 bits)."""
    if a.dtype == np.uint16:
        return torch.tensor(a.view(np.int16), device=dev).view(torch.uint16)
    return torch.tensor(a, device=dev)


def state_to_numpy(state: OdometryState) -> List[np.ndarray]:
    """The state as 12 numpy arrays, in the JAX leaf order (a batched
    state's with their leading B)."""
    th, m = state.threshold, state.map
    tensors = [state.pose, state.delta, th.model_sse, th.sse_comp,
               th.num_samples, m.vkeys, m.fprints, m.counts, m.points,
               m.total_points, m.num_dropped_voxels, m.num_oob_points]
    return [_to_numpy(t) for t in tensors]


def state_from_numpy(leaves: Sequence[np.ndarray], config: KISSConfig,
                     device) -> OdometryState:
    """Build the port's state from 12 arrays in the JAX leaf order,
    validated against the shapes and dtypes `config` implies. A (B, 4, 4)
    pose makes it a batched state: every array then has that leading B."""
    if len(leaves) != len(LEAF_NAMES):
        raise ValueError(f"expected {len(LEAF_NAMES)} state arrays, got {len(leaves)}")
    dev = resolve_device(device)
    lead = np.shape(leaves[0])[:-2]  # (B,) for a batched state, () for one
    arrays = []
    for name, leaf, (shape, dtype) in zip(LEAF_NAMES, leaves, _expected(config)):
        shape = tuple(lead) + shape
        a = np.asarray(leaf)
        if a.shape != shape or a.dtype != dtype:
            raise ValueError(f"state array {name}: got {a.shape}/{a.dtype}, the "
                             f"config implies {shape}/{np.dtype(dtype)}")
        # A copy: the port updates the map in place, never the caller's arrays.
        arrays.append(_to_device(a, dev))
    (pose, delta, sse, comp, ns, vkeys, fprints, counts, points, total,
     dropped, oob) = arrays
    return OdometryState(
        pose=pose,
        delta=delta,
        threshold=threshold.ThresholdState(sse, comp, ns),
        map=hash_map.VoxelMap(vkeys, fprints, counts, points, total, dropped, oob),
    )
