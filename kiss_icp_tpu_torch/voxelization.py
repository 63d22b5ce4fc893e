"""Standalone voxel-downsample convenience API (numpy in/out).

The port of `kiss_icp_tpu/voxelization.py` (reference
python/kiss_icp/voxelization.py:28-30): one point kept per voxel, over the
engine's own op (`ops/voxel.voxel_downsample`). It exists for users calling
the utility directly on numpy clouds (dataset preprocessing, notebooks).

The lowest-input-index point of each voxel is kept, in the engine's
(hash-ranked) output order, so the result equals the JAX package's bit for
bit. Like every entry point of the port it runs on the GPU unless the caller
passes `device="cpu"`; without a GPU the default raises.
"""

from __future__ import annotations

import numpy as np
import torch

from kiss_icp_tpu_torch.odometry import resolve_device
from kiss_icp_tpu_torch.ops import voxel as _voxel


def voxel_down_sample(frame: np.ndarray, voxel_size: float, device=None) -> np.ndarray:
    """Keep one point per `voxel_size` cell (lowest input index wins).

    frame: (N, 3)-ish numpy array (extra columns ignored). Returns the
    compact (M, 3) float32 result. The input is padded to a power of two, as
    the JAX package pads it, so both keep the same survivors in the same
    order.
    """
    dev = resolve_device(device)
    frame = np.asarray(frame, np.float32)
    n = frame.shape[0]
    if n == 0:
        return np.zeros((0, 3), np.float32)
    cap = 1 << max(1, int(np.ceil(np.log2(n))))
    pts = torch.zeros((cap, 3), dtype=torch.float32)
    pts[:n] = torch.from_numpy(np.ascontiguousarray(frame[:, :3]))
    valid = torch.zeros((cap,), dtype=torch.bool)
    valid[:n] = True
    out = _voxel.voxel_downsample(pts.to(dev), valid.to(dev),
                                  voxel_size=float(voxel_size), capacity=cap)
    return out.points[out.valid].cpu().numpy()
