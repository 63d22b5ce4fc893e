"""K2 wrapper: the fused 27-voxel nearest-neighbour query.

CUDA kernel: `csrc/nn27.cu` (replaces the Pallas kernel
`kiss_icp_tpu/ops/pallas_nn.py::_candidate_kernel` and the XLA probe and
gather around it; the source says what bounds it and what its design does
about that). Plain PyTorch version: `ops/hash_map.query_nearest`, taken only
for CPU tensors; the kernel matches it bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from kiss_icp_tpu_torch.kernels import _build
from kiss_icp_tpu_torch.ops import hash_map
from kiss_icp_tpu_torch.ops.hash_map import MapConfig, QueryResult, VoxelMap


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("nn27").kiss_nn27
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i,
                   ctypes.c_float, ctypes.c_float, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def query_nearest(cfg: MapConfig, m: VoxelMap, queries: torch.Tensor,
                  valid: torch.Tensor) -> QueryResult:
    """Closest map point among the 27 voxels around each query.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count one launch in `query_nearest.launches`), or raise.
    """
    if queries.device.type == "cpu":
        return hash_map.query_nearest(cfg, m, queries, valid)
    n = queries.shape[0]
    c, p, k = cfg.capacity, cfg.max_points_per_voxel, cfg.probe_length
    dev = queries.device
    _build.check_tensor(queries, "queries", torch.float32, (n, 3), dev)
    _build.check_tensor(valid, "valid", torch.bool, (n,), dev)
    _build.check_tensor(m.vkeys, "vkeys", torch.int32, (c, 3), dev)
    _build.check_tensor(m.fprints, "fprints", torch.int32, (c,), dev)
    _build.check_tensor(m.counts, "counts", torch.int32, (c,), dev)
    _build.check_tensor(m.points, "points", cfg.point_dtype, (c, p, 3), dev)
    # v and v/65535 rounded to f32 exactly as the plain version's tensors.
    v32 = np.float32(cfg.voxel_size)
    dec32 = v32 / np.float32(65535.0)
    row_bits = cfg.capacity_log2 - k.bit_length() + 1
    nn = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    err = _entry()(
        queries.data_ptr(), valid.data_ptr(), n, m.vkeys.data_ptr(),
        m.fprints.data_ptr(), m.counts.data_ptr(), m.points.data_ptr(),
        int(cfg.storage == "u16"), p, k, k.bit_length() - 1, row_bits,
        float(v32), float(dec32), nn.data_ptr(), dist.data_ptr(), found.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_error(err, "nn27 kernel")
    query_nearest.launches += 1
    return QueryResult(nn, dist, found)


query_nearest.launches = 0
