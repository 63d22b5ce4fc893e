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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, f, f, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn, _build.stream_getter()


@functools.lru_cache(maxsize=None)
def _map_args(cfg: MapConfig):
    """The kernel's per-map arguments: the table shapes it checks, then
    (u16, P, probe length, log2 of it, row bits, v, v/65535), with v and
    v/65535 rounded to f32 exactly as the plain version's tensors."""
    c, p, k = cfg.capacity, cfg.max_points_per_voxel, cfg.probe_length
    v32 = np.float32(cfg.voxel_size)
    dec32 = v32 / np.float32(65535.0)
    row_bits = cfg.capacity_log2 - k.bit_length() + 1
    shapes = ((c, 3), (c,), (c, p, 3))
    return shapes, (int(cfg.storage == "u16"), p, k, k.bit_length() - 1, row_bits,
                    float(v32), float(dec32))


def query_nearest(cfg: MapConfig, m: VoxelMap, queries: torch.Tensor,
                  valid: torch.Tensor) -> QueryResult:
    """Closest map point among the 27 voxels around each query.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count one launch in `query_nearest.launches`), or raise.
    """
    dev = queries.device
    if dev.type == "cpu":
        return hash_map.query_nearest(cfg, m, queries, valid)
    if dev.type != "cuda":
        raise ValueError(f"queries: expected a CPU or CUDA tensor, got {dev}")
    fn, stream = _entry()
    (key_shape, slot_shape, row_shape), margs = _map_args(cfg)
    n = queries.shape[0]
    check = _build.check_tensor
    q_ptr = check(queries, "queries", torch.float32, (n, 3), dev)
    v_ptr = check(valid, "valid", torch.bool, (n,), dev)
    k_ptr = check(m.vkeys, "vkeys", torch.int32, key_shape, dev)
    f_ptr = check(m.fprints, "fprints", torch.int32, slot_shape, dev)
    c_ptr = check(m.counts, "counts", torch.int32, slot_shape, dev)
    p_ptr = check(m.points, "points", cfg.point_dtype, row_shape, dev)
    # 16 B loads of the probe window where the table's alignment allows them.
    vec_probe = int(cfg.probe_length % 4 == 0 and f_ptr % 16 == 0)
    # Three allocations: on the card's host a view or slice costs about as
    # much as an allocation (chip_smoke.py prints both costs).
    nn = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        err = fn(q_ptr, v_ptr, n, k_ptr, f_ptr, c_ptr, p_ptr, *margs, vec_probe,
                 nn.data_ptr(), dist.data_ptr(), found.data_ptr(), stream(dev.index))
        _build.check_error(err, "nn27 kernel")
        query_nearest.launches += 1
    return QueryResult(nn, dist, found)


query_nearest.launches = 0
