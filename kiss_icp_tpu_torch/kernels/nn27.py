"""K2: the fused 27-voxel nearest-neighbour query, as the operator
`kiss_icp_torch::nn27`.

CUDA kernel: `csrc/nn27.cu` (replaces the Pallas kernel
`kiss_icp_tpu/ops/pallas_nn.py::_candidate_kernel` and the XLA probe and
gather around it; the source says what bounds it and what its design does
about that). The operator's CPU implementation is the plain PyTorch version,
`ops/hash_map.query_nearest`, which the kernel matches bit for bit; its CUDA
implementation launches the kernel, or raises. The map's static parameters
(voxel size, probe length) are the operator's float and int arguments; the
rest follow from the tables' shapes and types.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

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


def _map_config(fprints: torch.Tensor, points: torch.Tensor, voxel_size: float,
                probe_length: int) -> MapConfig:
    """The query's view of the map's static configuration."""
    return MapConfig(voxel_size=voxel_size, max_points_per_voxel=points.shape[1],
                     capacity_log2=fprints.shape[0].bit_length() - 1,
                     probe_length=probe_length,
                     storage="u16" if points.dtype == torch.uint16 else "f32")


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


@torch.library.custom_op("kiss_icp_torch::nn27", mutates_args=(), device_types="cpu")
def nn27(queries: torch.Tensor, valid: torch.Tensor, vkeys: torch.Tensor,
         fprints: torch.Tensor, counts: torch.Tensor, points: torch.Tensor,
         voxel_size: float, probe_length: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(neighbours (N,3) f32, distances (N,) f32, found (N,) bool); on the
    CPU, the plain version."""
    cfg = _map_config(fprints, points, voxel_size, probe_length)
    m = VoxelMap(vkeys, fprints, counts, points, *([None] * 3))
    return tuple(hash_map.query_nearest(cfg, m, queries, valid))


@nn27.register_kernel("cuda")
def _nn27_cuda(queries, valid, vkeys, fprints, counts, points, voxel_size, probe_length):
    """Launch the kernel (one count in `query_nearest.launches`); no launch
    for zero queries."""
    dev = queries.device
    fn, stream = _entry()
    cfg = _map_config(fprints, points, voxel_size, probe_length)
    (key_shape, slot_shape, row_shape), margs = _map_args(cfg)
    n = queries.shape[0]
    check = _build.check_tensor
    q_ptr = check(queries, "queries", torch.float32, (n, 3), dev)
    v_ptr = check(valid, "valid", torch.bool, (n,), dev)
    k_ptr = check(vkeys, "vkeys", torch.int32, key_shape, dev)
    f_ptr = check(fprints, "fprints", torch.int32, slot_shape, dev)
    c_ptr = check(counts, "counts", torch.int32, slot_shape, dev)
    p_ptr = check(points, "points", cfg.point_dtype, row_shape, dev)
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
    return nn, dist, found


@nn27.register_fake
def _nn27_fake(queries, valid, vkeys, fprints, counts, points, voxel_size, probe_length):
    n = queries.shape[0]
    return (queries.new_empty((n, 3)), queries.new_empty((n,)),
            queries.new_empty((n,), dtype=torch.bool))


def query_nearest(cfg: MapConfig, m: VoxelMap, queries: torch.Tensor,
                  valid: torch.Tensor) -> QueryResult:
    """Closest map point among the 27 voxels around each query, through the
    operator: the plain version for CPU tensors, the kernel for CUDA tensors
    (counted in `query_nearest.launches`). Tensors on any other device
    raise."""
    _build.check_device(queries, "queries")
    return QueryResult(*nn27(queries, valid, m.vkeys, m.fprints, m.counts, m.points,
                             float(cfg.voxel_size), int(cfg.probe_length)))


query_nearest.launches = 0
