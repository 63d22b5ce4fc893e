"""Voxelization: integer voxel keys, downsampling, per-voxel grouping.

Port of `kiss_icp_tpu/ops/voxel.py`, bit-equal to it. All functions take
fixed-shape padded buffers with validity masks and return fixed-shape results.

Torch has no multi-key sort, so the JAX package's lexicographic
(key_hi, key_lo, index) sort becomes ONE stable sort of a packed int64 key
(key_hi << 15 | key_lo): the stable order breaks ties by original index,
exactly as the JAX sort's third key does, for any buffer length.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

# 15 bits per axis: voxel coordinates in [-16384, 16383].
_AXIS_OFFSET = 1 << 14
_AXIS_MASK = (1 << 15) - 1
KEY_SENTINEL = 2**31 - 1  # int32 max: invalid rows sort last
_U32 = 0xFFFFFFFF


def f32_scalar(value: float, device) -> torch.Tensor:
    """A 0-dim float32 constant made by a fill on the device: no host copy,
    so a CUDA graph can capture it. Arithmetic with it rounds as the JAX
    package's f32 constants do; in particular dividing by it is a true IEEE
    division on every device, while dividing a CUDA tensor by a Python float
    multiplies by its reciprocal, which moves voxel boundaries."""
    return torch.full((), value, dtype=torch.float32, device=device)


def point_to_voxel(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """floor(p / voxel_size) per axis: (..., 3) float32 -> (..., 3) int32.

    Non-finite points give device-dependent integers; every caller masks them
    by validity before they matter.
    """
    return torch.floor(points / f32_scalar(voxel_size, points.device)).to(torch.int32)


def in_envelope(coords: torch.Tensor, margin: int = 0) -> torch.Tensor:
    """(...,) bool: coords representable in the 15-bit-per-axis key space
    (two voxels 32768 cells apart would alias to the same key)."""
    lo, hi = -_AXIS_OFFSET + margin, _AXIS_OFFSET - margin
    return torch.all((coords >= lo) & (coords < hi), dim=-1)


def pack_voxel_keys(coords: torch.Tensor,
                    valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack int32 voxel coords (..., 3) into two int32 lexicographic keys.

    key_hi = (x + off) << 15 | (y + off),  key_lo = (z + off). Invalid rows,
    including coords outside the envelope, map to (KEY_SENTINEL, KEY_SENTINEL).
    """
    valid = valid & in_envelope(coords)
    x = (coords[..., 0] + _AXIS_OFFSET) & _AXIS_MASK
    y = (coords[..., 1] + _AXIS_OFFSET) & _AXIS_MASK
    z = (coords[..., 2] + _AXIS_OFFSET) & _AXIS_MASK
    sentinel = torch.full_like(x, KEY_SENTINEL)
    hi = torch.where(valid, (x << 15) | y, sentinel)
    lo = torch.where(valid, z, sentinel)
    return hi, lo


def _sort_by_voxel_key(hi: torch.Tensor, lo: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows sorted lexicographically by (hi, lo, original index).

    Packs (hi, lo) into one non-negative int64 (31 + 15 bits; invalid rows
    all share the largest key) and sorts it stably, so equal keys keep
    ascending original index. Returns (hi_s, lo_s, idx_s).
    """
    valid = hi != KEY_SENTINEL
    key = torch.where(valid, (hi.to(torch.int64) << 15) | lo.to(torch.int64),
                      torch.full_like(hi, KEY_SENTINEL, dtype=torch.int64) << 15)
    _, idx_s = torch.sort(key, stable=True)
    return hi[idx_s], lo[idx_s], idx_s


def _segment_heads(hi_s: torch.Tensor, lo_s: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid_s, head): sorted rows that are valid, and first of their voxel."""
    valid_s = hi_s != KEY_SENTINEL
    same = (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1])
    prev_same = torch.cat([torch.zeros(1, dtype=torch.bool, device=hi_s.device),
                           same])
    return valid_s, valid_s & ~prev_same


class Downsampled(NamedTuple):
    points: torch.Tensor  # (M, 3) float32
    valid: torch.Tensor  # (M,) bool
    num_kept: torch.Tensor  # () int32 — unique voxels kept (<= M)
    num_dropped: torch.Tensor  # () int32 — unique voxels lost to the M cap


def voxel_downsample(points: torch.Tensor, valid: torch.Tensor, *,
                     voxel_size: float, capacity: int) -> Downsampled:
    """Keep one point per voxel (lowest original index wins).

    Equivalent of reference VoxelDownsample (VoxelUtils.cpp:7-21) on padded
    buffers: sort by voxel key, keep segment heads, scatter the survivors
    into a fixed-size output buffer.
    """
    n = points.shape[0]
    dev = points.device
    coords = point_to_voxel(points, voxel_size)
    hi, lo = pack_voxel_keys(coords, valid)
    hi_s, lo_s, idx_s = _sort_by_voxel_key(hi, lo)
    _, head = _segment_heads(hi_s, lo_s)
    num_unique = torch.sum(head, dtype=torch.int32)

    # Heads are placed in HASH order of their voxel key, so a capacity
    # overflow drops a spatially unbiased subset (as the JAX package does).
    # uint32 arithmetic in int64: mask the low 32 bits after each multiply.
    h = (((hi_s.to(torch.int64) * 0x9E3779B1) & _U32)
         ^ ((lo_s.to(torch.int64) * 0x85EBCA77) & _U32))
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _U32
    h = h ^ (h >> 15)
    # 0xFFFFFFFF is the non-head sentinel below.
    h = torch.where(h == _U32, torch.full_like(h, _U32 - 1), h)
    order_key = torch.where(head, h, torch.full_like(h, _U32))
    # Rank of every row in (order_key, row index) order = inverse of the
    # stable sort permutation.
    _, perm = torch.sort(order_key, stable=True)
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    rank = torch.empty_like(iota)
    rank[perm] = iota
    out_pos = torch.where(head & (rank < capacity), rank,
                          torch.full_like(rank, capacity))  # capacity = drop row

    # Scatter into a buffer one row longer: every non-head lands in the extra
    # row, which is sliced off (JAX's mode="drop").
    src_idx = torch.full((capacity + 1,), n, dtype=torch.int64, device=dev)
    src_idx[out_pos] = idx_s
    src_idx = src_idx[:capacity]
    out_valid = src_idx < n
    padded = torch.cat([points, torch.zeros((1, 3), dtype=points.dtype, device=dev)])
    out_points = padded[src_idx]

    num_kept = torch.clamp(num_unique, max=capacity)
    return Downsampled(out_points, out_valid, num_kept, num_unique - num_kept)


class VoxelGroups(NamedTuple):
    """Points of one frame grouped by voxel, as a dense (rows, group_cap) table."""

    coords: torch.Tensor  # (rows, 3) int32 voxel coords of each group
    group_valid: torch.Tensor  # (rows,) bool
    candidates: torch.Tensor  # (rows, group_cap, 3) float32
    cand_valid: torch.Tensor  # (rows, group_cap) bool
    num_groups: torch.Tensor  # () int32


def group_by_voxel(points: torch.Tensor, valid: torch.Tensor, *,
                   voxel_size: float, group_capacity: int) -> VoxelGroups:
    """Group (N, 3) points by voxel into a dense (N, G, 3) candidate table.

    Feeds the map insert: up to G candidates per voxel, in ascending
    original-index order; candidates beyond G per voxel are dropped.
    """
    n = points.shape[0]
    dev = points.device
    g = group_capacity
    coords = point_to_voxel(points, voxel_size)
    hi, lo = pack_voxel_keys(coords, valid)
    hi_s, lo_s, idx_s = _sort_by_voxel_key(hi, lo)
    valid_s, head = _segment_heads(hi_s, lo_s)

    group_id = torch.cumsum(head.to(torch.int64), dim=0) - 1
    # Rank within the group: distance (in sorted position) to the segment head.
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    seg_start = torch.cummax(torch.where(head, pos, torch.full_like(pos, -1)),
                             dim=0).values
    rank = pos - torch.clamp(seg_start, min=0)
    num_groups = torch.sum(head, dtype=torch.int32)

    # Scatters into buffers one row longer; the extra row takes the dropped
    # rows and is sliced off (JAX's mode="drop").
    flat = torch.where(valid_s & (rank < g), group_id * g + rank,
                       torch.full_like(rank, n * g))
    cand = torch.zeros((n * g + 1, 3), dtype=points.dtype, device=dev)
    cand[flat] = points[idx_s]
    cand_valid = torch.zeros((n * g + 1,), dtype=torch.bool, device=dev)
    cand_valid[flat] = valid_s

    rep_coords = torch.zeros((n + 1, 3), dtype=torch.int32, device=dev)
    rep_coords[torch.where(head, group_id, torch.full_like(group_id, n))] = \
        coords[idx_s]
    group_valid = torch.arange(n, device=dev) < num_groups

    return VoxelGroups(
        coords=rep_coords[:n],
        group_valid=group_valid,
        candidates=cand[: n * g].reshape(n, g, 3),
        cand_valid=cand_valid[: n * g].reshape(n, g),
        num_groups=num_groups,
    )
