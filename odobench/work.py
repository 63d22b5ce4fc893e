"""What K1 and K2 need, counted from their inputs, and the least time the
card could take for it: the yardstick of the `*_roofline` metrics.

A frozen copy of the port's smoke arithmetic (`chip_smoke.py` `k1_work`,
`k2_work`, `bound`), rewritten to count what the inputs need rather than
what the port's layout reads: K2 reads each query once, each distinct
occupied voxel among the queries' 27-neighbourhoods once (its key and its
count) with the points it stores, and writes each answer once; K1 reads
each point and correspondence once and writes the system once. The counts
come from the reference's own replay of a frame (`reference/kiss.py`
`Odometry._work`), so they stay the same whatever implements the kernels.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense float32 and float64
# (outside the tensor cores), at the card's full 700 W.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12

# K1 operations per correspondence. f32: residual (3), |r|^2 (5), k + |r|^2,
# its square and the division (3), lever arms (3), w * l (3). f64: the 22
# sums (22), their products (18), the 6 cross terms (6).
K1_F32_FLOPS_PER_POINT = 17
K1_F64_FLOPS_PER_POINT = 46
# K2 float operations per candidate point: 3 sub, 3 mul, 2 add.
K2_FLOPS_PER_CANDIDATE = 8
# K2 bytes a query: the point (12) and its valid flag (1) in; the neighbour
# (12), its distance (4) and the found flag (1) out.
K2_BYTES_PER_QUERY = 12 + 1 + 12 + 4 + 1
# K2 bytes an occupied voxel: its key (3 x int32) and its count (int32).
K2_BYTES_PER_VOXEL = 16
BYTES_PER_POINT = 12


def k1_work(n: int, n_corr: int) -> Tuple[int, Dict[str, int]]:
    """(bytes, operations by type) of one system over n points with n_corr
    correspondences: points, targets and flags in, the kernel scale and
    the centre in, the 6x6 + 6 + 1 sums out."""
    return (n * (12 + 12 + 1) + (1 + 3) * 4 + (36 + 6 + 1) * 4,
            {"f32": K1_F32_FLOPS_PER_POINT * n_corr, "f64": K1_F64_FLOPS_PER_POINT * n_corr})


def k2_work(queries: int, voxels: int, voxel_points: int,
            candidates: int) -> Tuple[int, Dict[str, int]]:
    """(bytes, operations) of one query of `queries` points whose
    neighbourhoods hold `voxels` distinct occupied voxels storing
    `voxel_points` points, each query scoring its own `candidates`
    (summed over the queries)."""
    return (queries * K2_BYTES_PER_QUERY + voxels * K2_BYTES_PER_VOXEL
            + voxel_points * BYTES_PER_POINT,
            {"f32": K2_FLOPS_PER_CANDIDATE * candidates})


def bound(nbytes: int, flops: Dict[str, int]) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the peak rates of their types."""
    tb = nbytes / HBM_BYTES_PER_S
    tf = flops.get("f32", 0) / F32_FLOPS_PER_S + flops.get("f64", 0) / F64_FLOPS_PER_S
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def least_seconds(record: dict) -> Tuple[float, float]:
    """(K2 s, K1 s) the card needs at least for one iteration's work
    record (`reference/kiss.py` `Odometry._work`)."""
    k2 = bound(*k2_work(record["queries"], record["voxels"], record["voxel_points"],
                        record["candidates"]))[0]
    k1 = bound(*k1_work(record["queries"], record["correspondences"]))[0]
    return k2, k1
