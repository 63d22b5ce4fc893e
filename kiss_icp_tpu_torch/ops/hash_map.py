"""Fixed-capacity voxel hash map: the local map, in place on the device.

Port of the core of `kiss_icp_tpu/ops/hash_map.py` (reference
VoxelHashMap.{hpp:38-57,cpp:33-133}), slot for slot: the same hash, the same
fingerprints, the same bucket-aligned probe windows and the same
deterministic claim rounds, so a map built by either package has identical
`vkeys`, `fprints`, `counts` and `points`.

  * slots:   `vkeys (C,3) i32`, `fprints (C,) i32` nonzero fingerprint
             (0 = free slot), `counts (C,) i32`, point store `points (C,P,3)`
             in f32 or voxel-relative u16.
  * probing: all `probe_length` slots of an aligned window (base = row * K);
             the FIRST fingerprint match wins, then the exact key is checked.
  * queries: `query_nearest` is the plain PyTorch version of the fused NN
             kernel (kernels/nn27.py), which the GN loop uses on CUDA tensors.
  * inserts: deterministic scatter-min claim rounds (lowest batch row wins),
             exactly `probe_length` of them, with no host read.
  * updates: `update`, a step's whole map update (transform, insert, trim):
             on the card, for a caller that owns the tables, the replay of
             one CUDA graph; elsewhere the same work called directly.

Memory: the map is 2^19 slots by default (126 MB of f32 points), so `insert`
and `trim` write every table of the map they are given IN PLACE, and return
a map that holds the same tables: the map passed to `insert` must not be
used afterwards (the JAX package donates the buffers for the same reason).
A caller that keeps its map inserts into a copy (`odometry.register_frame`
with `engine.donate_state` false). `rebase`, which runs every few
kilometres, rebuilds into new tensors.

uint32 hashing is computed in int64 with the low 32 bits masked after every
multiply (the int64 product may wrap; its low 32 bits stay right), and right
shifts of non-negative int64 are logical, as uint32 shifts are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kiss_icp_tpu_torch import trace
from kiss_icp_tpu_torch.ops import control, se3
from kiss_icp_tpu_torch.ops import voxel as voxel_ops

# 27 neighbor offsets: the (0,0,0)-centered 3x3x3 cube, own voxel first, in
# the JAX package's order (the NN kernel walks them in this order too).
_NEIGHBOR_SHIFTS = np.array(
    [[dx, dy, dz] for dx in (0, 1, -1) for dy in (0, 1, -1) for dz in (0, 1, -1)],
    dtype=np.int32,
)

_U32 = 0xFFFFFFFF
_U16_SCALE = 65535.0


@dataclass(frozen=True)
class MapConfig:
    """Static configuration of the voxel map (see the JAX package's
    MapConfig: `storage` "f32" stores absolute coordinates, "u16" 16-bit
    fixed-point offsets from the owning voxel's corner)."""

    voxel_size: float = 1.0
    max_distance: float = 100.0
    max_points_per_voxel: int = 20
    capacity_log2: int = 18
    probe_length: int = 16
    group_capacity: int = 16
    storage: str = "f32"

    def __post_init__(self):
        k = self.probe_length
        if k <= 0 or (k & (k - 1)) != 0:
            raise ValueError(f"probe_length must be a power of two, got {k}")
        if k > (1 << self.capacity_log2):
            raise ValueError("probe_length exceeds the map capacity")
        if self.storage not in ("f32", "u16"):
            raise ValueError(f"storage must be 'f32' or 'u16', got "
                             f"{self.storage!r}")

    @property
    def capacity(self) -> int:
        return 1 << self.capacity_log2

    @property
    def map_resolution_sq(self) -> float:
        return self.voxel_size * self.voxel_size / self.max_points_per_voxel

    @property
    def point_dtype(self):
        return torch.uint16 if self.storage == "u16" else torch.float32


class VoxelMap(NamedTuple):
    """Device state of the map (config is carried separately)."""

    vkeys: torch.Tensor  # (C, 3) int32
    fprints: torch.Tensor  # (C,) int32, 0 = free
    counts: torch.Tensor  # (C,) int32
    points: torch.Tensor  # (C, P, 3) float32 or uint16
    total_points: torch.Tensor  # () int32
    num_dropped_voxels: torch.Tensor  # () int32 — voxels lost to probe overflow
    num_oob_points: torch.Tensor  # () int32 — POINTS outside the key envelope


# PyTorch has few kernels for uint16 (no CUDA gather, fill or float cast):
# u16 point rows are created, gathered and converted through their int16
# bits, which leaves the stored values unchanged.
_BITS = {torch.float32: torch.float32, torch.uint16: torch.int16}


def _take_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points[idx], for f32 and u16 point stores."""
    return points.view(_BITS[points.dtype])[idx].view(points.dtype)


def _u16_to_f32(stored: torch.Tensor) -> torch.Tensor:
    return (stored.view(torch.int16).to(torch.int32) & 0xFFFF).to(torch.float32)


def create_map(cfg: MapConfig, device=None) -> VoxelMap:
    c, p = cfg.capacity, cfg.max_points_per_voxel
    i32 = dict(dtype=torch.int32, device=device)
    return VoxelMap(
        vkeys=torch.zeros((c, 3), **i32),
        fprints=torch.zeros((c,), **i32),
        counts=torch.zeros((c,), **i32),
        points=torch.zeros((c, p, 3), dtype=_BITS[cfg.point_dtype],
                           device=device).view(cfg.point_dtype),
        total_points=torch.zeros((), **i32),
        num_dropped_voxels=torch.zeros((), **i32),
        num_oob_points=torch.zeros((), **i32),
    )


def decode_scale(voxel_size: float, device=None) -> torch.Tensor:
    """v / 65535 computed in f32, as the JAX package computes it."""
    return (voxel_ops.f32_scalar(voxel_size, device)
            / voxel_ops.f32_scalar(_U16_SCALE, device))


def encode_points(cfg: MapConfig, points: torch.Tensor,
                  vkeys: torch.Tensor) -> torch.Tensor:
    """World f32 (..., 3) -> stored representation, given owning voxel
    coords (..., 3) int32. Identity for f32 storage."""
    if cfg.storage == "f32":
        return points.to(torch.float32)
    v = voxel_ops.f32_scalar(cfg.voxel_size, points.device)
    off = points - vkeys.to(torch.float32) * v
    q = torch.round(off * (voxel_ops.f32_scalar(_U16_SCALE, points.device) / v))
    q = torch.clamp(q, 0.0, _U16_SCALE).to(torch.int32)
    return q.to(torch.int16).view(torch.uint16)  # the low 16 bits


def decode_points(cfg: MapConfig, stored: torch.Tensor,
                  vkeys: torch.Tensor) -> torch.Tensor:
    """Stored representation -> world f32, given owning voxel coords."""
    if cfg.storage == "f32":
        return stored
    v = voxel_ops.f32_scalar(cfg.voxel_size, stored.device)
    corner = vkeys.to(torch.float32) * v
    return (_u16_to_f32(stored) * decode_scale(cfg.voxel_size, stored.device)
            + corner)


def _mix(h: torch.Tensor) -> torch.Tensor:
    """lowbias32 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _U32
    h = h ^ (h >> 16)
    return h


def _hash_coords(coords: torch.Tensor) -> torch.Tensor:
    """Spatial hash of int32 voxel coords (..., 3) -> uint32 in int64 (...,).
    Sequential mixing: XOR-of-multiplies collides on negated pairs."""
    c = coords.to(torch.int64) & _U32  # int32 -> its uint32 bit pattern
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    h = _mix((x * 0x9E3779B1) & _U32)
    h = _mix(h ^ ((y * 0x85EBCA77) & _U32))
    h = _mix(h ^ ((z * 0xC2B2AE3D) & _U32))
    return h


def fingerprint(coords: torch.Tensor) -> torch.Tensor:
    """Nonzero int32 fingerprint of voxel coords (0 is the free-slot marker):
    the uint32 hash reinterpreted as int32."""
    h = _mix(_hash_coords(coords) ^ 0x9E3779B9)
    h = torch.where(h == 0, torch.ones_like(h), h)
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def window_row(coords: torch.Tensor, capacity_log2: int,
               probe_length: int) -> torch.Tensor:
    """Probe-window row of a voxel: top bits of the hash, one row per aligned
    window of `probe_length` slots. int64 (an index)."""
    row_bits = capacity_log2 - probe_length.bit_length() + 1
    if row_bits <= 0:
        # One window covering the whole table (a shift by 32 is undefined).
        return torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
    return _hash_coords(coords) >> (32 - row_bits)


def _window_fp(fprints: torch.Tensor, rows: torch.Tensor,
               probe_length: int) -> torch.Tensor:
    """Fingerprints of the probe windows `rows`: (..., probe_length)."""
    return fprints.view(-1, probe_length)[rows]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


class QueryResult(NamedTuple):
    neighbors: torch.Tensor  # (N, 3) closest map point (zeros when none)
    distances: torch.Tensor  # (N,) Euclidean distance (+inf when none)
    found: torch.Tensor  # (N,) bool


def neighbor_shifts(device=None) -> torch.Tensor:
    """_NEIGHBOR_SHIFTS (27, 3) int32, computed on the device: base-3 digits
    of the neighbour index, digit 2 meaning -1 (as the NN kernel does)."""
    j = torch.arange(27, dtype=torch.int32, device=device)
    digits = torch.stack([j // 9, (j // 3) % 3, j % 3], dim=-1)
    return torch.where(digits == 2, -1, digits)


def _probe(cfg: MapConfig, m: VoxelMap, neigh: torch.Tensor):
    """Slot of each voxel `neigh` (..., 3): (slot (...,) int64, 0 where
    absent; present (...,) bool). The first fingerprint match of the window
    wins, then its exact key is checked: a fingerprint collision inside the
    window must never surface another voxel's points as this voxel's."""
    k = cfg.probe_length
    rows = window_row(neigh, cfg.capacity_log2, k)
    match = _window_fp(m.fprints, rows, k) == fingerprint(neigh)[..., None]
    slot = (rows << (k.bit_length() - 1)) + _first_true(match)
    present = torch.any(match, dim=-1) & torch.all(m.vkeys[slot] == neigh, dim=-1)
    return torch.where(present, slot, torch.zeros_like(slot)), present


def score_candidates(cfg: MapConfig, queries: torch.Tensor, neigh: torch.Tensor,
                     present: torch.Tensor, counts: torch.Tensor,
                     stored: torch.Tensor):
    """Decoded candidate points and their squared distances to the queries.

    queries (N, 3); neigh (N, ..., 3) the candidate voxels, present and
    counts (N, ...) whether each is in the map and its point count, stored
    (N, ..., P, 3) its stored row. Returns (pts (N, ..., P, 3), d2 (N, ...,
    P) with +inf on unusable lanes). d2 = (dx^2 + dy^2) + dz^2, each step
    rounded: the NN kernel computes it in exactly this order, so both
    queries give the kernel's bits.
    """
    pts = decode_points(cfg, stored, neigh[..., None, :])
    q = queries.view(queries.shape[0], *([1] * (pts.dim() - 2)), 3)
    diff = q - pts
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    lanes = torch.arange(cfg.max_points_per_voxel, dtype=torch.int32,
                         device=queries.device)
    usable = (lanes < counts[..., None]) & present[..., None]
    return pts, torch.where(usable, d2, torch.full_like(d2, float("inf")))


def _candidate_slab(cfg: MapConfig, m: VoxelMap, queries: torch.Tensor):
    """Each query's 27-voxel candidate points: (pts (N,27,P,3), d2 (N,27,P)
    with +inf on unusable lanes)."""
    qvox = voxel_ops.point_to_voxel(queries, cfg.voxel_size)  # (N, 3)
    neigh = qvox[:, None, :] + neighbor_shifts(queries.device)[None, :, :]  # (N, 27, 3)
    slot, present = _probe(cfg, m, neigh)
    return score_candidates(cfg, queries, neigh, present, m.counts[slot],
                            _take_rows(m.points, slot))


def query_nearest(cfg: MapConfig, m: VoxelMap, queries: torch.Tensor,
                  valid: torch.Tensor) -> QueryResult:
    """Closest map point among the 27 voxels around each query point: the
    plain PyTorch version of the fused NN kernel (kernels/nn27.py).

    Exact equivalent of VoxelHashMap::GetClosestNeighbor (VoxelHashMap.cpp:
    46-70): ties go to the lowest (neighbor, lane) index. A query with no
    candidate gets a zero neighbor and an infinite distance.
    """
    pts, d2 = _candidate_slab(cfg, m, queries)
    n = d2.shape[0]
    d2_flat = d2.flatten(1)  # (N, 27 * P), also for N = 0
    best = torch.argmin(d2_flat, dim=-1)  # first minimum
    best_d2 = torch.gather(d2_flat, 1, best[:, None])[:, 0]
    nn = pts.flatten(1, 2)[torch.arange(n, device=d2.device), best]
    has = torch.isfinite(best_d2)
    nn = torch.where(has[:, None], nn, torch.zeros_like(nn))
    return QueryResult(nn, torch.sqrt(best_d2), has & valid)


def query_nearest_loop(cfg: MapConfig, m: VoxelMap, queries: torch.Tensor,
                       valid: torch.Tensor) -> QueryResult:
    """`query_nearest` as a sequential loop over the 27 neighbour offsets
    with a running minimum (nn_mode "loop27" on CPU tensors; JAX
    `hash_map.query_nearest_loop`): every intermediate is (N, P) shaped.

    Wherever `query_nearest` finds a query, this finds it with the same
    bits: the strict `<` keeps the lowest offset, the per-offset argmin the
    lowest lane. A NaN candidate (a NaN query, or a stored NaN point) never
    wins here, where it wins `query_nearest`'s argmin, as between JAX's two
    versions. A query with no finite candidate gets a zero neighbour and an
    infinite distance."""
    n = queries.shape[0]
    qvox = voxel_ops.point_to_voxel(queries, cfg.voxel_size)
    shifts = neighbor_shifts(queries.device)
    best_d2 = torch.full((n,), float("inf"), dtype=torch.float32, device=queries.device)
    best_pt = torch.zeros((n, 3), dtype=torch.float32, device=queries.device)
    rows = torch.arange(n, device=queries.device)
    for j in range(27):
        neigh = qvox + shifts[j]
        slot, present = _probe(cfg, m, neigh)
        pts, d2 = score_candidates(cfg, queries, neigh, present, m.counts[slot],
                                   _take_rows(m.points, slot))  # (N, P)
        lane = torch.argmin(d2, dim=-1)
        lane_d2 = d2[rows, lane]
        improve = lane_d2 < best_d2
        best_d2 = torch.where(improve, lane_d2, best_d2)
        best_pt = torch.where(improve[:, None], pts[rows, lane], best_pt)
    return QueryResult(best_pt, torch.sqrt(best_d2), torch.isfinite(best_d2) & valid)


def query_topc(cfg: MapConfig, m: VoxelMap, queries: torch.Tensor,
               c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `c` nearest candidate map points per query from its 27-voxel
    neighbourhood, nearest first: (cand (N, c, 3), cand_valid (N, c)),
    cand_valid = finite distance. nn_mode "cached" gathers them once and
    re-selects within them between GN iterations (JAX `hash_map.query_topc`).

    JAX takes `lax.top_k(-d2)`, which orders in IEEE total order and breaks
    ties by the lower index; `torch.topk` promises no order among ties. So
    this is a stable ascending sort of d2 in the same total order: finite,
    then +inf (absent lanes), then NaN (a NaN query's lanes) last, except
    that a NaN with its sign bit set sorts first, as -(-NaN) leads JAX's
    top_k. Only finite candidates are valid, so a NaN query's order never
    reaches a result.
    """
    n = queries.shape[0]
    pts, d2 = _candidate_slab(cfg, m, queries)
    d2 = d2.reshape(n, -1)
    key = torch.where(torch.isnan(d2) & torch.signbit(d2), torch.full_like(d2, -1.0), d2)
    idx = torch.sort(key, dim=-1, stable=True).indices[:, :c]  # (N, c)
    cand = torch.gather(pts.reshape(n, -1, 3), 1, idx[..., None].expand(n, idx.shape[1], 3))
    return cand, torch.isfinite(torch.gather(d2, 1, idx))


def _claim_slots(fprints, vkeys, coords, fp, rows, pending, *,
                 probe_length: int, capacity: int):
    """Deterministic free-slot claiming for a batch of new voxels (JAX
    `hash_map._claim_slots`).

    Each pending row tries the first free slot of its window; scatter-min
    rounds let the lowest row index win a contested slot. Rows whose window
    is full, or whose fingerprint would shadow a DIFFERENT voxel's equal
    fingerprint in the window, end unassigned (-1) — a counted drop, never a
    silent hole. Each round writes its winners by a fixed-shape scatter into
    tables one row longer, where every other row lands in the extra row. The
    claimed slots of a round are unique, so the outcome is deterministic,
    slot for slot.

    JAX rounds until no row is pending; this runs exactly `probe_length`
    rounds, with no test and no host read (a CUDA graph holds them), and
    ends with the same tables. The pending rows of a window all aim at its
    first free slot, so each round fills one slot of every window they aim
    at: after `probe_length` rounds no pending row can win, and a round
    with none pending writes the extra row only.

    Returns (`assigned` (V,) int64, new `fprints`, new `vkeys`); the tables
    passed in are not written.
    """
    k, cap = probe_length, capacity
    shift = k.bit_length() - 1
    v = coords.shape[0]
    dev = coords.device
    row_ids = torch.arange(v, dtype=torch.int64, device=dev)
    dump = torch.full_like(row_ids, cap)
    fpx = torch.cat([fprints, fprints.new_zeros(1)])
    vkx = torch.cat([vkeys, vkeys.new_zeros((1, 3))])
    assigned = torch.full((v,), -1, dtype=torch.int64, device=dev)
    for _ in range(k):
        free = _window_fp(fpx[:cap], rows, k) == 0  # (V, K)
        any_free = torch.any(free, dim=-1)
        tgt_slot = (rows << shift) + _first_true(free)
        attempt = pending & any_free
        claims = torch.full((cap + 1,), v, dtype=torch.int64, device=dev)
        claims = claims.scatter_reduce(0, torch.where(attempt, tgt_slot, dump),
                                       torch.where(attempt, row_ids, torch.full_like(row_ids, v)),
                                       "amin")
        won = attempt & (claims[torch.clamp(tgt_slot, max=cap - 1)] == row_ids)
        dst = torch.where(won, tgt_slot, dump)
        fpx = fpx.index_put((dst,), fp)
        vkx = vkx.index_put((dst,), coords)
        assigned = torch.where(won, tgt_slot, assigned)
        # Within one round a window admits one winner, so shadowing can only
        # form across rounds: drop rows whose window just gained an
        # equal-fingerprint entry of another voxel.
        wk2 = vkx[:cap].view(-1, k, 3)[rows]
        now_shadowed = torch.any(
            (_window_fp(fpx[:cap], rows, k) == fp[:, None])
            & ~torch.all(wk2 == coords[:, None, :], dim=-1),
            dim=-1,
        )
        pending = pending & ~won & any_free & ~now_shadowed
    return assigned, fpx[:cap], vkx[:cap]


def _write_rows(table: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor,
                has: torch.Tensor) -> None:
    """`table[slots[i]] = rows[i]` for every i with `has[i]` (their slots
    unique), IN PLACE, as one write of all the rows: each other row writes
    slot 0 with the bits slot 0 ends with (the row written there, if any,
    else what it holds), so that all the writes to a slot carry the same
    bits and the table ends as the write of the rows with a slot leaves it."""
    to_0 = has & (slots == 0)
    row_0 = rows[_first_true(to_0).view(1)][0]
    end_0 = torch.where(torch.any(to_0), row_0, table[0])
    dst = torch.where(has, slots, torch.zeros_like(slots))
    lead = has.view(-1, *([1] * (rows.dim() - 1)))
    table.index_put_((dst,), torch.where(lead, rows, end_0))


class InsertStats(NamedTuple):
    num_added_points: torch.Tensor  # () int32
    num_dropped_voxels: torch.Tensor  # () int32 — new voxels with no free slot
    num_oob_points: torch.Tensor  # () int32 — input POINTS outside the envelope


def insert(cfg: MapConfig, m: VoxelMap, points: torch.Tensor,
           valid: torch.Tensor) -> Tuple[VoxelMap, InsertStats]:
    """Add one frame of world-frame points to the map, every table IN
    PLACE (see the module docstring); the returned map holds `m`'s tables.

    Mirrors VoxelHashMap::AddPoints (VoxelHashMap.cpp:97-119): group the
    frame by voxel, find-or-claim a slot per voxel, then run the sequential
    accept/reject loop over each voxel's candidates, vectorized across voxels.
    Every shape is fixed and nothing is read back to the host, so a CUDA
    graph holds the whole insert (`update`).
    """
    k = cfg.probe_length
    p = cfg.max_points_per_voxel
    dev = points.device
    shift = k.bit_length() - 1

    # Points outside the world key envelope are masked inside group_by_voxel
    # and counted here as a loud drop.
    oob = valid & ~voxel_ops.in_envelope(
        voxel_ops.point_to_voxel(points, cfg.voxel_size))
    num_oob = torch.sum(oob, dtype=torch.int32)
    groups = voxel_ops.group_by_voxel(
        points, valid, voxel_size=cfg.voxel_size, group_capacity=cfg.group_capacity)
    gvalid = groups.group_valid
    coords = groups.coords

    fp = fingerprint(coords)  # (V,)
    rows = window_row(coords, cfg.capacity_log2, k)  # (V,)

    # Phase A: existing slots (full-window fingerprint + exact key compare).
    fp_match = _window_fp(m.fprints, rows, k) == fp[:, None]  # (V, K)
    window_keys = m.vkeys.view(-1, k, 3)[rows]  # (V, K, 3)
    key_match = torch.all(window_keys == coords[:, None, :], dim=-1)
    exact = fp_match & key_match
    has_existing = torch.any(exact, dim=-1) & gvalid
    exist_pos = _first_true(exact)
    # A new voxel whose fingerprint equals a different voxel's in the same
    # window could be stored yet never found: refuse the claim (counted).
    shadowed = torch.any(fp_match & ~key_match, dim=-1)

    # Phase B: claim free slots for new voxels.
    pending0 = gvalid & ~has_existing & ~shadowed
    assigned, fprints, vkeys = _claim_slots(m.fprints, m.vkeys, coords, fp, rows, pending0,
                                            probe_length=k, capacity=cfg.capacity)
    dropped = torch.sum(gvalid & ~has_existing & (assigned < 0), dtype=torch.int32)

    slot = torch.where(has_existing, (rows << shift) + exist_pos, assigned)
    has_slot = gvalid & (slot >= 0)
    slot_safe = torch.where(has_slot, slot, torch.zeros_like(slot))

    # Phase C: sequential accept/reject of candidates, vectorized over voxels,
    # in decoded f32 (claimed slots have count 0, so their stale contents
    # are masked).
    stored = decode_points(cfg, _take_rows(m.points, slot_safe), coords[:, None, :])  # (V,P,3)
    cnt = torch.where(has_slot, m.counts[slot_safe], torch.zeros_like(m.counts[slot_safe]))
    res_sq = voxel_ops.f32_scalar(cfg.map_resolution_sq, dev)
    lanes = torch.arange(p, dtype=torch.int32, device=dev)
    inf = voxel_ops.f32_scalar(float("inf"), dev)
    added = torch.zeros((), dtype=torch.int32, device=dev)
    for j in range(cfg.group_capacity):
        cand = groups.candidates[:, j, :]  # (V, 3)
        cand_ok = groups.cand_valid[:, j] & has_slot
        diff = stored - cand[:, None, :]
        sq = diff * diff
        d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]  # (V, P)
        d2 = torch.where(lanes[None, :] < cnt[:, None], d2, inf)
        min_d2 = torch.min(d2, dim=-1).values
        accept = cand_ok & (cnt < p) & (min_d2 >= res_sq)
        write = (lanes[None, :] == cnt[:, None]) & accept[:, None]
        stored = torch.where(write[..., None], cand[:, None, :], stored)
        cnt = cnt + accept.to(torch.int32)
        added = added + torch.sum(accept, dtype=torch.int32)

    # Phase D: write every row back (re-encoded for u16 storage; the u16
    # roundtrip is a fixpoint, so untouched lanes keep their exact bits),
    # then the claimed fingerprints and keys.
    bits = _BITS[m.points.dtype]
    stored_out = encode_points(cfg, stored, coords[:, None, :])
    _write_rows(m.points.view(bits), slot_safe, stored_out.view(bits), has_slot)
    _write_rows(m.counts, slot_safe, cnt, has_slot)
    m.vkeys.copy_(vkeys)
    m.fprints.copy_(fprints)

    new_map = m._replace(
        total_points=m.total_points + added,
        num_dropped_voxels=m.num_dropped_voxels + dropped,
        num_oob_points=m.num_oob_points + num_oob,
    )
    return new_map, InsertStats(added, dropped, num_oob)


def trim(cfg: MapConfig, m: VoxelMap, origin: torch.Tensor) -> VoxelMap:
    """Remove, IN PLACE, voxels whose FIRST stored point is >= max_distance
    from `origin` (reference RemovePointsFarFromLocation,
    VoxelHashMap.cpp:121-132): count and fingerprint are zeroed."""
    first_pt = decode_points(cfg, m.points[:, 0, :], m.vkeys)  # (C, 3)
    diff = first_pt - origin[None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    kill = (m.counts > 0) & (d2 >= cfg.max_distance * cfg.max_distance)
    removed = torch.sum(torch.where(kill, m.counts, torch.zeros_like(m.counts)),
                        dtype=torch.int32)
    m.fprints.masked_fill_(kill, 0)
    m.counts.masked_fill_(kill, 0)
    return m._replace(total_points=m.total_points - removed)


def update(cfg: MapConfig, m: VoxelMap, pose: torch.Tensor, points: torch.Tensor,
           valid: torch.Tensor, *, graph: bool = True, keep: int = 1
           ) -> Tuple[VoxelMap, InsertStats]:
    """One frame's whole map update: the frame cloud `points` (N, 3) moved
    to the world by `pose` (4, 4), `insert`, then `trim` around the pose's
    position, every table IN PLACE, in the spans `kiss/map_insert` and
    `kiss/map_trim`.

    `graph`: the caller owns `m`'s tables (a step that donates its state),
    so that where `control.uses_graph` holds (CUDA tensors, no trace) the
    update is the replay of one CUDA graph (`control.graph_call`) inside
    `kiss/map_insert`: the tables keep their addresses, which key this
    graph (the first update of a set of tables captures it, every later one
    replays it) and the GN loop's. `keep`: the sets of tables the caller
    updates at once (the rows of a batch), whose graphs are all kept.
    Elsewhere the same work is called directly."""
    def run(pose, points, valid, total, dropped, oob, vkeys, fprints, counts, stored):
        new, stats = insert(cfg, VoxelMap(vkeys, fprints, counts, stored, total, dropped, oob),
                            se3.transform(pose, points), valid)
        new = trim(cfg, new, pose[:3, 3])
        return (new.total_points, new.num_dropped_voxels, new.num_oob_points, *stats)

    inputs = (pose, points, valid, m.total_points, m.num_dropped_voxels, m.num_oob_points)
    tables = (m.vkeys, m.fprints, m.counts, m.points)
    if not (graph and control.uses_graph(inputs + tables, (cfg,))):
        with trace.span("kiss/map_insert"):
            new_map, stats = insert(cfg, m, se3.transform(pose, points), valid)
        with trace.span("kiss/map_trim"):
            return trim(cfg, new_map, pose[:3, 3]), stats
    with trace.span("kiss/map_insert"):
        out = control.graph_call(run, "map", inputs=inputs, tables=tables, graph_key=(cfg,),
                                 keep=keep)
    new_map = m._replace(total_points=out[0], num_dropped_voxels=out[1], num_oob_points=out[2])
    return new_map, InsertStats(*out[3:])


def rebase(cfg: MapConfig, m: VoxelMap,
           shift_vox: torch.Tensor) -> Tuple[VoxelMap, torch.Tensor]:
    """Shift the map's world origin by `shift_vox` voxels (int (3,)): every
    live voxel key moves to `key - shift_vox`, and the table is rebuilt
    around the new keys through the same claim rounds as `insert`
    (JAX `hash_map.rebase`). This keeps a long drive inside the ±16383-voxel
    key envelope (voxel_ops.in_envelope); the caller shifts the pose by the
    same voxel multiple (odometry.rebase_state).

    f32 rows shift by `shift_vox * voxel_size` in f32, an exact voxel
    multiple; u16 rows are voxel-relative and move unchanged. Unlike
    `insert`, the rebuild writes into NEW tensors: `m` is left as it was.
    Voxels the rebuild cannot place are counted into `num_dropped_voxels`.

    Returns (rebased map, () int32 voxels dropped by the rebuild).
    """
    k = cfg.probe_length
    dev = m.counts.device
    shift = torch.as_tensor(shift_vox).to(device=dev, dtype=torch.int32)
    live = m.counts > 0
    new_coords = m.vkeys - shift[None, :]
    assigned, fprints, vkeys = _claim_slots(
        torch.zeros_like(m.fprints), torch.zeros_like(m.vkeys), new_coords,
        fingerprint(new_coords), window_row(new_coords, cfg.capacity_log2, k), live,
        probe_length=k, capacity=cfg.capacity)
    dropped = live & (assigned < 0)
    n_dropped_voxels = torch.sum(dropped, dtype=torch.int32)
    n_dropped_points = torch.sum(torch.where(dropped, m.counts, torch.zeros_like(m.counts)),
                                 dtype=torch.int32)

    # Move each placed row to its claimed slot. The claimed slots are
    # unique, so the scatter is deterministic.
    src = trace.read("map_rows", torch.nonzero, assigned >= 0).squeeze(1)
    dst = assigned[src]
    rows = _take_rows(m.points, src)
    if cfg.storage == "f32":
        rows = rows - (shift.to(torch.float32)
                       * voxel_ops.f32_scalar(cfg.voxel_size, dev))[None, None, :]
    bits = _BITS[m.points.dtype]
    points = torch.zeros_like(m.points.view(bits))
    points.index_copy_(0, dst, rows.view(bits))
    counts = torch.zeros_like(m.counts)
    counts.index_copy_(0, dst, m.counts[src])

    new_map = VoxelMap(
        vkeys=vkeys,
        fprints=fprints,
        counts=counts,
        points=points.view(m.points.dtype),
        total_points=m.total_points - n_dropped_points,
        num_dropped_voxels=m.num_dropped_voxels + n_dropped_voxels,
        num_oob_points=m.num_oob_points.clone(),
    )
    return new_map, n_dropped_voxels


def extract_points(cfg: MapConfig, m: VoxelMap) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dump the map to a padded (C*P, 3) cloud + mask (reference
    Pointcloud(), VoxelHashMap.cpp:72-81)."""
    p = cfg.max_points_per_voxel
    lanes = torch.arange(p, dtype=torch.int32, device=m.counts.device)
    mask = lanes[None, :] < m.counts[:, None]
    pts = decode_points(cfg, m.points, m.vkeys[:, None, :])
    return pts.reshape(-1, 3), mask.reshape(-1)


def is_empty(m: VoxelMap) -> torch.Tensor:
    return m.total_points == 0
