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
             run as a host loop with one scalar read per round.

Memory: the map is 2^19 slots by default (126 MB of f32 points), so `insert`
and `trim` update the VoxelMap's tensors IN PLACE and return a VoxelMap that
shares them; the map passed in must not be used afterwards (the JAX package
donates the buffers for the same reason). `rebase`, which runs every few
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


def _candidate_slab(cfg: MapConfig, m: VoxelMap, queries: torch.Tensor):
    """Each query's 27-voxel candidate points: (pts (N,27,P,3), d2 (N,27,P)
    with +inf on unusable lanes)."""
    k = cfg.probe_length
    p = cfg.max_points_per_voxel
    dev = queries.device

    qvox = voxel_ops.point_to_voxel(queries, cfg.voxel_size)  # (N, 3)
    neigh = qvox[:, None, :] + neighbor_shifts(dev)[None, :, :]  # (N, 27, 3)
    target_fp = fingerprint(neigh)  # (N, 27)
    rows = window_row(neigh, cfg.capacity_log2, k)  # (N, 27)

    match = _window_fp(m.fprints, rows, k) == target_fp[..., None]  # (N, 27, K)
    has_voxel = torch.any(match, dim=-1)
    slot = (rows << (k.bit_length() - 1)) + _first_true(match)
    # A fingerprint collision inside the window must never surface another
    # voxel's points as this voxel's.
    has_voxel = has_voxel & torch.all(m.vkeys[slot] == neigh, dim=-1)
    slot = torch.where(has_voxel, slot, torch.zeros_like(slot))

    cnt = m.counts[slot]  # (N, 27)
    pts = decode_points(cfg, _take_rows(m.points, slot), neigh[..., None, :])  # (N,27,P,3)

    # d2 = (dx^2 + dy^2) + dz^2, each step rounded: the NN kernel computes
    # it in exactly this order, so both give identical bits.
    diff = queries[:, None, None, :] - pts
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1]) + sq[..., 2]  # (N, 27, P)
    lanes = torch.arange(p, dtype=torch.int32, device=dev)
    usable = (lanes[None, None, :] < cnt[..., None]) & has_voxel[..., None]
    d2 = torch.where(usable, d2, torch.full_like(d2, float("inf")))
    return pts, d2


def query_nearest(cfg: MapConfig, m: VoxelMap, queries: torch.Tensor,
                  valid: torch.Tensor) -> QueryResult:
    """Closest map point among the 27 voxels around each query point: the
    plain PyTorch version of the fused NN kernel (kernels/nn27.py).

    Exact equivalent of VoxelHashMap::GetClosestNeighbor (VoxelHashMap.cpp:
    46-70): ties go to the lowest (neighbor, lane) index. A query with no
    candidate gets a zero neighbor and an infinite distance.
    """
    n = queries.shape[0]
    p = cfg.max_points_per_voxel
    pts, d2 = _candidate_slab(cfg, m, queries)

    d2_flat = d2.reshape(n, 27 * p)
    best = torch.argmin(d2_flat, dim=-1)  # first minimum
    best_d2 = torch.gather(d2_flat, 1, best[:, None])[:, 0]
    nn = pts.reshape(n, 27 * p, 3)[torch.arange(n, device=queries.device), best]
    has = torch.isfinite(best_d2)
    nn = torch.where(has[:, None], nn, torch.zeros_like(nn))
    return QueryResult(nn, torch.sqrt(best_d2), has & valid)


def _claim_slots(fprints, vkeys, coords, fp, rows, pending, *,
                 probe_length: int, capacity: int) -> torch.Tensor:
    """Deterministic free-slot claiming for a batch of new voxels, writing
    the winners into `fprints` / `vkeys` IN PLACE.

    Each pending row tries the first free slot of its window; scatter-min
    rounds let the lowest row index win a contested slot. Rows whose window
    is full, or whose fingerprint would shadow a DIFFERENT voxel's equal
    fingerprint in the window, end unassigned (-1) — a counted drop, never a
    silent hole. One scalar read per round. Returns `assigned` (V,) int64.
    """
    k, cap = probe_length, capacity
    shift = k.bit_length() - 1
    v = coords.shape[0]
    dev = coords.device
    row_ids = torch.arange(v, dtype=torch.int64, device=dev)
    assigned = torch.full((v,), -1, dtype=torch.int64, device=dev)
    while bool(torch.any(pending)):
        free = _window_fp(fprints, rows, k) == 0  # (V, K)
        any_free = torch.any(free, dim=-1)
        tgt_slot = (rows << shift) + _first_true(free)
        attempt = pending & any_free
        claim_idx = torch.where(attempt, tgt_slot, torch.full_like(tgt_slot, cap))
        claims = torch.full((cap + 1,), v, dtype=torch.int64, device=dev)
        claims.scatter_reduce_(0, claim_idx,
                               torch.where(attempt, row_ids, torch.full_like(row_ids, v)),
                               "amin")
        won = attempt & (claims[torch.clamp(tgt_slot, max=cap - 1)] == row_ids)
        slots = tgt_slot[won]
        fprints[slots] = fp[won]
        vkeys[slots] = coords[won]
        assigned = torch.where(won, tgt_slot, assigned)
        # Within one round a window admits one winner, so shadowing can only
        # form across rounds: drop rows whose window just gained an
        # equal-fingerprint entry of another voxel.
        wk2 = vkeys.view(-1, k, 3)[rows]
        now_shadowed = torch.any(
            (_window_fp(fprints, rows, k) == fp[:, None])
            & ~torch.all(wk2 == coords[:, None, :], dim=-1),
            dim=-1,
        )
        pending = pending & ~won & any_free & ~now_shadowed
    return assigned


class InsertStats(NamedTuple):
    num_added_points: torch.Tensor  # () int32
    num_dropped_voxels: torch.Tensor  # () int32 — new voxels with no free slot
    num_oob_points: torch.Tensor  # () int32 — input POINTS outside the envelope


def insert(cfg: MapConfig, m: VoxelMap, points: torch.Tensor,
           valid: torch.Tensor) -> Tuple[VoxelMap, InsertStats]:
    """Add one frame of world-frame points to the map, IN PLACE.

    Mirrors VoxelHashMap::AddPoints (VoxelHashMap.cpp:97-119): group the
    frame by voxel, find-or-claim a slot per voxel, then run the sequential
    accept/reject loop over each voxel's candidates, vectorized across voxels.
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
    assigned = _claim_slots(m.fprints, m.vkeys, coords, fp, rows, pending0,
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

    # Phase D: write rows back (re-encoded for u16 storage; the u16
    # roundtrip is a fixpoint, so untouched lanes keep their exact bits).
    slots = slot_safe[has_slot]
    stored_out = encode_points(cfg, stored[has_slot], coords[has_slot][:, None, :])
    bits = _BITS[m.points.dtype]
    m.points.view(bits)[slots] = stored_out.view(bits)
    m.counts[slots] = cnt[has_slot]

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
    fprints = torch.zeros_like(m.fprints)
    vkeys = torch.zeros_like(m.vkeys)
    assigned = _claim_slots(fprints, vkeys, new_coords,
                            fingerprint(new_coords),
                            window_row(new_coords, cfg.capacity_log2, k), live,
                            probe_length=k, capacity=cfg.capacity)
    dropped = live & (assigned < 0)
    n_dropped_voxels = torch.sum(dropped, dtype=torch.int32)
    n_dropped_points = torch.sum(torch.where(dropped, m.counts, torch.zeros_like(m.counts)),
                                 dtype=torch.int32)

    # Move each placed row to its claimed slot. The claimed slots are
    # unique, so the scatter is deterministic.
    src = torch.nonzero(assigned >= 0).squeeze(1)
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
