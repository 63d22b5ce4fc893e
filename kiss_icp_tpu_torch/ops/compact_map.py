"""Per-frame compacted view of the voxel map (nn_modes "compact", "compact_loop").

Port of `kiss_icp_tpu/ops/compact_map.py`. The sparse map (ops/hash_map.py)
keeps 2^19 slots at a few percent occupancy; once per frame the live voxels
are packed, in slot order, into a dense view:

  * `ckeys / ccounts / cpoints`: the live voxels in `live_capacity` rows;
  * `hfp / hval`: a small open-addressing index (fingerprint -> row), four
    times the live capacity, built by the deterministic scatter-min claim
    rounds of `hash_map._claim_slots`, here a `control.while_loop` (one
    host read per round when run live).

The JAX package queries the view in these modes; its answers are those of
the sparse query. The port queries the sparse map (the fused NN kernel,
kernels/nn27.py, on the card, which gathers only the rows it reads) and
builds the view for its drop count alone: a live voxel the view cannot hold
(more live voxels than rows, or a fingerprint that would shadow another
voxel's in its index window) is counted into the frame's dropped map
voxels, as in JAX. Plain PyTorch on both devices: the JAX package has no
Pallas kernel for the view.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from kiss_icp_tpu_torch.ops import control
from kiss_icp_tpu_torch.ops.hash_map import (MapConfig, VoxelMap, _first_true,
                                             _take_rows, _window_fp, fingerprint,
                                             window_row)


@dataclass(frozen=True)
class CompactConfig:
    """Shape plan of the view: `live_capacity_log2` bounds the live voxels it
    holds; `hash_capacity_log2` should be live + 2 (load factor 0.25)."""

    live_capacity_log2: int = 14
    hash_capacity_log2: int = 16
    probe_length: int = 8

    @property
    def live_capacity(self) -> int:
        return 1 << self.live_capacity_log2

    @property
    def hash_capacity(self) -> int:
        return 1 << self.hash_capacity_log2


class CompactMap(NamedTuple):
    """Dense, read-only view of the live voxels (device tensors)."""

    ckeys: torch.Tensor  # (L, 3) int32 voxel coords (slot 0's beyond n_live)
    ccounts: torch.Tensor  # (L,) int32, 0 beyond n_live
    cpoints: torch.Tensor  # (L, P, 3) map-storage dtype (f32 or u16)
    hfp: torch.Tensor  # (H,) int32 fingerprint, 0 = free
    hval: torch.Tensor  # (H,) int32 row of that fingerprint's voxel
    n_live: torch.Tensor  # () int32
    num_dropped: torch.Tensor  # () int32 live voxels the view cannot answer for


def _hash_rows(coords: torch.Tensor, ccfg: CompactConfig) -> torch.Tensor:
    """Aligned probe-window row of each voxel in the view's index."""
    return window_row(coords, ccfg.hash_capacity_log2, ccfg.probe_length)


def build_compact(mcfg: MapConfig, ccfg: CompactConfig, m: VoxelMap) -> CompactMap:
    """Pack the live voxels of `m` into the view, in slot order (JAX
    `compact_map.build_compact`: `jnp.nonzero(size=L, fill_value=0)`, here
    `torch.nonzero_static`, so every shape is static)."""
    l_cap, h_cap, k = ccfg.live_capacity, ccfg.hash_capacity, ccfg.probe_length
    dev = m.counts.device
    i32 = dict(dtype=torch.int32, device=dev)

    live = m.counts > 0
    n_live_total = torch.sum(live, dtype=torch.int32)
    slot_idx = torch.nonzero_static(live, size=l_cap, fill_value=0).squeeze(1)
    n_live = torch.clamp(n_live_total, max=l_cap)
    rows = torch.arange(l_cap, **i32)
    row_valid = rows < n_live

    ckeys = m.vkeys[slot_idx]
    ccounts = torch.where(row_valid, m.counts[slot_idx], torch.zeros_like(rows))
    cpoints = _take_rows(m.points, slot_idx)

    # The index: claim rounds as in hash_map._claim_slots (the lowest row
    # wins a contested slot; winners are scattered into tables one row
    # longer, where every other row lands in the extra row). Keys are
    # unique, so a fingerprint already in a pending row's window belongs to
    # another voxel: placing the row would make one of the two unfindable
    # (lookups stop at the first match), so it is refused and counted.
    fp = fingerprint(ckeys)
    hrows = _hash_rows(ckeys, ccfg)
    shift = k.bit_length() - 1
    dump = torch.full_like(hrows, h_cap)

    def cond(hfp, hval, pending, n_shadowed):
        return torch.any(pending)

    def body(hfp, hval, pending, n_shadowed):
        wfp = _window_fp(hfp[:h_cap], hrows, k)  # (L, K)
        shadowed = pending & torch.any(wfp == fp[:, None], dim=-1)
        pending = pending & ~shadowed
        n_shadowed = n_shadowed + torch.sum(shadowed, dtype=torch.int32)
        free = wfp == 0
        any_free = torch.any(free, dim=-1)
        tgt_slot = (hrows << shift) + _first_true(free)
        attempt = pending & any_free
        claims = torch.full((h_cap + 1,), l_cap, **i32).scatter_reduce(
            0, torch.where(attempt, tgt_slot, dump),
            torch.where(attempt, rows, torch.full_like(rows, l_cap)), "amin")
        won = attempt & (claims[torch.clamp(tgt_slot, max=h_cap - 1)] == rows)
        dst = torch.where(won, tgt_slot, dump)
        hfp = hfp.index_put((dst,), fp)
        hval = hval.index_put((dst,), rows)
        # A row whose window is full leaves the rounds unplaced and, as in
        # JAX (whose `dropped_hash` is always 0), uncounted: a fault of the
        # reference, kept for parity (ROADMAP Queue 3).
        return hfp, hval, pending & ~won & any_free, n_shadowed

    hfp, hval, _, n_shadowed = control.while_loop(cond, body, (
        torch.zeros(h_cap + 1, **i32), torch.zeros(h_cap + 1, **i32), row_valid,
        torch.zeros((), **i32)), "compact_claim")
    dropped = (n_live_total - n_live) + n_shadowed
    return CompactMap(ckeys, ccounts, cpoints, hfp[:h_cap], hval[:h_cap], n_live, dropped)
