"""The map-sharded engine behind `engine.map_shards > 1`.

Port of `kiss_icp_tpu/parallel/sharded_engine.py`. `ShardedKissICP` is a
drop-in `odometry.KissICP` (numpy scans in, numpy poses out, the chunked
API, overflow counters, checkpoints, the rolling origin) backed by the
map-sharded step of parallel/sharded_map.py: the map's slots split into
`engine.map_shards` shards, the NN answers min-combined across them and
the normal equations summed over them, so that the trajectory matches the
single-device engine (tests/test_torch_sharded_engine.py).

`odometry.create_odometry(config)`, which the pipeline, the CLI and the ROS
node call, returns this engine when `engine.map_shards > 1`. On one card
all the shards sit side by side: the card holds the whole map, so the
per-device memory saving of the JAX engine needs one card a shard (a
process group of several ranks, each holding its shards; see
parallel/grid.py). The host-side parts that read the whole map
(checkpoints, `local_map_points`, the re-base, `shard_occupancy`) gather
the shards of every rank first.
"""

from __future__ import annotations

import numpy as np
import torch

from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.ops import hash_map
from kiss_icp_tpu_torch.parallel import sharded_map
from kiss_icp_tpu_torch.parallel.grid import DeviceMesh
from kiss_icp_tpu_torch.parallel.sharded_map import MAP_AXIS, ShardedMapState

_MAP_LEAVES = ("vkeys", "fprints", "counts", "points", "total_points",
               "num_dropped_voxels", "num_oob_points")


def make_map_mesh(config: KISSConfig, device=None) -> DeviceMesh:
    """A ("map",) grid of engine.map_shards shards (validated) over the
    ranks of the initialised process group, or this process alone."""
    d = int(config.engine.map_shards)
    if d < 2:
        raise ValueError(f"map_shards must be >= 2 for the sharded engine, got {d}")
    mesh = sharded_map.map_mesh(d, device)
    sharded_map.local_map_config(config, mesh)  # a power of two below the capacity
    return mesh


class ShardedKissICP(odometry.KissICP):
    """KissICP with the local map sharded over `engine.map_shards` shards.

    The host side (padding, truncation accounting, the chunked API, the
    rolling origin) is inherited; the device step and the state differ.
    The per-frame step returns the deskewed frame and the ICP source like
    the single-device FrameResult, so the visualizer path works unchanged.
    The engine owns its state and always donates it."""

    def __init__(self, config: KISSConfig, mesh: DeviceMesh = None, device=None):
        self._mesh = mesh if mesh is not None else make_map_mesh(config, device)
        self._axis = self._mesh.axis(MAP_AXIS)
        self._mcfg_local = sharded_map.local_map_config(config, self._mesh)
        super().__init__(config, device=self._mesh.device)

    @property
    def mesh(self) -> DeviceMesh:
        return self._mesh

    def _init_state(self) -> ShardedMapState:
        return sharded_map.init_sharded_state(self.config, self._mesh)

    def _frame_step(self, state, points, timestamps, valid):
        return sharded_map.frame_step_shard(self.config, self._mcfg_local, self._axis, state,
                                            points, timestamps, valid, with_points=True)

    def _make_chunk_step(self):
        return sharded_map.make_map_sharded_chunked_step(self.config, self._mesh, donate=True)

    def _summary_poses(self, summary):
        # ShardFrameResult's stacked pose field is named `pose`.
        return summary.pose

    # --- the whole map, across the ranks ------------------------------------

    def global_state(self) -> ShardedMapState:
        """The state with the map leaves of every rank's shards, in shard
        order (the state itself when this process holds all of them)."""
        if self._axis.ranks == 1:
            return self.state
        return self.state._replace(**{n: self._axis.gather(getattr(self.state, n))
                                      for n in _MAP_LEAVES})

    def _set_global(self, state: ShardedMapState) -> None:
        """Keep this process's shards of a whole-map state, on its device."""
        ax = self._axis
        cl = self._mcfg_local.capacity

        def block(name, t):
            if ax.ranks > 1 and name in _MAP_LEAVES:
                per = 1 if name in _MAP_LEAVES[4:] else cl
                t = t[ax.offset * per:(ax.offset + ax.local) * per]
            bits = hash_map._BITS.get(t.dtype, t.dtype)
            return t.view(bits).to(self.device).contiguous().view(t.dtype)

        self.state = ShardedMapState(*(
            block(n, t) if n != "threshold" else type(t)(*(x.to(self.device) for x in t))
            for n, t in zip(ShardedMapState._fields, state)))

    def save_checkpoint(self, path) -> None:
        """Persist the whole sharded state and the rolling origin
        (io/checkpoint.py, the JAX package's format with `map_shards` in
        its record). Every rank gathers the shards; the first one writes."""
        from kiss_icp_tpu_torch.io import checkpoint

        state = self.global_state()
        if self._axis.index == 0:
            checkpoint.save_checkpoint(path, state, self.config,
                                       extras={"origin": self.origin})

    def load_checkpoint(self, path) -> None:
        """Restore a state saved by either package's sharded engine with the
        same shard count (anything else raises), and its rolling origin."""
        from kiss_icp_tpu_torch.io import checkpoint

        self._set_global(checkpoint.load_checkpoint(path, self.config, "cpu"))
        # The rolling origin travels with the checkpoint; a stale origin of
        # this engine's own past must not survive.
        self.origin = np.asarray(
            checkpoint.load_extra(path, "origin", np.zeros(3)), np.float64)

    def local_map_points(self) -> np.ndarray:
        """World-frame dump of the sharded map (reference Pointcloud(),
        VoxelHashMap.cpp:72-81), gathered from every shard; for
        visualization and tests, not the hot path."""
        st = self.global_state()
        m = hash_map.VoxelMap(st.vkeys, st.fprints, st.counts, st.points, None, None, None)
        pts, mask = hash_map.extract_points(odometry.map_config(self.config), m)
        return pts[mask].double().cpu().numpy() + self.origin

    def _apply_rebase(self, shift_vox: np.ndarray) -> int:
        """Cross-shard rolling-origin re-base (see hash_map.rebase for the
        single-device contract). Shifted keys hash to other owning shards,
        so the rebuild is a cross-shard exchange; at re-base cadence (once
        per `rebase_trigger_voxels` of travel) it runs on the host with
        numpy, as in the JAX package: placement in ascending old global
        slot order (the claim rounds' lowest row wins), u16 rows kept bit
        for bit (voxel-relative offsets are shift-invariant). Slot for slot
        the JAX engine's tables. Returns the voxels it dropped."""
        mcfg_local = self._mcfg_local
        d = self._axis.extent
        cl, k = mcfg_local.capacity, mcfg_local.probe_length
        v = float(mcfg_local.voxel_size)
        st = self.global_state()

        def host(t):
            bits = hash_map._BITS.get(t.dtype, t.dtype)
            a = t.view(bits).cpu().numpy()
            return a.view(np.uint16) if t.dtype == torch.uint16 else a

        vkeys, counts, points = host(st.vkeys), host(st.counts), host(st.points)
        new_keys = vkeys - shift_vox[None, :].astype(np.int32)
        if mcfg_local.storage == "f32":
            points = points - (shift_vox.astype(np.float32) * np.float32(v))[None, None, :]
        live_idx = np.flatnonzero(counts > 0)
        keys_live = new_keys[live_idx]
        kt = torch.from_numpy(np.ascontiguousarray(keys_live))
        shard = sharded_map.shard_of(kt, d).numpy()
        fp = hash_map.fingerprint(kt).numpy()
        rows = hash_map.window_row(kt, mcfg_local.capacity_log2, k).numpy()

        # Sequential placement in ascending old-slot order, vectorized:
        # within a window survivors take free slots in old-slot order; a
        # voxel whose window already holds an earlier voxel with the same
        # fingerprint drops (shadow pair); rank >= probe_length drops.
        win = shard.astype(np.int64) * (cl // k) + rows.astype(np.int64)
        n_live = len(live_idx)
        pos = np.arange(n_live)
        order_fp = np.lexsort((pos, fp, win))
        w_s, f_s = win[order_fp], fp[order_fp]
        dup_sorted = np.concatenate([[False], (w_s[1:] == w_s[:-1]) & (f_s[1:] == f_s[:-1])])
        shadowed = np.zeros(n_live, bool)
        shadowed[order_fp] = dup_sorted
        order_w = np.lexsort((pos, win))
        w_o = win[order_w]
        surv_o = (~shadowed)[order_w].astype(np.int64)
        csum = np.cumsum(surv_o)
        head = np.concatenate([[True], w_o[1:] != w_o[:-1]])
        seg_base = np.zeros(n_live, np.int64)
        seg_base[head] = csum[head] - surv_o[head]
        seg_base = np.maximum.accumulate(np.where(head, seg_base, np.int64(-1)))
        rank = np.empty(n_live, np.int64)
        rank[order_w] = csum - surv_o - seg_base
        placed = ~shadowed & (rank < k)
        slots = win * k + rank  # global slot = (shard * cl/k + row) * k + rank

        out_vkeys = np.zeros_like(vkeys)
        out_fp = np.zeros(d * cl, np.int32)
        out_counts = np.zeros(d * cl, np.int32)
        out_points = np.zeros_like(points)
        src, dst = live_idx[placed], slots[placed]
        out_fp[dst] = fp[placed]
        out_vkeys[dst] = keys_live[placed]
        out_counts[dst] = counts[src]
        out_points[dst] = points[src]
        totals = np.bincount(shard[placed], weights=counts[src], minlength=d).astype(np.int32)
        dropped = int(n_live - placed.sum())

        pose = st.pose.double().cpu().numpy()
        pose[:3, 3] -= shift_vox.astype(np.float64) * v
        drops = st.num_dropped_voxels.cpu().numpy().copy()
        drops[0] += dropped

        def tensor(a):
            if a.dtype == np.uint16:
                return torch.from_numpy(a.view(np.int16)).view(torch.uint16)
            return torch.from_numpy(np.ascontiguousarray(a))

        self._set_global(st._replace(
            pose=tensor(pose.astype(np.float32)), vkeys=tensor(out_vkeys),
            fprints=tensor(out_fp), counts=tensor(out_counts), points=tensor(out_points),
            total_points=tensor(totals), num_dropped_voxels=tensor(drops)))
        return dropped

    def shard_occupancy(self) -> np.ndarray:
        """(D,) live-voxel count per shard: the load-balance diagnostic."""
        return sharded_map.shard_live_voxels(self.global_state(),
                                             self._axis.extent).cpu().numpy()
