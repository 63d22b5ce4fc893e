"""Port compact view (kiss_icp_tpu_torch.ops.compact_map) against the JAX one.

`build_compact` packs the same live voxels into the same rows and builds the
same index, slot for slot, with the same `n_live` and `num_dropped`. The
compact modes query the sparse map in the port: its answers equal JAX's
queries of the view at the tolerance of tests/test_pallas_nn.py, and a
registration in a compact mode, with or without drops, gives the pose bits
of gather27 and JAX's drop count.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu.ops import compact_map as jcm
from kiss_icp_tpu.ops import hash_map as jhm
from kiss_icp_tpu.ops import registration as jreg
from kiss_icp_tpu_torch.ops import compact_map as cm
from kiss_icp_tpu_torch.ops import hash_map as hm
from kiss_icp_tpu_torch.ops import registration

torch.set_num_threads(1)

VIEW_FIELDS = ("ckeys", "ccounts", "cpoints", "hfp", "hval", "n_live", "num_dropped")


def _build_both(storage="f32", n_frames=3, seed=0):
    args = dict(voxel_size=1.0, max_distance=30.0, max_points_per_voxel=5,
                capacity_log2=12, probe_length=16, group_capacity=8, storage=storage)
    cfg, jcfg = hm.MapConfig(**args), jhm.MapConfig(**args)
    m, jm = hm.create_map(cfg), jhm.create_map(jcfg)
    rng = np.random.default_rng(seed)
    for _ in range(n_frames):
        pts = rng.uniform(-12.0, 12.0, size=(600, 3)).astype(np.float32)
        m, _ = hm.insert(cfg, m, torch.from_numpy(pts), torch.ones(600, dtype=torch.bool))
        jm, _ = jhm.insert(jcfg, jm, jnp.asarray(pts), jnp.ones((600,), bool))
    return cfg, m, jcfg, jm


def _views(cfg, m, jcfg, jm, **cargs):
    ccfg, jccfg = cm.CompactConfig(**cargs), jcm.CompactConfig(**cargs)
    return ccfg, cm.build_compact(cfg, ccfg, m), jccfg, jcm.build_compact(jcfg, jccfg, jm)


def _assert_views_equal(view, jview):
    for name in VIEW_FIELDS:
        ours = getattr(view, name)
        if ours.dtype == torch.uint16:
            ours = ours.view(torch.int16).numpy().view(np.uint16)
        else:
            ours = ours.numpy()
        np.testing.assert_array_equal(ours, np.asarray(getattr(jview, name)), err_msg=name)


@pytest.mark.parametrize("storage", ["f32", "u16"])
@pytest.mark.parametrize("live_log2,hash_log2", [(12, 14), (8, 10), (10, 12)])
def test_build_compact_slot_for_slot(storage, live_log2, hash_log2):
    cfg, m, jcfg, jm = _build_both(storage)
    ccfg, view, _, jview = _views(cfg, m, jcfg, jm, live_capacity_log2=live_log2,
                                  hash_capacity_log2=hash_log2)
    _assert_views_equal(view, jview)
    n_live = int((m.counts > 0).sum())
    assert int(view.n_live) == min(n_live, ccfg.live_capacity)
    assert int(view.num_dropped) >= n_live - ccfg.live_capacity


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_query_parity_exact(storage):
    """The port's answer in the compact modes (the sparse query) against
    JAX's query of its view: found equal, distances at rtol 1e-6."""
    cfg, m, jcfg, jm = _build_both(storage)
    _, view, jccfg, jview = _views(cfg, m, jcfg, jm, live_capacity_log2=12,
                                   hash_capacity_log2=14, probe_length=8)
    assert int(view.num_dropped) == int(jview.num_dropped) == 0
    rng = np.random.default_rng(1)
    q = rng.uniform(-14.0, 14.0, size=(512, 3)).astype(np.float32)
    valid = np.ones(512, bool)
    valid[500:] = False
    ref = hm.query_nearest(cfg, m, torch.from_numpy(q), torch.from_numpy(valid))
    f = ref.found.numpy()
    assert 100 < f.sum() < 500
    for query in (jcm.query_nearest_compact, jcm.query_nearest_compact_loop):
        jgot = query(jcfg, jccfg, jview, jnp.asarray(q), jnp.asarray(valid))
        np.testing.assert_array_equal(np.asarray(jgot.found), f)
        np.testing.assert_allclose(ref.distances.numpy()[f], np.asarray(jgot.distances)[f],
                                   rtol=1e-6)


def test_index_places_every_live_row():
    """Without drops, every live row sits in exactly one index slot of its
    own probe window, under its own fingerprint."""
    cfg, m, jcfg, jm = _build_both()
    ccfg, view, _, jview = _views(cfg, m, jcfg, jm, live_capacity_log2=12,
                                  hash_capacity_log2=14)
    n_live = int(view.n_live)
    assert int(view.num_dropped) == 0 and n_live > 1000
    slots = torch.nonzero(view.hfp != 0).squeeze(1)
    rows = view.hval[slots].long()
    assert torch.equal(torch.sort(rows).values, torch.arange(n_live))
    keys = view.ckeys[rows]
    assert torch.equal(view.hfp[slots], hm.fingerprint(keys))
    k = ccfg.probe_length
    assert torch.equal(slots // k, cm._hash_rows(keys, ccfg))


def test_trim_then_rebuild():
    cfg, m, jcfg, jm = _build_both()
    m = hm.trim(cfg, m, torch.tensor([11.0, 11.0, 11.0]))
    jm = jhm.trim(jcfg, jm, jnp.asarray([11.0, 11.0, 11.0], jnp.float32))
    _, view, _, jview = _views(cfg, m, jcfg, jm, live_capacity_log2=12,
                               hash_capacity_log2=14)
    _assert_views_equal(view, jview)
    assert int(view.n_live) == int((m.counts > 0).sum())


def test_full_index_window_is_lost_uncounted_as_in_jax():
    """The reference's fault, its count kept for parity (ROADMAP Queue 3): a
    row whose index window is full leaves the claim rounds unplaced and
    uncounted. Twelve live voxels whose keys all hash to index window 0 of
    an 8-slot-window index: 8 are placed, 4 are in no slot, and num_dropped
    stays 0, in JAX and in the port alike."""
    ccfg = cm.CompactConfig(live_capacity_log2=4, hash_capacity_log2=6, probe_length=8)
    cand = torch.stack([torch.arange(4000, dtype=torch.int32),
                        torch.zeros(4000, dtype=torch.int32),
                        torch.zeros(4000, dtype=torch.int32)], dim=1)
    keys = cand[cm._hash_rows(cand, ccfg) == 0][:12]
    assert len(keys) == 12
    args = dict(voxel_size=1.0, max_distance=1e5, max_points_per_voxel=2, capacity_log2=10)
    cfg, jcfg = hm.MapConfig(**args), jhm.MapConfig(**args)
    m = hm.create_map(cfg)
    slots = torch.arange(0, 12 * 16, 16)  # one voxel per sparse window
    m.vkeys[slots] = keys
    m.counts[slots] = 1
    m.points[slots, 0] = keys.float()
    jm = jhm.create_map(jcfg)._replace(vkeys=jnp.asarray(m.vkeys.numpy()),
                                        counts=jnp.asarray(m.counts.numpy()),
                                        points=jnp.asarray(m.points.numpy()))
    view = cm.build_compact(cfg, ccfg, m)
    jview = jcm.build_compact(jcfg, jcm.CompactConfig(live_capacity_log2=4,
                                                      hash_capacity_log2=6,
                                                      probe_length=8), jm)
    _assert_views_equal(view, jview)
    assert int(view.n_live) == 12 and int(view.num_dropped) == 0
    assert int((view.hfp != 0).sum()) == 8


def test_overflow_falls_back_to_sparse_query():
    """A view smaller than the map's live voxels, and one that holds them
    all: registration in the compact mode reports JAX's drop count, and its
    pose and iterations are gather27's bit for bit and JAX's (which falls
    back to the sparse map on an overflow) within 1e-5."""
    args = dict(voxel_size=1.0, max_distance=30.0, max_points_per_voxel=5,
                capacity_log2=12, probe_length=16, group_capacity=8)
    cfg, m, jcfg, jm = _build_both()
    n_live = int((m.counts > 0).sum())
    assert n_live > (1 << 8) and hm.MapConfig(**args) == cfg
    rng = np.random.default_rng(3)
    q = rng.uniform(-10.0, 10.0, size=(256, 3)).astype(np.float32)
    guess = np.eye(4, dtype=np.float32)
    guess[:3, 3] = [0.05, -0.03, 0.02]
    common = dict(max_iterations=20, convergence=1e-4)
    t_args = (torch.from_numpy(q), torch.ones(256, dtype=torch.bool), torch.from_numpy(guess),
              torch.tensor(1.5), torch.tensor(0.5))
    j_args = (jnp.asarray(q), jnp.ones(256, bool), jnp.asarray(guess), jnp.float32(1.5),
              jnp.float32(0.5))
    ref = registration.align_points_to_map(cfg, m, *t_args, nn_mode="gather27", **common)
    for live_log2, dropped in ((8, n_live - (1 << 8)), (12, 0)):
        got = registration.align_points_to_map(cfg, m, *t_args, nn_mode="compact",
                                               nn_live_capacity_log2=live_log2, **common)
        jgot = jreg.align_points_to_map(jcfg, jm, *j_args, nn_mode="compact",
                                        nn_live_capacity_log2=live_log2, **common)
        assert int(got.num_dropped_compact) == int(jgot.num_dropped_compact) == dropped
        assert torch.equal(got.pose, ref.pose)
        assert got.num_iterations == ref.num_iterations == int(jgot.num_iterations)
        assert int(got.num_correspondences) == int(ref.num_correspondences)
        np.testing.assert_allclose(got.pose.numpy(), np.asarray(jgot.pose), atol=1e-5)
