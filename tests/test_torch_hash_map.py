"""Port voxel hash map (kiss_icp_tpu_torch.ops.hash_map) against the JAX one.

Hashes, fingerprints and probe rows are integer functions and must be
bit-equal. Inserts are deterministic claim rounds, so after the same inserts
both maps hold the same `vkeys`, `fprints`, `counts` and `points` slot for
slot. `query_nearest` (the plain version of the port's NN kernel) is held to
the JAX query and to the Pallas fused query (interpret mode) at the
tolerance of tests/test_pallas_nn.py: found equal, distances rtol 1e-6 (XLA
contracts the JAX d2 into FMAs, the port rounds every step), and the
returned neighbour at the nearest distance (rtol 1e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu.ops import hash_map as jhm
from kiss_icp_tpu.ops import pallas_nn
from kiss_icp_tpu_torch.kernels import cases
from kiss_icp_tpu_torch.ops import hash_map as hm

torch.set_num_threads(1)

MAP_FIELDS = ("vkeys", "fprints", "counts", "points", "total_points",
              "num_dropped_voxels", "num_oob_points")


def _configs(storage, max_points=5, capacity_log2=12, **kw):
    args = dict(voxel_size=1.0, max_distance=30.0, max_points_per_voxel=max_points,
                capacity_log2=capacity_log2, storage=storage, **kw)
    return hm.MapConfig(**args), jhm.MapConfig(**args)


def _assert_maps_equal(m, jm):
    for name in MAP_FIELDS:
        np.testing.assert_array_equal(getattr(m, name).numpy(),
                                      np.asarray(getattr(jm, name)), err_msg=name)


def _build_both(storage, max_points=5, capacity_log2=12, n=700, spread=12.0,
                seed=0, **kw):
    cfg, jcfg = _configs(storage, max_points, capacity_log2, **kw)
    m, jm = hm.create_map(cfg), jhm.create_map(jcfg)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        pts = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
        valid = rng.random(n) > 0.05
        m, st = hm.insert(cfg, m, torch.from_numpy(pts), torch.from_numpy(valid))
        jm, jst = jhm.insert(jcfg, jm, jnp.asarray(pts), jnp.asarray(valid))
        for a, b in zip(st, jst):
            assert int(a) == int(b)
    return cfg, m, jcfg, jm


def test_hash_fingerprint_window_bit_equal():
    rng = np.random.default_rng(0)
    coords = rng.integers(-2**31, 2**31 - 1, (5000, 3), dtype=np.int64).astype(np.int32)
    coords[:1000] = rng.integers(-40, 40, (1000, 3))
    t, j = torch.from_numpy(coords), jnp.asarray(coords)
    np.testing.assert_array_equal(hm._hash_coords(t).numpy().astype(np.uint32),
                                  np.asarray(jhm._hash_coords(j)))
    np.testing.assert_array_equal(hm.fingerprint(t).numpy(), np.asarray(jhm.fingerprint(j)))
    assert hm.fingerprint(t).dtype == torch.int32
    for cap_log2, k in ((19, 16), (12, 8), (4, 16), (3, 8)):  # last two: row_bits <= 0
        np.testing.assert_array_equal(hm.window_row(t, cap_log2, k).numpy(),
                                      np.asarray(jhm.window_row(j, cap_log2, k)))
    np.testing.assert_array_equal(hm._NEIGHBOR_SHIFTS, jhm._NEIGHBOR_SHIFTS)


def test_fingerprint_zero_maps_to_one(monkeypatch):
    """0 marks a free slot, so a hash that mixes to 0 must give 1. No small
    coordinate hashes to 0; force the case by zeroing the final mix."""
    coords = torch.tensor([[1, 2, 3], [-4, 5, -6]], dtype=torch.int32)
    jcoords = jnp.asarray(coords.numpy())
    real_mix, real_jmix = hm._mix, jhm._mix
    monkeypatch.setattr(hm, "_mix", lambda h: real_mix(h) * 0)
    monkeypatch.setattr(jhm, "_mix", lambda h: real_jmix(h) * 0)
    np.testing.assert_array_equal(hm.fingerprint(coords).numpy(), [1, 1])
    np.testing.assert_array_equal(np.asarray(jhm.fingerprint(jcoords)), [1, 1])


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_encode_decode_match(storage):
    cfg, jcfg = _configs(storage)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-20, 20, (1000, 3)).astype(np.float32)
    keys = np.floor(pts / np.float32(1.0)).astype(np.int32)
    enc = hm.encode_points(cfg, torch.from_numpy(pts), torch.from_numpy(keys))
    jenc = jhm.encode_points(jcfg, jnp.asarray(pts), jnp.asarray(keys))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jenc))
    dec = hm.decode_points(cfg, enc, torch.from_numpy(keys))
    jdec = jhm.decode_points(jcfg, jenc, jnp.asarray(keys))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))


@pytest.mark.parametrize("storage", ["f32", "u16"])
@pytest.mark.parametrize("max_points", [5, 20])
def test_three_inserts_slot_for_slot(storage, max_points):
    _, m, _, jm = _build_both(storage, max_points)
    _assert_maps_equal(m, jm)
    assert int(m.total_points) > 1000


def test_insert_overflow_and_envelope_match():
    """A 256-slot table takes ~1000 new voxels: claim rounds contend and
    drop; far points leave the key envelope and are counted."""
    cfg, jcfg = _configs("f32", 5, capacity_log2=8)
    m, jm = hm.create_map(cfg), jhm.create_map(jcfg)
    rng = np.random.default_rng(2)
    for _ in range(2):
        pts = rng.uniform(-12, 12, (600, 3)).astype(np.float32)
        pts[:5] = 2e4
        valid = np.ones(600, bool)
        m, _ = hm.insert(cfg, m, torch.from_numpy(pts), torch.from_numpy(valid))
        jm, _ = jhm.insert(jcfg, jm, jnp.asarray(pts), jnp.asarray(valid))
    _assert_maps_equal(m, jm)
    assert int(m.num_dropped_voxels) > 0 and int(m.num_oob_points) == 10


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_trim_extract_is_empty(storage):
    cfg, m, jcfg, jm = _build_both(storage, 5, spread=40.0, n=900)
    origin = np.array([15.0, -3.0, 1.0], np.float32)
    m = hm.trim(cfg, m, torch.from_numpy(origin))
    jm = jhm.trim(jcfg, jm, jnp.asarray(origin))
    _assert_maps_equal(m, jm)
    pts, mask = hm.extract_points(cfg, m)
    jpts, jmask = jhm.extract_points(jcfg, jm)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    # u16 decode is stored * (v/65535) + corner: XLA fuses it into one FMA,
    # the port rounds the product first, so coordinates may differ by 1 ulp.
    np.testing.assert_allclose(pts.numpy()[mask.numpy()],
                               np.asarray(jpts)[np.asarray(jmask)],
                               rtol=2.5e-7, atol=0)
    assert not bool(hm.is_empty(m))
    assert bool(hm.is_empty(hm.create_map(cfg)))


@pytest.mark.parametrize("storage", ["f32", "u16"])
@pytest.mark.parametrize("max_points", [5, 20])
def test_query_nearest_matches_jax_and_fused(storage, max_points):
    cfg, m, jcfg, jm = _build_both(storage, max_points)
    rng = np.random.default_rng(1)
    q = rng.uniform(-14, 14, size=(300, 3)).astype(np.float32)
    valid = np.r_[np.ones(290, bool), np.zeros(10, bool)]
    got = hm.query_nearest(cfg, m, torch.from_numpy(q), torch.from_numpy(valid))
    for ref in (jhm.query_nearest(jcfg, jm, jnp.asarray(q), jnp.asarray(valid)),
                pallas_nn.query_nearest_fused(jcfg, jm, jnp.asarray(q),
                                              jnp.asarray(valid), interpret=True)):
        f = np.asarray(ref.found)
        np.testing.assert_array_equal(got.found.numpy(), f)
        np.testing.assert_allclose(got.distances.numpy()[f],
                                   np.asarray(ref.distances)[f], rtol=1e-6)
        d_got = np.linalg.norm(q[f] - got.neighbors.numpy()[f], axis=1)
        np.testing.assert_allclose(d_got, np.asarray(ref.distances)[f], rtol=1e-5)
    assert got.found.numpy().sum() > 100
    # Queries with no map point around them: +inf distance, zero neighbour.
    nf = ~np.isfinite(got.distances.numpy())
    np.testing.assert_array_equal(got.neighbors.numpy()[nf], 0.0)


def test_query_empty_map_and_tie():
    cfg, jcfg = _configs("f32", capacity_log2=10)
    got = hm.query_nearest(cfg, hm.create_map(cfg), torch.zeros(64, 3),
                           torch.ones(64, dtype=torch.bool))
    assert not bool(got.found.any()) and bool(torch.isinf(got.distances).all())
    # Two stored points equidistant from the query: the lowest flat
    # (neighbour, lane) index wins, as in the JAX flat argmin.
    cfg, jcfg = _configs("f32", 4, capacity_log2=10)
    pts = np.array([[0.5, 0.5, 0.25], [0.5, 0.5, 0.75]], np.float32)
    m, _ = hm.insert(cfg, hm.create_map(cfg), torch.from_numpy(pts),
                     torch.ones(2, dtype=torch.bool))
    jm, _ = jhm.insert(jcfg, jhm.create_map(jcfg), jnp.asarray(pts), jnp.ones(2, bool))
    q = np.array([[0.5, 0.5, 0.5]], np.float32)
    got = hm.query_nearest(cfg, m, torch.from_numpy(q), torch.ones(1, dtype=torch.bool))
    ref = jhm.query_nearest(jcfg, jm, jnp.asarray(q), jnp.ones(1, bool))
    np.testing.assert_array_equal(got.neighbors.numpy(), np.asarray(ref.neighbors))
    np.testing.assert_array_equal(got.neighbors.numpy(), pts[:1])


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_query_hand_made_rules_match_jax(name):
    """The rules the card holds K2 to, on maps built with numpy and handed to
    both packages: a tie across neighbour voxels goes to the lower
    neighbour index, the first fingerprint match in a probe window decides
    (a different key there means the voxel is absent), and a NaN distance
    wins the argmin (NaN distance, not found)."""
    case = cases.CASES[name]()
    cfg, m = cases.to_map(case)
    got = hm.query_nearest(cfg, m, torch.from_numpy(case.queries),
                           torch.from_numpy(case.valid))
    jcfg = jhm.MapConfig(**case.config)
    a = {k: jnp.asarray(v) for k, v in case.arrays.items()}
    zero = jnp.zeros((), jnp.int32)
    jm = jhm.VoxelMap(a["vkeys"], a["fprints"], a["counts"], a["points"],
                      jnp.sum(a["counts"]), zero, zero)
    q, valid = jnp.asarray(case.queries), jnp.asarray(case.valid)
    for ref in (jhm.query_nearest(jcfg, jm, q, valid),
                pallas_nn.query_nearest_fused(jcfg, jm, q, valid, interpret=True)):
        f = np.asarray(ref.found)  # JAX leaves the neighbour undefined elsewhere
        np.testing.assert_array_equal(got.found.numpy(), f)
        np.testing.assert_allclose(got.distances.numpy(), np.asarray(ref.distances),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got.neighbors.numpy()[f], np.asarray(ref.neighbors)[f])
    np.testing.assert_array_equal(got.found.numpy(), case.found)
    np.testing.assert_array_equal(got.neighbors.numpy(), case.neighbors)
    np.testing.assert_array_equal(got.distances.numpy(), case.distances)
