"""The port's data-association modes (engine.nn_mode) against the JAX package's.

  * The port's queries (flat, and the 27-offset loop of loop27 on the CPU)
    are bit-identical wherever a query is found, and held to the JAX
    queries of every mode (the compact view's flat and looped ones too) at
    the tolerance of tests/test_pallas_nn.py (found equal, distances rtol
    1e-6: XLA contracts JAX's d² into FMAs).
  * 6-frame drives (16x512 beams, 2^15-slot map) of gather27, loop27,
    compact and compact_loop against JAX's KissICP: poses within atol 1e-4,
    iteration and correspondence counts equal. In the port the four modes,
    and pallas_fused, give the same poses bit for bit.
  * gn_unroll 1, 2 and 3 give identical results.
  * A compact view too small for the map reports JAX's drop count through
    FrameResult.num_dropped_map_voxels, its frames match gather27 through
    the sparse fallback, and the pipeline warns.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.ops import compact_map as jcm
from kiss_icp_tpu.ops import hash_map as jhm
from kiss_icp_tpu_torch import odometry, pipeline
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from kiss_icp_tpu_torch.ops import compact_map as cm
from kiss_icp_tpu_torch.ops import hash_map as hm

torch.set_num_threads(1)

N_FRAMES = 6


def _build_both(storage, seed=0):
    args = dict(voxel_size=1.0, max_distance=30.0, max_points_per_voxel=7,
                capacity_log2=12, storage=storage)
    cfg, jcfg = hm.MapConfig(**args), jhm.MapConfig(**args)
    m, jm = hm.create_map(cfg), jhm.create_map(jcfg)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        pts = rng.uniform(-12.0, 12.0, size=(800, 3)).astype(np.float32)
        m, _ = hm.insert(cfg, m, torch.from_numpy(pts), torch.ones(800, dtype=torch.bool))
        jm, _ = jhm.insert(jcfg, jm, jnp.asarray(pts), jnp.ones((800,), bool))
    return cfg, m, jcfg, jm


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_query_variants_bit_identical(storage):
    cfg, m, jcfg, jm = _build_both(storage)
    jccfg = jcm.CompactConfig(live_capacity_log2=12, hash_capacity_log2=14)
    jview = jcm.build_compact(jcfg, jccfg, jm)
    rng = np.random.default_rng(1)
    q = rng.uniform(-14, 14, size=(512, 3)).astype(np.float32)
    q[::50] = np.nan  # NaN queries: not found in every variant
    valid = np.ones(512, bool)
    valid[500:] = False
    tq, tv, jq, jv = torch.from_numpy(q), torch.from_numpy(valid), jnp.asarray(q), jnp.asarray(valid)

    ref = hm.query_nearest(cfg, m, tq, tv)
    ours = {"loop27": hm.query_nearest_loop(cfg, m, tq, tv)}
    theirs = {
        "gather27": jhm.query_nearest(jcfg, jm, jq, jv),
        "loop27": jhm.query_nearest_loop(jcfg, jm, jq, jv),
        "compact": jcm.query_nearest_compact(jcfg, jccfg, jview, jq, jv),
        "compact_loop": jcm.query_nearest_compact_loop(jcfg, jccfg, jview, jq, jv),
    }
    f = ref.found.numpy()
    assert 100 < f.sum() < 500
    for name, got in ours.items():
        assert torch.equal(got.found, ref.found), name
        assert torch.equal(got.distances[ref.found], ref.distances[ref.found]), name
        assert torch.equal(got.neighbors[ref.found], ref.neighbors[ref.found]), name
    for name, jgot in theirs.items():
        np.testing.assert_array_equal(np.asarray(jgot.found), f, err_msg=name)
        np.testing.assert_allclose(ref.distances.numpy()[f], np.asarray(jgot.distances)[f],
                                   rtol=1e-6, err_msg=name)
        d_ours = np.linalg.norm(q[f] - ref.neighbors.numpy()[f], axis=1)
        np.testing.assert_allclose(d_ours, np.asarray(jgot.distances)[f], rtol=1e-5,
                                   err_msg=name)


def _config(cls, nn_mode, **engine):
    cfg = cls()
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 8192
    cfg.engine.frame_capacity = 8192
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 15
    cfg.engine.nn_mode = nn_mode
    cfg.engine.nn_live_capacity_log2 = 13
    for key, value in engine.items():
        setattr(cfg.engine, key, value)
    return cfg


@pytest.fixture(scope="module")
def scans():
    ds = SyntheticDataset(sequence=1, n_scans=N_FRAMES, n_beams=16, n_azimuth=512,
                          speed=1.0, accel_frames=6)
    return [ds[i] for i in range(N_FRAMES)]


def _drive(icp, scans):
    poses, iters, corr, drops = [], [], [], []
    for pts, stamps in scans:
        icp.register_frame(pts, stamps)
        res = icp.last_result
        poses.append(icp.last_pose)
        iters.append(int(res.num_iterations))
        corr.append(int(res.num_correspondences))
        drops.append(int(res.num_dropped_map_voxels))
    return np.stack(poses), iters, corr, drops


@pytest.fixture(scope="module")
def runs(scans):
    """Each (package, mode) drive, run once for the module."""
    cache = {}

    def run(package, nn_mode, **engine):
        key = (package, nn_mode, tuple(sorted(engine.items())))
        if key not in cache:
            if package == "jax":
                icp = jodo.KissICP(_config(JaxConfig, nn_mode, **engine))
            else:
                icp = odometry.KissICP(_config(KISSConfig, nn_mode, **engine), device="cpu")
            cache[key] = _drive(icp, scans)
        return cache[key]

    return run


@pytest.mark.parametrize("nn_mode", ["gather27", "loop27", "compact", "compact_loop"])
def test_drive_matches_jax(runs, nn_mode):
    poses, iters, corr, drops = runs("port", nn_mode)
    jposes, jiters, jcorr, jdrops = runs("jax", nn_mode)
    np.testing.assert_allclose(poses, jposes, atol=1e-4)
    assert iters == jiters and corr == jcorr
    assert drops == jdrops == [0] * N_FRAMES
    assert max(iters) > 1


@pytest.mark.parametrize("nn_mode", ["loop27", "compact", "compact_loop", "pallas_fused"])
def test_modes_bit_identical_in_the_port(runs, nn_mode):
    ref, got = runs("port", "gather27"), runs("port", nn_mode)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]


@pytest.mark.parametrize("unroll", [2, 3])
def test_gn_unroll_changes_nothing(runs, unroll):
    ref, got = runs("port", "gather27"), runs("port", "gather27", gn_unroll=unroll)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]


def test_compact_overflow_reaches_frame_result(runs):
    """A 2^6-row view cannot hold the map: every frame after the first
    reports JAX's drop count, and the sparse fallback keeps the frames
    bit-identical to gather27."""
    poses, iters, corr, drops = runs("port", "compact", nn_live_capacity_log2=6)
    jdrops = runs("jax", "compact", nn_live_capacity_log2=6)[3]
    assert drops == jdrops and all(d > 0 for d in drops[1:])
    ref = runs("port", "gather27")
    np.testing.assert_array_equal(poses, ref[0])
    assert (iters, corr) == (ref[1], ref[2])


def test_pipeline_warns_on_compact_overflow(tmp_path):
    ds = SyntheticDataset(sequence=1, n_scans=2, n_beams=16, n_azimuth=256)
    cfg = _config(KISSConfig, "compact", nn_live_capacity_log2=6)
    cfg.out_dir = str(tmp_path)
    pipe = pipeline.OdometryPipeline(ds, config=cfg, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe.run()
    assert pipe.total_dropped_map_voxels > 0
    assert any("nn_live_capacity_log2" in str(w.message) for w in caught)


def test_compact_view_counts_cross_round_fingerprint_shadow():
    """Two voxels with equal 32-bit fingerprints (the brute-forced pair of
    tests/test_hash_map.py) can live in the sparse map in different windows
    but share a window of the view: the view refuses the second and counts
    it, as JAX does, and places the first under its own row."""
    a = torch.tensor([[-3403, 1173, 2243]], dtype=torch.int32)
    b = torch.tensor([[2285, 3484, 3708]], dtype=torch.int32)
    assert int(hm.fingerprint(a)[0]) == int(hm.fingerprint(b)[0])
    args = dict(voxel_size=1.0, max_distance=1e5, max_points_per_voxel=4,
                capacity_log2=13, probe_length=16, group_capacity=8)
    cfg, jcfg = hm.MapConfig(**args), jhm.MapConfig(**args)
    cargs = dict(live_capacity_log2=11, hash_capacity_log2=13, probe_length=16)
    ccfg, jccfg = cm.CompactConfig(**cargs), jcm.CompactConfig(**cargs)
    assert int(cm._hash_rows(a, ccfg)[0]) == int(cm._hash_rows(b, ccfg)[0])

    m = hm.create_map(cfg)
    m.vkeys[10], m.vkeys[20] = a[0], b[0]
    m.counts[10] = m.counts[20] = 1
    m.points[10, 0], m.points[20, 0] = a[0].float(), b[0].float()
    jm = jhm.create_map(jcfg)._replace(vkeys=jnp.asarray(m.vkeys.numpy()),
                                        counts=jnp.asarray(m.counts.numpy()),
                                        points=jnp.asarray(m.points.numpy()))
    view, jview = cm.build_compact(cfg, ccfg, m), jcm.build_compact(jcfg, jccfg, jm)
    assert int(view.n_live) == int(jview.n_live) == 2
    assert int(view.num_dropped) == int(jview.num_dropped) == 1
    np.testing.assert_array_equal(view.hfp.numpy(), np.asarray(jview.hfp))
    np.testing.assert_array_equal(view.hval.numpy(), np.asarray(jview.hval))
    slot = torch.nonzero(view.hfp).squeeze(1)
    assert len(slot) == 1  # one of the pair placed, the other refused
    assert torch.equal(view.ckeys[view.hval[slot[0]]], a[0])  # the lower slot's voxel
