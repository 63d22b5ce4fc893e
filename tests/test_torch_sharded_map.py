"""The map-sharded step (kiss_icp_tpu_torch.parallel.sharded_map) against the
JAX package's `parallel/sharded_map.py` on its 8-device CPU mesh
(tests/conftest.py), on the CPU, where the batched kernels' operators take
their plain versions.

Tolerances: poses per frame within 1e-4 m of JAX's with equal iterations,
correspondence counts and drops (JAX holds its sharded step to the
single-device one at 5e-4, tests/test_sharded_map.py:68; the port's
single-device step meets JAX's at 1e-4). The tables are held slot for slot:
the shard and home-bucket hashes are JAX's bit for bit. JAX's psum order on
the CPU mesh is unspecified, so poses are held at a tolerance, not bit for
bit; bit-identity is for the port against itself (chunked vs streaming
here, 1 x 4 vs 2 x 2 ranks in tests/test_torch_multihost.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.parallel import sharded_map as jsm
from kiss_icp_tpu_torch import convert, odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.parallel import sharded_map as psm

try:  # jax >= 0.7 promotes shard_map out of experimental
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)

K = 4
ATOL_JAX = 1e-4


def _config(cls, storage="f32"):
    """tests/test_sharded_map.py's `_config`: 2048 points, source 512,
    2^14 slots."""
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 2048
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 14
    cfg.engine.map_storage = storage
    cfg.engine.donate_state = False
    cfg.registration.max_num_iterations = 12
    return cfg


def _frames(k, n, seed=0):
    """tests/test_sharded_map.py's `_frames`."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    pts = np.stack([base + np.array([0.25 * i, 0.04 * i, 0], np.float32) for i in range(k)])
    return pts, np.zeros((k, n), np.float32), np.ones((k, n), bool)


def _jax_mesh(d):
    return Mesh(np.asarray(jax.devices()[:d]), (jsm.MAP_AXIS,))


FIELDS = ("pose", "num_iterations", "num_correspondences", "num_dropped_downsample",
          "num_dropped_map_voxels", "num_oob_points", "used_fallback")


def _jax_drive(d, storage, k=K, seed=0):
    cfg = _config(JaxConfig, storage)
    mesh = _jax_mesh(d)
    pts, ts, valid = _frames(k, cfg.engine.max_points_per_frame, seed)
    step = jsm.make_map_sharded_step(cfg, mesh)
    state = jsm.init_sharded_state(cfg, mesh)
    out = []
    for i in range(k):
        state, res = step(state, pts[i], ts[i], valid[i])
        out.append({f: np.asarray(getattr(res, f)) for f in FIELDS})
    return out, [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _port_drive(d, storage, k=K, seed=0):
    cfg = _config(KISSConfig, storage)
    mesh = psm.map_mesh(d, device="cpu")
    pts, ts, valid = _frames(k, cfg.engine.max_points_per_frame, seed)
    step = psm.make_map_sharded_step(cfg, mesh)
    state = psm.init_sharded_state(cfg, mesh)
    out = []
    for i in range(k):
        state, res = step(state, pts[i], ts[i], valid[i])
        out.append({f: getattr(res, f).numpy() for f in FIELDS})
    return out, state


@pytest.fixture(scope="module", params=[(2, "f32"), (4, "f32"), (4, "u16")],
                ids=["D2", "D4", "D4-u16"])
def drives(request):
    d, storage = request.param
    return d, storage, _jax_drive(d, storage), _port_drive(d, storage)


def test_step_matches_jax(drives):
    d, storage, (jout, _), (pout, _) = drives
    for i, (j, p) in enumerate(zip(jout, pout)):
        np.testing.assert_allclose(p["pose"], j["pose"], atol=ATOL_JAX,
                                   err_msg=f"D={d} {storage} frame {i}")
        for f in FIELDS[1:]:
            assert int(p[f]) == int(j[f]), (d, storage, i, f, p[f], j[f])
    assert all(int(p["num_iterations"]) > 0 for p in pout[1:])


def test_tables_equal_slot_for_slot(drives):
    d, storage, (_, jleaves), (_, pstate) = drives
    pleaves = convert.state_to_numpy(pstate)
    for name, a, b in zip(convert.LEAF_NAMES, pleaves, jleaves):
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape)
        if name in ("vkeys", "fprints", "counts", "total_points", "num_dropped_voxels",
                    "num_oob_points"):
            np.testing.assert_array_equal(a, b, err_msg=name)
    # Points: the same slots hold points within the pose tolerance (f32), or
    # the same voxel-relative codes up to one step of the 16-bit grid (u16).
    i = convert.LEAF_NAMES.index("points")
    live = pleaves[convert.LEAF_NAMES.index("counts")] > 0
    a, b = pleaves[i][live].astype(np.float64), jleaves[i][live].astype(np.float64)
    np.testing.assert_allclose(a, b, atol=1e-3 if storage == "f32" else 200)
    # The per-shard counters are (D,), and every shard holds voxels.
    assert pleaves[convert.LEAF_NAMES.index("total_points")].shape == (d,)
    occ = psm.shard_live_voxels(pstate, d).numpy()
    assert np.all(occ > 0) and occ.sum() == int(live.sum())


def test_chunked_matches_streaming():
    cfg = _config(KISSConfig)
    mesh = psm.map_mesh(4, device="cpu")
    pts, ts, valid = _frames(3, cfg.engine.max_points_per_frame, seed=2)
    cstate, results = psm.make_map_sharded_chunked_step(cfg, mesh)(
        psm.init_sharded_state(cfg, mesh), pts, ts, valid)
    step = psm.make_map_sharded_step(cfg, mesh)
    sstate = psm.init_sharded_state(cfg, mesh)
    stream = []
    for i in range(3):
        sstate, res = step(sstate, pts[i], ts[i], valid[i])
        stream.append(res.pose)
    np.testing.assert_allclose(results.pose.numpy(), torch.stack(stream).numpy(), atol=1e-5)
    assert results.frame_points is None and results.num_iterations.shape == (3,)
    for a, b in zip(convert.state_to_numpy(cstate), convert.state_to_numpy(sstate)):
        np.testing.assert_array_equal(a, b)


def test_donate_state_false_leaves_the_input():
    cfg = _config(KISSConfig)
    mesh = psm.map_mesh(2, device="cpu")
    pts, ts, valid = _frames(2, cfg.engine.max_points_per_frame, seed=4)
    step = psm.make_map_sharded_step(cfg, mesh)
    state, _ = step(psm.init_sharded_state(cfg, mesh), pts[0], ts[0], valid[0])
    before = convert.state_to_numpy(state)
    step(state, pts[1], ts[1], valid[1])
    for a, b in zip(convert.state_to_numpy(state), before):
        np.testing.assert_array_equal(a, b)


def test_u16_storage_honored():
    cfg = _config(KISSConfig, "u16")
    st = psm.init_sharded_state(cfg, psm.map_mesh(4, device="cpu"))
    assert st.points.dtype == torch.uint16
    assert st.points.shape == (1 << 14, 20, 3)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_local_map_config_and_shard_of_match_jax(d):
    jcfg, cfg = _config(JaxConfig), _config(KISSConfig)
    jl = jsm.local_map_config(jcfg, _jax_mesh(d))
    pl = psm.local_map_config(cfg, psm.map_mesh(d, device="cpu"))
    assert (pl.capacity_log2, pl.probe_length, pl.storage) == \
        (jl.capacity_log2, jl.probe_length, jl.storage)
    coords = np.random.default_rng(d).integers(-16000, 16000, (4096, 3)).astype(np.int32)
    np.testing.assert_array_equal(psm.shard_of(torch.from_numpy(coords), d).numpy(),
                                  np.asarray(jsm.shard_of(jnp.asarray(coords), d)))


def test_bad_shard_counts_raise():
    cfg = _config(KISSConfig)
    with pytest.raises(ValueError, match="power of two"):
        psm.local_map_config(cfg, psm.map_mesh(3, device="cpu"))
    cfg.engine.map_capacity_log2 = 2
    cfg.engine.probe_length = 4
    with pytest.raises(ValueError, match="capacity"):
        psm.local_map_config(cfg, psm.map_mesh(4, device="cpu"))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_communication_model_matches_jax(d):
    jcfg, cfg = _config(JaxConfig), _config(KISSConfig)
    assert psm.ring_payload_bytes(cfg, d) == jsm.ring_payload_bytes(jcfg, d)
    assert psm.ring_collective_permutes_per_gn_iteration(d) == \
        jsm.ring_collective_permutes_per_gn_iteration(d)
    assert psm.expected_collective_permutes(d) == jsm.expected_collective_permutes(d)


def _jax_combine(d2, nn):
    """JAX's ring on its mesh: d2 (D, S), nn (D, S, 3) -> each shard's
    combined (D, S), (D, S, 3)."""
    d = d2.shape[0]
    mesh = _jax_mesh(d)

    def body(a, b):
        x, y = jsm._ring_min_combine(a[0], b[0], jsm.MAP_AXIS, d)
        return x[None], y[None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(jsm.MAP_AXIS), P(jsm.MAP_AXIS)),
                          out_specs=(P(jsm.MAP_AXIS), P(jsm.MAP_AXIS))))
    x, y = f(jnp.asarray(d2), jnp.asarray(nn))
    return np.asarray(x), np.asarray(y)


@pytest.mark.parametrize("d", [2, 4])
def test_combine_ties_and_nan_match_jax(d):
    """Witnesses of the combine's order: exact ties (the lower shard wins),
    NaN candidates (never win; a shard keeps its own NaN, so shards may
    disagree there, as on the JAX mesh), infinities, random values."""
    rng = np.random.default_rng(d)
    s = 64
    d2 = rng.choice([0.25, 1.0, 4.0], size=(d, s)).astype(np.float32)
    d2[:, :8] = 1.0  # all tie
    d2[0, 8:16] = np.nan
    d2[d - 1, 16:24] = np.nan
    d2[:, 24:28] = np.inf
    d2[1, 28:32] = np.nan
    d2[:, 32:36] = np.nan
    nn = rng.normal(size=(d, s, 3)).astype(np.float32)
    jd2, jnn = _jax_combine(d2, nn)
    pd2, pnn = psm.ring_min_combine(torch.from_numpy(d2), torch.from_numpy(nn),
                                    torch.arange(d))
    np.testing.assert_array_equal(pd2.numpy(), jd2)
    np.testing.assert_array_equal(pnn.numpy(), jnn)
    # Ties go to shard 0; a NaN held by shard 0 stays there only.
    assert np.array_equal(pnn.numpy()[:, :8], np.broadcast_to(nn[0, :8], (d, 8, 3)))
    assert np.isnan(pd2.numpy()[0, 8:16]).all() and not np.isnan(pd2.numpy()[1, 8:16]).any()
    # A process holding rows 1.. of the axis gets those rows' answers.
    sub_d2, _ = psm.ring_min_combine(torch.from_numpy(d2), torch.from_numpy(nn),
                                     torch.arange(1, d))
    np.testing.assert_array_equal(sub_d2.numpy(), jd2[1:])


def test_sharded_matches_single_device_port():
    """The sharded step against the port's own single-device step (JAX's
    5e-4 of tests/test_sharded_map.py:68)."""
    cfg = _config(KISSConfig)
    pts, ts, valid = _frames(K, cfg.engine.max_points_per_frame)
    state = odometry.init_state(cfg, "cpu")
    single = []
    for i in range(K):
        state, res = odometry.register_frame(cfg, state, *(torch.from_numpy(a[i])
                                                          for a in (pts, ts, valid)))
        single.append(res.pose.numpy())
    sharded, _ = _port_drive(4, "f32")
    np.testing.assert_allclose(np.stack([s["pose"] for s in sharded]), np.stack(single),
                               atol=5e-4)
