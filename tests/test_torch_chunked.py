"""Port chunked API (odometry.make_chunked_step, KissICP.build_chunk /
dispatch_chunk / summary_poses / register_frames_chunked) against the
streaming path and against the JAX package's `make_chunked_step`.

The port's chunk is a Python loop over the same `register_frame`, so chunked
and streaming poses are bit-identical. Against JAX's `lax.scan` chunk on the
same frames: poses at atol 1e-4 (as tests/test_torch_odometry.py holds
them), sigmas at rtol 1e-5, the integer fields exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset

torch.set_num_threads(1)


def _config(cls):
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 2048
    cfg.engine.frame_capacity = 2048
    cfg.engine.source_capacity = 512
    cfg.engine.map_capacity_log2 = 13
    cfg.engine.donate_state = False
    cfg.registration.max_num_iterations = 15
    return cfg


def _frames(k, n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    pts = np.stack([base + np.array([0.2 * i, 0, 0], np.float32) for i in range(k)])
    ts = np.zeros((k, n), np.float32)
    valid = np.ones((k, n), bool)
    valid[:, ::17] = False
    return pts, ts, valid


def test_chunked_step_matches_streaming_bit_for_bit():
    cfg = _config(KISSConfig)
    pts, ts, valid = (torch.from_numpy(a) for a in _frames(4, 2048))
    state_c, summary = odometry.make_chunked_step(cfg)(
        odometry.init_state(cfg, "cpu"), pts, ts, valid)
    assert summary.poses.shape == (4, 4, 4) and summary.num_iterations.dtype == torch.int32
    state_s = odometry.init_state(cfg, "cpu")
    for i in range(4):
        state_s, res = odometry.register_frame(cfg, state_s, pts[i], ts[i], valid[i])
        assert torch.equal(summary.poses[i], res.pose)
        assert int(summary.num_iterations[i]) == res.num_iterations
        assert torch.equal(summary.sigmas[i], res.sigma)
    assert torch.equal(state_c.pose, state_s.pose)
    assert torch.equal(state_c.map.points, state_s.map.points)


def test_chunk_summary_matches_jax_make_chunked_step():
    cfg, jcfg = _config(KISSConfig), _config(JaxConfig)
    jcfg.engine.use_pallas = False
    pts, ts, valid = _frames(3, 2048, seed=1)
    _, summary = odometry.make_chunked_step(cfg)(
        odometry.init_state(cfg, "cpu"), torch.from_numpy(pts), torch.from_numpy(ts),
        torch.from_numpy(valid))
    _, jsummary = jodo.make_chunked_step(jcfg)(jodo.init_state(jcfg), jnp.asarray(pts),
                                               jnp.asarray(ts), jnp.asarray(valid))
    assert summary._fields == jsummary._fields
    np.testing.assert_allclose(summary.poses.numpy(), np.asarray(jsummary.poses), atol=1e-4)
    np.testing.assert_allclose(summary.sigmas.numpy(), np.asarray(jsummary.sigmas), rtol=1e-5)
    for name in ("num_iterations", "num_correspondences", "num_dropped_downsample",
                 "num_dropped_map_voxels", "num_oob_points", "used_fallback"):
        np.testing.assert_array_equal(getattr(summary, name).numpy(),
                                      np.asarray(getattr(jsummary, name)), err_msg=name)
    assert int(summary.num_iterations.sum()) > 3


def _scans(n):
    ds = SyntheticDataset(sequence=2, n_scans=n, n_beams=16, n_azimuth=256,
                          max_range=50.0, speed=1.0, accel_frames=4)
    return [ds[i] for i in range(n)]


@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_register_frames_chunked_matches_register_frame(chunk):
    """The wrapper's chunk API gives the streaming wrapper's world poses,
    and build_chunk counts input drops like the streaming padder."""
    scans = _scans(5)
    cfg = _config(KISSConfig)
    stream = odometry.KissICP(cfg, device="cpu")
    ref = []
    for f, t in scans:
        stream.register_frame(f, t)
        ref.append(stream.last_pose)
    icp = odometry.KissICP(cfg, device="cpu")
    got = []
    for a in range(0, 5, chunk):
        got.extend(icp.register_frames_chunked([s[0] for s in scans[a:a + chunk]],
                                               [s[1] for s in scans[a:a + chunk]]))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert icp.total_input_dropped == stream.total_input_dropped > 0
    assert icp.last_chunk_summary.poses.shape[0] == (5 - 1) % chunk + 1


def test_build_chunk_packs_like_jax():
    """One 17-byte-a-point buffer holds the K padded scans; its views equal
    the JAX package's padded chunk arrays, drops included."""
    cfg, jcfg = _config(KISSConfig), _config(JaxConfig)
    rng = np.random.default_rng(3)
    frames = [rng.uniform(-20, 20, (n, 3)) for n in (100, 3000, 0)]
    stamps = [np.linspace(0, 1, 100), np.linspace(0, 1, 3000), np.array([])]
    icp = odometry.KissICP(cfg, device="cpu")
    chunk, dropped = icp.build_chunk(frames, stamps)
    (jpts, jts, jvalid), jdropped = jodo.KissICP(jcfg).build_chunk(frames, stamps)
    assert chunk.packed.numel() == 3 * 2048 * 17 and chunk.num_frames == 3
    np.testing.assert_array_equal(chunk.points, jpts)
    np.testing.assert_array_equal(chunk.timestamps, jts)
    np.testing.assert_array_equal(chunk.valid, jvalid)
    assert dropped == jdropped == 3000 - 2048
    views = odometry.chunk_views(chunk.packed, 3, 2048)
    for view, arr in zip(views, (chunk.points, chunk.timestamps, chunk.valid)):
        np.testing.assert_array_equal(view.numpy(), arr)
