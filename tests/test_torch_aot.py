"""The port's AOT artifact (kiss_icp_tpu_torch.io.aot) against the live
port step and against the JAX package's artifact.

The counterparts of tests/test_aot.py, on the CPU with its config: the
exported step round-trips through disk and reproduces the live step bit for
bit (per frame and chunked, K = 4), composes with a checkpoint and refuses
other formats, the JAX package's artifact included. The JAX artifact and
the port's, fed the same numpy scans, agree within atol 1e-4 with equal
iterations. Export takes seconds, so each artifact is made once per module.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.io import aot as jaot
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.io import aot, checkpoint

torch.set_num_threads(1)
K = 4


def _config(cls=KISSConfig):
    """tests/test_aot.py's config."""
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 1024
    cfg.engine.frame_capacity = 1024
    cfg.engine.source_capacity = 256
    cfg.engine.map_capacity_log2 = 13
    cfg.engine.donate_state = False
    cfg.registration.max_num_iterations = 10
    return cfg


def _scans(k=4, n=1024, seed=2):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    return [base + np.array([0.3, 0.04, 0], np.float32) * i for i in range(k)]


def _pad(f, n=1024):
    pts = np.zeros((n, 3), np.float32)
    pts[: len(f)] = f
    valid = np.zeros((n,), bool)
    valid[: len(f)] = True
    return pts, np.zeros((n,), np.float32), valid


def _torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.fixture(scope="module")
def step_artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("aot") / "step.kiss_aot.npz"
    aot.save_step(path, _config(), device="cpu")
    return path


@pytest.fixture(scope="module")
def chunk_artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("aot") / "chunked.kiss_aot.npz"
    aot.save_step(path, _config(), device="cpu", chunk=K)
    return path


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("aot") / "jax_step.kiss_aot.npz"
    jaot.save_step(path, _config(JaxConfig))
    return path


def test_aot_roundtrip_matches_live_step(step_artifact):
    """Frame by frame: pose, iterations and every map table bit-identical to
    the live step, and the state fed in (donate_state false) untouched."""
    cfg = _config()
    step, meta = aot.load_step(step_artifact)
    assert meta["max_points_per_frame"] == cfg.engine.max_points_per_frame
    assert (meta["aot_format"], meta["aot_chunk"], meta["device_type"]) == (
        "torch.export", 0, "cpu")

    live = odometry.KissICP(cfg, device="cpu")
    state = odometry.init_state(cfg, device="cpu")
    for f in _scans():
        before = [t.clone() for t in torch.utils._pytree.tree_leaves(state)]
        new, res = step(state, *_torch(_pad(f)))
        assert all(torch.equal(a, b) for a, b in
                   zip(torch.utils._pytree.tree_leaves(state), before))
        state = new
        live.register_frame_lazy(f)
        np.testing.assert_array_equal(res.pose.double().numpy(), live.last_pose)
        assert int(res.num_iterations) == int(live.last_result.num_iterations)
        for a, b in zip(state.map, live.state.map):
            assert torch.equal(a, b)


def test_aot_composes_with_checkpoint(step_artifact, tmp_path):
    """Serving warm-start: the frozen program resumes a checkpointed state."""
    cfg = _config()
    scans = _scans(k=5, seed=9)
    live = odometry.KissICP(cfg, device="cpu")
    for f in scans[:3]:
        live.register_frame_lazy(f)
    live.save_checkpoint(tmp_path / "state.npz")

    step, _ = aot.load_step(step_artifact)
    state = checkpoint.load_checkpoint(tmp_path / "state.npz", cfg, device="cpu")
    for f in scans[3:]:
        state, res = step(state, *_torch(_pad(f)))
        live.register_frame_lazy(f)
        np.testing.assert_array_equal(res.pose.double().numpy(), live.last_pose)


def _rewrite_meta(src, dst, **changes):
    with np.load(src) as d:
        blob, meta = d["exported"], json.loads(bytes(d["metadata_json"]))
    meta.update(changes)
    np.savez(dst, exported=blob,
             metadata_json=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))


@pytest.mark.parametrize("changes", [dict(aot_format_version=999),
                                     dict(aot_format="jax.export")])
def test_aot_version_check(step_artifact, tmp_path, changes):
    art = tmp_path / "step.npz"
    _rewrite_meta(step_artifact, art, **changes)
    with pytest.raises(ValueError, match="format"):
        aot.load_step(art)


def test_map_shards_refused_at_export(tmp_path):
    """Not refused: as JAX's `export_step`, the export with `map_shards` = 2
    is the single-device step, over the single-device state: its frames
    equal the live single-device step's bit for bit, and the record keeps
    `map_shards` as JAX's does."""
    cfg = _config()
    cfg.engine.map_shards = 2
    aot.save_step(tmp_path / "step.npz", cfg, device="cpu")
    step, meta = aot.load_step(tmp_path / "step.npz")
    jcfg = _config(JaxConfig)
    jcfg.engine.map_shards = 2
    assert meta["map_shards"] == jaot._metadata(jcfg)["map_shards"] == 2
    state = odometry.init_state(cfg, device="cpu")
    live = odometry.KissICP(_config(), device="cpu")
    for f in _scans(k=2):
        state, res = step(state, *_torch(_pad(f)))
        live.register_frame_lazy(f)
        np.testing.assert_array_equal(res.pose.double().numpy(), live.last_pose)


def test_jax_artifact_is_refused(jax_artifact):
    """The JAX package's artifact carries format version 2 too; the port's
    gate refuses it by the format's name, before torch reads it."""
    with np.load(jax_artifact) as d:
        assert json.loads(bytes(d["metadata_json"]))["aot_format_version"] == 2
    with pytest.raises(ValueError, match="JAX package"):
        aot.load_step(jax_artifact)


def test_aot_chunked_roundtrip_matches_live_chunked(chunk_artifact):
    cfg = _config()
    step, meta = aot.load_step(chunk_artifact)
    assert meta["aot_chunk"] == K
    padded = [_pad(f) for f in _scans(K)]
    pts, ts, valid = (torch.from_numpy(np.stack([p[i] for p in padded])) for i in range(3))

    state, summary = step(odometry.init_state(cfg, device="cpu"), pts, ts, valid)
    lstate, lsummary = odometry.make_chunked_step(cfg)(
        odometry.init_state(cfg, device="cpu"), pts, ts, valid)
    for a, b in zip(summary, lsummary):
        assert torch.equal(a, b)
    assert torch.equal(state.pose, lstate.pose)
    assert torch.equal(state.map.points, lstate.map.points)


def test_aot_matches_jax_artifact(step_artifact, jax_artifact):
    """The two packages' artifacts on the same numpy scans: poses within
    atol 1e-4 (the port's parity tolerance), iterations equal."""
    cfg, jcfg = _config(), _config(JaxConfig)
    step, _ = aot.load_step(step_artifact)
    jstep, _ = jaot.load_step(jax_artifact)
    state = odometry.init_state(cfg, device="cpu")
    jstate = jodo.init_state(jcfg)
    for f in _scans(k=5, seed=9):
        arrays = _pad(f)
        state, res = step(state, *_torch(arrays))
        jstate, jres = jstep(jstate, *(jnp.asarray(a) for a in arrays))
        np.testing.assert_allclose(res.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
        assert int(res.num_iterations) == int(jres.num_iterations)
        assert int(res.num_correspondences) == int(jres.num_correspondences)
    assert int(state.map.total_points) == int(jstate.map.total_points)
