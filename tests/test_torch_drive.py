"""The whole slice: closed-loop drives of the port against the JAX package
and the float64 oracle, and the odometry state carried across packages.

  * 6 frames of the procedural LiDAR (16 beams x 512 azimuth, per-point
    stamps, deskew on) through both KissICP wrappers: poses within atol 1e-4
    (as tests/test_pallas_kernels.py holds the Pallas path), iteration and
    correspondence counts equal.
  * the 4-frame oracle drive of tests/test_golden_parity.py at its
    tolerances (0.03 m / 2e-3), with the port in place of the JAX package.
  * 3 frames in JAX, the state converted (convert.state_from_numpy), frame 4
    in both: the same pose (atol 1e-4) and the same map.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import oracle
from kiss_icp_tpu import odometry as jodo
from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu_torch import convert, odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset

torch.set_num_threads(1)


def _config(cls, max_range=100.0):
    cfg = cls()
    cfg.data.max_range = max_range
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 8192
    cfg.engine.frame_capacity = 8192
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 15
    return cfg


def test_synthetic_drive_matches_jax_kissicp():
    ds = SyntheticDataset(sequence=1, n_scans=6, n_beams=16, n_azimuth=512,
                          speed=1.0, accel_frames=6)
    icp = odometry.KissICP(_config(KISSConfig), device="cpu")
    jicp = jodo.KissICP(_config(JaxConfig))
    for i in range(6):
        pts, stamps = ds[i]
        icp.register_frame(pts, stamps)
        jicp.register_frame(pts, stamps)
        np.testing.assert_allclose(icp.last_pose, jicp.last_pose, atol=1e-4,
                                   err_msg=f"frame {i}")
        res, jres = icp.last_result, jicp.last_result
        assert res.num_iterations == int(jres.num_iterations), f"frame {i}"
        assert int(res.num_correspondences) == int(jres.num_correspondences)
        assert icp.last_overflow() == jicp.last_overflow()
    assert icp.last_result.num_iterations > 1


def test_full_pipeline_matches_oracle_pipeline():
    n_frames = 4
    ds = SyntheticDataset(
        sequence=3, n_scans=n_frames, n_beams=16, n_azimuth=256,
        max_range=50.0, speed=0.3, accel_frames=6, distort=False,
    )
    icp = odometry.KissICP(_config(KISSConfig, max_range=50.0), device="cpu")

    vmap_o = oracle.VoxelMapOracle(1.0, 50.0, 20)
    thr_o = oracle.ThresholdOracle(2.0, 0.1, 50.0)
    last_pose = np.eye(4)
    last_delta = np.eye(4)
    for i in range(n_frames):
        frame, _ = ds[i]
        icp.register_frame_lazy(frame)
        ours = icp.last_pose

        r = np.linalg.norm(frame, axis=1)
        cropped = frame[(r > 1.0) & (r < 50.0)]
        fd = oracle.voxel_downsample(cropped, 0.5)
        src = oracle.voxel_downsample(fd, 1.5)
        sigma = thr_o.compute_threshold()
        guess = last_pose @ last_delta
        theirs = oracle.align_points_to_map(
            vmap_o, src, guess, 3 * sigma, sigma,
            max_iterations=500, convergence=1e-4,
        )
        thr_o.update_model_deviation(np.linalg.inv(guess) @ theirs)
        vmap_o.update(fd, theirs)
        last_delta = np.linalg.inv(last_pose) @ theirs
        last_pose = theirs
        # The JAX package's envelope on this scene (tests/test_golden_parity.py):
        # f32 voxel floors flip boundary points against the f64 oracle.
        np.testing.assert_allclose(ours[:3, 3], theirs[:3, 3], atol=0.03,
                                   err_msg=f"frame {i}: translation")
        np.testing.assert_allclose(ours[:3, :3], theirs[:3, :3], atol=2e-3,
                                   err_msg=f"frame {i}: rotation")


def test_state_carried_across_from_jax():
    ds = SyntheticDataset(sequence=0, n_scans=4, n_beams=16, n_azimuth=512,
                          speed=1.0, accel_frames=6)
    cfg, jcfg = _config(KISSConfig), _config(JaxConfig)
    jcfg.engine.donate_state = False
    cap = cfg.engine.max_points_per_frame
    step = jodo.make_step(jcfg)
    jstate = jodo.init_state(jcfg)

    def padded(i):
        pts, stamps = ds[i]
        p, t, v = (np.zeros((cap, 3), np.float32), np.zeros(cap, np.float32),
                   np.zeros(cap, bool))
        p[:len(pts)], t[:len(pts)], v[:len(pts)] = pts, stamps, True
        return p, t, v

    for i in range(3):
        jstate, _ = step(jstate, *padded(i))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_flatten(jstate)[0]]
    # The port's leaf order is the JAX tree_flatten order (checkpoint leaves).
    assert [(x.shape, x.dtype) for x in leaves] == \
        [(shape, np.dtype(dt)) for shape, dt in convert._expected(cfg)]
    state = convert.state_from_numpy(leaves, cfg, "cpu")
    # The conversion itself is lossless both ways.
    for a, b in zip(convert.state_to_numpy(state), leaves):
        np.testing.assert_array_equal(a, b)

    p, t, v = padded(3)
    jstate, jres = step(jstate, p, t, v)
    state, res = odometry.register_frame(cfg, state, torch.from_numpy(p),
                                         torch.from_numpy(t), torch.from_numpy(v))
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(jres.pose), atol=1e-4)
    assert res.num_iterations == int(jres.num_iterations)
    ours = convert.state_to_numpy(state)
    ref = [np.asarray(x) for x in jax.tree_util.tree_flatten(jstate)[0]]
    names = convert.LEAF_NAMES
    for name, a, b in zip(names, ours, ref):
        if name in ("vkeys", "fprints", "counts", "total_points",
                    "num_dropped_voxels", "num_oob_points"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            # Poses agree to ~1e-6, so inserted world points do too.
            np.testing.assert_allclose(a, b, atol=1e-4, err_msg=name)


def test_state_from_numpy_validates_shapes():
    cfg = _config(KISSConfig)
    state = odometry.init_state(cfg, device="cpu")
    leaves = convert.state_to_numpy(state)
    leaves[8] = leaves[8].astype(np.uint16)  # f32 map, u16 points
    try:
        convert.state_from_numpy(leaves, cfg, "cpu")
    except ValueError as e:
        assert "points" in str(e)
    else:
        raise AssertionError("a mismatched leaf was accepted")
