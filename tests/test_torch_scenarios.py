"""The five BASELINE.json scenarios of tests/test_scenarios.py, run by the port.

Each scenario writes the same deterministic synthetic drive in a dataset's
on-disk format (tests/scenario_helpers.py), reads it back with the port's
loader, and drives the port's OdometryPipeline (`device="cpu"`, the plain
versions of the kernels) with the shipped YAML config loaded by the port's
`config.parser.load_config`, cut to CPU scale by the JAX test's own
`_small_engine`. The trajectory is held to the float64 oracle on the
loader's frames at the JAX test's bounds (0.08 m, 1e-2), and to JAX's
pipeline over the same files with JAX's loader at the parity bound of
PERF.md section 2: 1e-4 m a frame and equal GN iterations. The batched
scenario runs the port's batched chunked step over four different drives:
each row against its own single-sequence run (1e-4, the JAX test's bound),
and against JAX's batched step.
"""

import numpy as np
import torch

import scenario_helpers as sh
from test_scenarios import CONFIG_DIR, N_FRAMES, _assert_matches_oracle, _loader_frames, \
    _small_engine
from kiss_icp_tpu.config.parser import load_config as jax_load_config
from kiss_icp_tpu.pipeline import OdometryPipeline as JaxPipeline
from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.parser import load_config
from kiss_icp_tpu_torch.pipeline import OdometryPipeline

torch.set_num_threads(1)

PARITY_ATOL = 1e-4  # PERF.md section 2: the port against JAX, per frame


def _configs(config_file, edit):
    """The port's and JAX's config from the same file (None: defaults),
    both cut by `_small_engine` and changed by `edit`."""
    out = []
    for load in (load_config, jax_load_config):
        cfg = _small_engine(load(config_file))
        edit(cfg)
        out.append(cfg)
    return out


def _record_iterations(pipe):
    """Each dispatched chunk's per-frame GN iterations, into a list."""
    odo, iters = pipe.odometry, []
    dispatch = odo.dispatch_chunk

    def recording(*a, **k):
        summary = dispatch(*a, **k)
        iters.extend(int(x) for x in np.asarray(summary.num_iterations).ravel())
        return summary

    odo.dispatch_chunk = recording
    return iters


def _run_both(ds, jds, cfg, jcfg, tmp_path):
    """The port's pipeline over `ds` and JAX's over `jds` (the same files):
    the port's pipeline, once both agree to PARITY_ATOL with equal
    iterations."""
    cfg.out_dir, jcfg.out_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    ours = OdometryPipeline(ds, config=cfg, device="cpu")
    theirs = JaxPipeline(jds, config=jcfg)
    iters, jiters = _record_iterations(ours), _record_iterations(theirs)
    ours.run()
    theirs.run()
    assert len(iters) == len(jiters) == len(ds)
    assert iters == jiters, f"GN iterations: port {iters}, JAX {jiters}"
    np.testing.assert_allclose(ours.poses, theirs.poses, atol=PARITY_ATOL,
                               err_msg="the port's pipeline parted from JAX's")
    return ours


def test_scenario_kitti_basic(tmp_path):
    """Scenario 1: KITTI seq 00 with basic.yaml (no per-point stamps, so
    deskew is inactive; adaptive threshold, derived voxel size)."""
    from kiss_icp_tpu.datasets.kitti import KITTIOdometryDataset as JaxKITTI
    from kiss_icp_tpu_torch.datasets.kitti import KITTIOdometryDataset

    sh.write_kitti_tree(tmp_path, sh.make_drive(N_FRAMES, seq=0))
    ds = KITTIOdometryDataset(tmp_path, sequence=0)

    def edit(cfg):
        cfg.data.min_range = 1.0

    cfg, jcfg = _configs(CONFIG_DIR / "basic.yaml", edit)
    pipe = _run_both(ds, JaxKITTI(tmp_path, sequence=0), cfg, jcfg, tmp_path)

    golden = sh.run_oracle_pipeline(_loader_frames(ds), cfg)
    _assert_matches_oracle(pipe, golden)
    # The pipeline evaluated KITTI metrics against the fixture's ground truth.
    ate = next(m.value for m in pipe.results.metrics if "ATE" in m.desc)
    assert ate < 0.5


def test_scenario_kitti_raw_advanced(tmp_path):
    """Scenario 2: KITTI raw with motion deskew and advanced.yaml (azimuth
    pseudo-stamps activate the deskew path; fixed threshold)."""
    from kiss_icp_tpu.datasets.kitti_raw import KITTIRawDataset as JaxKITTIRaw
    from kiss_icp_tpu_torch.datasets.kitti_raw import KITTIRawDataset

    sh.write_kitti_raw_tree(tmp_path, sh.make_drive(N_FRAMES, seq=1, distort=True))
    ds = KITTIRawDataset(tmp_path, sequence=0)
    assert len(ds) == N_FRAMES

    def edit(cfg):
        cfg.data.min_range = 1.0

    cfg, jcfg = _configs(CONFIG_DIR / "advanced.yaml", edit)
    assert cfg.adaptive_threshold.fixed_threshold is not None  # advanced.yaml
    pipe = _run_both(ds, JaxKITTIRaw(tmp_path, sequence=0), cfg, jcfg, tmp_path)

    frames = _loader_frames(ds)
    assert all(len(ts) == len(pts) for pts, ts in frames)  # stamps present
    _assert_matches_oracle(pipe, sh.run_oracle_pipeline(frames, cfg))


def test_scenario_mulran(tmp_path):
    """Scenario 3: MulRan Ouster-64 with a 120 m max range."""
    from kiss_icp_tpu.datasets.mulran import MulranDataset as JaxMulran
    from kiss_icp_tpu_torch.datasets.mulran import MulranDataset

    seq_dir = sh.write_mulran_tree(tmp_path, sh.make_drive(N_FRAMES, seq=2))
    ds = MulranDataset(seq_dir)
    assert len(ds) == N_FRAMES

    def edit(cfg):
        cfg.data.max_range = 120.0
        cfg.data.min_range = 1.0
        cfg.mapping.voxel_size = 1.0

    cfg, jcfg = _configs(None, edit)
    pipe = _run_both(ds, JaxMulran(seq_dir), cfg, jcfg, tmp_path)
    _assert_matches_oracle(pipe, sh.run_oracle_pipeline(_loader_frames(ds), cfg))


def test_scenario_newer_college(tmp_path):
    """Scenario 4: Newer College handheld (small voxel size)."""
    from kiss_icp_tpu.datasets.ncd import NewerCollegeDataset as JaxNCD
    from kiss_icp_tpu_torch.datasets.ncd import NewerCollegeDataset

    seq_dir = sh.write_ncd_tree(tmp_path, sh.make_drive(N_FRAMES, seq=3))
    ds = NewerCollegeDataset(seq_dir)
    assert len(ds) == N_FRAMES
    assert ds.gt_poses.shape[0] == N_FRAMES

    def edit(cfg):
        cfg.data.max_range = 50.0
        cfg.data.min_range = 1.0
        cfg.mapping.voxel_size = 0.5  # handheld: small voxels

    cfg, jcfg = _configs(None, edit)
    pipe = _run_both(ds, JaxNCD(seq_dir), cfg, jcfg, tmp_path)
    _assert_matches_oracle(pipe, sh.run_oracle_pipeline(_loader_frames(ds), cfg))


def test_scenario_batched_multisequence():
    """Scenario 5: B different drives advance in lockstep through the
    port's batched chunked step; each sequence matches its own
    single-sequence run, and JAX's batched step on the same frames."""
    import jax
    from kiss_icp_tpu.parallel.batch import (
        init_batched_state as jax_init_batched_state,
        make_batched_chunked_step as jax_make_batched_chunked_step,
        make_mesh as jax_make_mesh,
    )
    from kiss_icp_tpu_torch.parallel.batch import (
        init_batched_state, make_batched_chunked_step, make_mesh,
    )

    b, k = 4, 3

    def edit(cfg):
        cfg.data.max_range = 50.0
        cfg.data.min_range = 1.0
        cfg.engine.max_points_per_frame = 16384

    cfg, jcfg = _configs(None, edit)
    cap = cfg.engine.max_points_per_frame

    drives = [sh.make_drive(k, seq=s) for s in range(b)]
    pts = np.zeros((k, b, cap, 3), np.float32)
    ts = np.zeros((k, b, cap), np.float32)
    valid = np.zeros((k, b, cap), bool)
    for s, drive in enumerate(drives):
        for i in range(k):
            p, t = drive[i]
            n = min(len(p), cap)
            pts[i, s, :n] = p[:n]
            if len(t) >= n:
                ts[i, s, :n] = t[:n]
            valid[i, s, :n] = True

    bchunk = make_batched_chunked_step(cfg, make_mesh(device="cpu"))
    _, bposes = bchunk(init_batched_state(cfg, b, "cpu"), pts, ts, valid)
    bposes = bposes.numpy()  # (k, b, 4, 4)

    mesh = jax_make_mesh(4, pts_shards=1)
    jstate = jax.device_put(
        jax_init_batched_state(jcfg, b),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("seq")),
    )
    _, jposes = jax_make_batched_chunked_step(jcfg, mesh)(jstate, pts, ts, valid)
    np.testing.assert_allclose(bposes, np.asarray(jposes), atol=PARITY_ATOL,
                               err_msg="the port's batched step parted from JAX's")

    for s in range(b):
        state = odometry.init_state(cfg, "cpu")
        for i in range(k):
            state, res = odometry.register_frame(
                cfg, state, *(torch.from_numpy(a[i, s]) for a in (pts, ts, valid)))
            np.testing.assert_allclose(
                bposes[i, s], res.pose.numpy(), atol=1e-4,
                err_msg=f"sequence {s} frame {i} diverged in batched mode",
            )
