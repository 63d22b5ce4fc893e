"""Capacity-overflow surfacing in the port's pipeline: the pipeline half of
tests/test_overflow.py, with the port's OdometryPipeline (`device="cpu"`)
where the JAX test runs JAX's, on the same scans and configs.

Fixed-shape buffers drop on overflow where the reference's std::vector
structures grow (cpp/kiss_icp/core/VoxelHashMap.cpp:97-119), so the pipeline
warns on the first nonzero count of each kind (`pipeline.py`
`_check_overflow`): a downsample overflow, an input scan above
engine.max_points_per_frame (per frame and through the chunked driver), and
nothing when nothing overflows. Each count is also held to JAX's pipeline.
"""

import warnings

import numpy as np
import torch

from kiss_icp_tpu.config.schema import KISSConfig as JaxConfig
from kiss_icp_tpu.pipeline import OdometryPipeline as JaxPipeline
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.pipeline import OdometryPipeline

torch.set_num_threads(1)


def _config(cls=KISSConfig, frame_capacity=64, source_capacity=64, map_capacity_log2=13):
    cfg = cls()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 2048
    cfg.engine.frame_capacity = frame_capacity
    cfg.engine.source_capacity = source_capacity
    cfg.engine.map_capacity_log2 = map_capacity_log2
    cfg.engine.donate_state = False
    cfg.registration.max_num_iterations = 5
    return cfg


def _scan(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-30, 30, (n, 3)).astype(np.float32)


class _ListDataset:
    def __init__(self, scans):
        self._scans = scans

    def __len__(self):
        return len(self._scans)

    def __getitem__(self, idx):
        return self._scans[idx]


def _run(tmp_path, setup, **capacities):
    """The port's pipeline and JAX's over the same two scans, with `setup`
    applied to both configs. Returns (port pipeline, its RuntimeWarning
    messages, JAX pipeline)."""
    runs = []
    for label, cfg_cls, pipe_cls, extra in (("port", KISSConfig, OdometryPipeline,
                                             {"device": "cpu"}),
                                            ("jax", JaxConfig, JaxPipeline, {})):
        cfg = _config(cfg_cls, **capacities)
        setup(cfg)
        cfg.out_dir = str(tmp_path / label)
        pts = _scan()
        pipeline = pipe_cls(_ListDataset([pts, pts]), config=cfg, **extra)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pipeline.run()
        runs.append((pipeline, [str(w.message) for w in caught
                                if w.category is RuntimeWarning]))
    (ours, messages), (theirs, _) = runs
    for name in ("total_dropped_downsample", "total_dropped_map_voxels",
                 "total_dropped_input"):
        assert getattr(ours, name) == getattr(theirs, name), name
    return ours, messages, theirs


def test_pipeline_warns_on_overflow(tmp_path):
    pipeline, messages, _ = _run(tmp_path, lambda cfg: None,
                                 frame_capacity=64, source_capacity=64)
    assert any("frame_capacity" in m for m in messages), messages
    assert pipeline.total_dropped_downsample > 0


def test_pipeline_warns_on_input_truncation(tmp_path):
    """A scan above engine.max_points_per_frame is stride-subsampled by
    KissICP's padding: the first capacity gate is as loud as the others."""
    def setup(cfg):
        cfg.engine.max_points_per_frame = 1024  # the scans are 2048 points

    pipeline, messages, _ = _run(tmp_path, setup, frame_capacity=4096,
                                 source_capacity=2048, map_capacity_log2=15)
    assert any("max_points_per_frame" in m for m in messages), messages
    assert pipeline.total_dropped_input == 2 * 1024
    assert pipeline.odometry.total_input_dropped == 2 * 1024
    descs = [r.desc for r in pipeline.results.metrics]
    assert any("Dropped input points" in d for d in descs), descs


def test_chunked_pipeline_counts_input_truncation(tmp_path):
    def setup(cfg):
        cfg.engine.max_points_per_frame = 1024
        cfg.engine.pipeline_chunk = 2

    pipeline, messages, _ = _run(tmp_path, setup, frame_capacity=4096,
                                 source_capacity=2048, map_capacity_log2=15)
    assert any("max_points_per_frame" in m for m in messages), messages
    assert pipeline.total_dropped_input == 2 * 1024


def test_pipeline_silent_without_overflow(tmp_path):
    pipeline, messages, _ = _run(tmp_path, lambda cfg: None, frame_capacity=4096,
                                 source_capacity=2048, map_capacity_log2=15)
    assert not messages, messages
    assert pipeline.total_dropped_downsample == 0
    assert pipeline.total_dropped_map_voxels == 0
