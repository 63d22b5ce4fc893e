"""The card renderer against the port's host renderer
(`kiss_icp_tpu_torch.datasets.synthetic.SyntheticDataset`), ray by ray, on
the same seeds and the same noise draws.

Both compute the same float64 formulas, but in another order (PyTorch's
matrix products and transcendental functions are not NumPy's), so values
agree to ~1e-10 and a ray whose value lies within that of a threshold of
the hit test (a box entry beyond 0.1 m, the ground-or-box comparison at
1e-9, the range limit, the dropout draw) can land on the other side. Such
flips are allowed, a few a frame; every ray both keep must agree.
"""

import numpy as np
import pytest
import torch

from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
from odobench.scans import Drive, Sensor

FLIPS_A_FRAME = 3


def _host_rays(ds: SyntheticDataset, idx: int):
    """The original's per-ray (range, kept), before compaction (the first
    half of its `__getitem__`)."""
    poses = ds._poses_during_scan(idx)
    off = np.array([0.0, 0.0, 1.8])
    origins = poses[:, :3, 3] + poses[:, :3, :3] @ off
    dirs = np.einsum("rij,rj->ri", poses[:, :3, :3], ds._dirs_body)
    t, on_ground = ds._raycast(origins, dirs)
    hit_pt = origins + t[:, None] * dirs
    relief = (0.12 * np.sin(3.1 * hit_pt[:, 0]) * np.sin(2.7 * hit_pt[:, 1])
              * np.sin(2.3 * hit_pt[:, 2] + 0.7)
              + 0.06 * np.sin(7.3 * hit_pt[:, 0] + 1.3) * np.sin(6.1 * hit_pt[:, 2]))
    t = t + np.where(on_ground, 0.4 * relief, relief)
    rng = np.random.default_rng(ds._noise_seed + idx)
    grazing = np.where(on_ground, np.minimum(np.abs(t) / 1.8, 25.0), 1.0)
    t = t + rng.normal(0.0, 1.0, size=t.shape) * ds._noise * grazing
    keep = rng.random(t.shape) > ds._dropout
    return t, (t < ds._max_range) & keep


def _pair(seq: int, distort: bool, n: int, device="cpu"):
    kw = dict(n_beams=16, n_azimuth=128)
    ds = SyntheticDataset(sequence=seq, n_scans=n, speed=1.0, accel_frames=30,
                          distort=distort, **kw)
    drive = Drive(Sensor(distort=distort, **kw), n, world_seed=1234 + seq,
                  noise_seed=5678 + seq, speed=1.0, accel_frames=30, device=device,
                  noise_source="numpy")
    return ds, drive


def _compare(ds, drive, frames):
    np.testing.assert_array_equal(drive.render_poses, ds._render_poses)
    np.testing.assert_array_equal(drive.boxes_np, np.array(ds._boxes).reshape(-1, 2, 3))
    for idx in frames:
        t_host, kept_host = _host_rays(ds, idx)
        t_card, kept_card = (x[0].cpu().numpy() for x in drive.render_rays(idx))
        assert int(np.sum(kept_host != kept_card)) <= FLIPS_A_FRAME
        both = kept_host & kept_card
        np.testing.assert_allclose(t_card[both], t_host[both], rtol=0, atol=1e-8)


@pytest.mark.parametrize("distort", [True, False])
def test_renderer_matches_the_host_renderer(distort):
    ds, drive = _pair(2, distort, 6)
    _compare(ds, drive, range(6))
    # The compacted scans too: the arrays a loader gives.
    for idx, (pts, stamps) in enumerate(drive.render()):
        host_pts, host_stamps = ds[idx]
        if pts.shape == host_pts.shape:
            np.testing.assert_allclose(pts, host_pts, rtol=0, atol=1e-8)
            np.testing.assert_array_equal(stamps, host_stamps)
        assert pts.dtype == np.float64 and stamps.dtype == np.float64
        assert abs(pts.shape[0] - host_pts.shape[0]) <= FLIPS_A_FRAME


def test_device_noise_is_the_seed():
    """The benchmark's draws come from a torch.Generator: the same seed
    gives the same scans, another seed other ones."""
    sensor = Sensor(n_beams=16, n_azimuth=128)

    def scans(noise_seed):
        return Drive(sensor, 3, world_seed=5, noise_seed=noise_seed).render()

    a, b, c = scans(2**40 + 7), scans(2**40 + 7), scans(2**40 + 8)
    for (pa, sa), (pb, sb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(sa, sb)
    assert any(pa.shape != pc.shape or not np.array_equal(pa, pc)
               for (pa, _), (pc, _) in zip(a, c))


@pytest.mark.gpu
def test_card_render_matches_the_host_renderer():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ds, drive = _pair(1, True, 4, device="cuda")
    _compare(ds, drive, range(4))
