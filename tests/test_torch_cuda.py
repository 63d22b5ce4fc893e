"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test asks the `cuda` fixture for the device, which skips
when `torch.cuda.is_available()` is False (as on a CPU-only machine). On a
machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

(`--noconftest`: tests/conftest.py sets up JAX, which this file does not
need and a machine with only PyTorch lacks.)

Tolerances: K1 (kernels/linsys.py) sums the plain version's f32 products
in f64, in another order than the plain einsum: rtol 2e-5 / atol 1e-3 as
tests/test_pallas_kernels.py, count exact, and two launches bit-identical
(no float atomics). K2 (kernels/nn27.py)
keeps the plain version's operation order with round-to-nearest intrinsics,
so found, distances and neighbours are bit-equal.
"""

import numpy as np
import pytest
import torch

from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.kernels import cases, linsys, nn27
from kiss_icp_tpu_torch.ops import hash_map as hm
from kiss_icp_tpu_torch.ops import registration

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda")


def _k1_case(n, seed, masked, dev):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    tgt = (src + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    mask = rng.random(n) > 0.3 if masked else np.zeros(n, bool)
    return (torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev),
            torch.from_numpy(mask).to(dev),
            torch.tensor(0.7, device=dev), torch.tensor([3.0, -2.0, 1.0], device=dev))


# n = 0 and an all-masked input give exactly 0; 8193 is one past the main
# path's width (a ragged last tile); 100 000 makes each block of the
# cluster grid-stride over many tiles.
@pytest.mark.parametrize("n,masked", [(8192, True), (5000, True), (100, True),
                                      (8192, False), (0, True), (1, True),
                                      (8193, True), (100_000, True)])
def test_linsys_kernel_matches_plain(cuda, n, masked):
    args = _k1_case(n, n, masked, cuda)
    before = linsys.build_linear_system.launches
    got = linsys.build_linear_system(*args)
    again = linsys.build_linear_system(*args)
    ref = registration.build_linear_system(*args)
    torch.cuda.synchronize()
    assert linsys.build_linear_system.launches == before + 2
    torch.testing.assert_close(got.jtj, ref.jtj, rtol=2e-5, atol=1e-3)
    torch.testing.assert_close(got.jtr, ref.jtr, rtol=2e-5, atol=1e-3)
    assert int(got.num_correspondences) == int(ref.num_correspondences)
    assert torch.equal(got.jtj, again.jtj) and torch.equal(got.jtr, again.jtr)
    if not masked or n == 0:
        assert bool(torch.all(got.jtj == 0)) and bool(torch.all(got.jtr == 0))
        assert int(got.num_correspondences) == 0


def _unaligned(t):
    """A contiguous copy of `t` one element past an aligned address."""
    buf = torch.empty(t.numel() + t[:1].numel(), dtype=t.dtype, device=t.device)
    out = buf[t[:1].numel():].view(t.shape)
    out.copy_(t)
    return out


def test_linsys_kernel_unaligned_inputs(cuda):
    """Inputs off the 16 B (src, tgt) and 4 B (mask) alignment take the
    scalar staging path, which stages the same values: identical bits."""
    args = _k1_case(8193, 7, True, cuda)
    got = linsys.build_linear_system(*args)
    src, tgt, mask = (_unaligned(a) for a in args[:3])
    assert src.data_ptr() % 16 and mask.data_ptr() % 4
    off = linsys.build_linear_system(src, tgt, mask, *args[3:])
    torch.cuda.synchronize()
    assert torch.equal(got.jtj, off.jtj) and torch.equal(got.jtr, off.jtr)
    assert int(got.num_correspondences) == int(off.num_correspondences)


def _map(storage, dev, max_points=20, seed=0, capacity_log2=14, probe_length=16):
    cfg = hm.MapConfig(voxel_size=1.0, max_distance=30.0, max_points_per_voxel=max_points,
                       capacity_log2=capacity_log2, probe_length=probe_length,
                       storage=storage)
    m = hm.create_map(cfg, device=dev)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        pts = torch.from_numpy(rng.uniform(-12, 12, (3000, 3)).astype(np.float32)).to(dev)
        m, _ = hm.insert(cfg, m, pts, torch.ones(3000, dtype=torch.bool, device=dev))
    return cfg, m


def _assert_nn_bit_equal(cfg, m, q, valid):
    before = nn27.query_nearest.launches
    got = nn27.query_nearest(cfg, m, q, valid)
    ref = hm.query_nearest(cfg, m, q, valid)
    torch.cuda.synchronize()
    assert nn27.query_nearest.launches == before + 1
    assert torch.equal(got.found, ref.found)
    # Bits, so that NaN distances compare too.
    assert torch.equal(got.distances.view(torch.int32), ref.distances.view(torch.int32))
    assert torch.equal(got.neighbors, ref.neighbors)
    return got


@pytest.mark.parametrize("storage", ["f32", "u16"])
@pytest.mark.parametrize("max_points", [5, 20])
def test_nn27_kernel_bit_equal_to_plain(cuda, storage, max_points):
    cfg, m = _map(storage, cuda, max_points)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.uniform(-14, 14, (4096, 3)).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random(4096) > 0.1).to(cuda)
    got = _assert_nn_bit_equal(cfg, m, q, valid)
    assert int(got.found.sum()) > 1000


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_nn27_hand_made_rules(cuda, name):
    """A tie across neighbour voxels goes to the lower neighbour index; the
    first fingerprint match in the window decides; a NaN distance wins
    (kernels/cases.py)."""
    case = cases.CASES[name]()
    cfg, m = cases.to_map(case, cuda)
    got = _assert_nn_bit_equal(cfg, m, torch.from_numpy(case.queries).to(cuda),
                               torch.from_numpy(case.valid).to(cuda))
    assert np.array_equal(got.neighbors.cpu().numpy(), case.neighbors)
    assert np.array_equal(got.distances.cpu().numpy(), case.distances, equal_nan=True)
    assert np.array_equal(got.found.cpu().numpy(), case.found)


@pytest.mark.parametrize("probe_length,shift", [(16, True), (8, False), (4, False),
                                                 (2, False)])
def test_nn27_probe_paths(cuda, probe_length, shift):
    """16 B window loads (probe length a multiple of 4, table 16 B aligned)
    and the scalar probe (probe length 2, or the table shifted by 4 B)."""
    cfg, m = _map("f32", cuda, probe_length=probe_length)
    if shift:
        m = m._replace(fprints=_unaligned(m.fprints))
        assert m.fprints.data_ptr() % 16
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.uniform(-14, 14, (4096, 3)).astype(np.float32)).to(cuda)
    got = _assert_nn_bit_equal(cfg, m, q, torch.ones(4096, dtype=torch.bool, device=cuda))
    assert int(got.found.sum()) > 1000


def test_nn27_nan_queries(cuda):
    """NaN queries: a NaN distance wins the plain version's argmin."""
    cfg, m = _map("f32", cuda)
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.uniform(-14, 14, (4096, 3)).astype(np.float32)).to(cuda)
    q[::5, 1] = float("nan")
    got = _assert_nn_bit_equal(cfg, m, q, torch.ones(4096, dtype=torch.bool, device=cuda))
    assert not bool(got.found[::5].any()) and int(got.found.sum()) > 1000


def test_nn27_many_waves(cuda):
    """100 000 queries against a 2^19-slot map: many more warps than the
    card holds at once."""
    cfg, m = _map("u16", cuda, capacity_log2=19)
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.uniform(-14, 14, (100_000, 3)).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random(100_000) > 0.1).to(cuda)
    got = _assert_nn_bit_equal(cfg, m, q, valid)
    assert int(got.found.sum()) > 50_000


def test_nn27_empty_map_and_tie(cuda):
    cfg = hm.MapConfig(voxel_size=1.0, capacity_log2=10)
    got = nn27.query_nearest(cfg, hm.create_map(cfg, device=cuda),
                             torch.zeros(64, 3, device=cuda),
                             torch.ones(64, dtype=torch.bool, device=cuda))
    assert not bool(got.found.any()) and bool(torch.isinf(got.distances).all())
    cfg = hm.MapConfig(voxel_size=1.0, max_distance=30.0, max_points_per_voxel=4,
                       capacity_log2=10)
    pts = torch.tensor([[0.5, 0.5, 0.25], [0.5, 0.5, 0.75]], device=cuda)
    m, _ = hm.insert(cfg, hm.create_map(cfg, device=cuda), pts,
                     torch.ones(2, dtype=torch.bool, device=cuda))
    got = nn27.query_nearest(cfg, m, torch.tensor([[0.5, 0.5, 0.5]], device=cuda),
                             torch.ones(1, dtype=torch.bool, device=cuda))
    assert torch.equal(got.neighbors, pts[:1])


def test_wrappers_refuse_bad_tensors(cuda):
    args = list(_k1_case(256, 0, True, cuda))
    args[0] = args[0].double()
    with pytest.raises(ValueError):
        linsys.build_linear_system(*args)
    cfg, m = _map("f32", cuda)
    q = torch.zeros(8, 3, device=cuda).t().contiguous().t()  # not contiguous
    with pytest.raises(ValueError):
        nn27.query_nearest(cfg, m, q, torch.ones(8, dtype=torch.bool, device=cuda))


def test_small_drive_card_matches_cpu(cuda):
    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
    from kiss_icp_tpu_torch.odometry import KissICP

    cfg = KISSConfig()
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 8192
    cfg.engine.frame_capacity = 8192
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 15
    ds = SyntheticDataset(sequence=1, n_scans=3, n_beams=16, n_azimuth=512,
                          speed=1.0, accel_frames=6)
    runs = {}
    for dev in ("cuda", "cpu"):
        icp = KissICP(cfg, device=dev)
        runs[dev] = []
        for i in range(3):
            icp.register_frame(*ds[i])
            runs[dev].append((icp.last_pose, icp.last_result.num_iterations))
    for (pg, ig), (pc, ic) in zip(runs["cuda"], runs["cpu"]):
        np.testing.assert_allclose(pg, pc, atol=1e-4)
        assert ig == ic


def _bits(t):
    """A tensor's bits on the CPU, so that float and u16 fields compare
    exactly (u16 crosses as int16: PyTorch has few CUDA kernels for it)."""
    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _map_cpu(m):
    return hm.VoxelMap(*(t.view(torch.int16).cpu().view(torch.uint16)
                         if t.dtype == torch.uint16 else t.cpu() for t in m))


@pytest.mark.parametrize("storage", ["f32", "u16"])
@pytest.mark.parametrize("capacity_log2,shift", [(14, [7, -5, 3]), (8, [3, 3, 3])])
def test_rebase_card_bit_equal_to_cpu(cuda, storage, capacity_log2, shift):
    """hash_map.rebase on the card gives the CPU's table bit for bit, the
    drop count included (2^8 slots: an over-full map whose rebuild drops)."""
    cfg, m = _map(storage, cuda, capacity_log2=capacity_log2)
    s = torch.tensor(shift, dtype=torch.int32)
    got, dropped = hm.rebase(cfg, m, s.to(cuda))
    ref, ref_dropped = hm.rebase(cfg, _map_cpu(m), s)
    assert int(dropped) == int(ref_dropped)
    assert (int(dropped) > 0) == (capacity_log2 == 8)
    for name, a, b in zip(hm.VoxelMap._fields, got, ref):
        assert torch.equal(_bits(a), _bits(b)), name


def _drive_config(storage="f32", trigger=3):
    cfg = KISSConfig()
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 1.0
    cfg.engine.max_points_per_frame = 8192
    cfg.engine.frame_capacity = 8192
    cfg.engine.source_capacity = 2048
    cfg.engine.map_capacity_log2 = 15
    cfg.engine.map_storage = storage
    cfg.engine.rebase_trigger_voxels = trigger
    return cfg


def _drive_scans(n):
    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset

    ds = SyntheticDataset(sequence=1, n_scans=n, n_beams=16, n_azimuth=512,
                          speed=1.0, accel_frames=3)
    return [ds[i] for i in range(n)]


def test_chunked_on_card_equals_streaming_on_card(cuda):
    from kiss_icp_tpu_torch.odometry import KissICP

    scans = _drive_scans(6)
    stream = KissICP(_drive_config(trigger=0), device="cuda")
    ref = []
    for f, t in scans:
        stream.register_frame(f, t)
        ref.append(stream.last_pose)
    chunked = KissICP(_drive_config(trigger=0), device="cuda")
    got = []
    for a in (0, 3):
        got.extend(chunked.register_frames_chunked([s[0] for s in scans[a:a + 3]],
                                                   [s[1] for s in scans[a:a + 3]]))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_checkpoint_on_card_resumes_bit_identical(cuda, storage, tmp_path):
    from kiss_icp_tpu_torch import convert
    from kiss_icp_tpu_torch.odometry import KissICP

    # The trigger of 2 voxels fires at the seventh frame (3 m from the start).
    scans = _drive_scans(8)
    icp = KissICP(_drive_config(storage, trigger=2), device="cuda")
    for f, t in scans[:7]:
        icp.register_frame(f, t)
    assert np.any(icp.origin != 0)
    path = tmp_path / "ckpt.npz"
    icp.save_checkpoint(path)
    resumed = KissICP(_drive_config(storage, trigger=2), device="cuda")
    resumed.load_checkpoint(path)
    for a, b in zip(convert.state_to_numpy(resumed.state), convert.state_to_numpy(icp.state)):
        np.testing.assert_array_equal(a, b)
    icp.register_frame(*scans[7])
    resumed.register_frame(*scans[7])
    np.testing.assert_array_equal(resumed.last_pose, icp.last_pose)
    np.testing.assert_array_equal(resumed.origin, icp.origin)
