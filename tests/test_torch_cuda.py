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
so found, distances and neighbours are bit-equal. Also on the card: the
registered operators `kiss_icp_torch::linsys` / `::nn27` under
`torch.library.opcheck`, and a step exported by io/aot.py against the live
step, bit for bit.

The batched operators (`::linsys_batched`, `::nn27_batched`: the same
kernels over B stacked rows, one launch, with a per-row `active` flag) are
held bit for bit to the unbatched kernel row by row, on the hand-made maps
too; an inactive row does no work and gives the defined empty answer; the
batched plain versions equal the kernels as the unbatched ones do; and the
lockstep batched step on the card launches each kernel once per lockstep
iteration and matches the same step on the CPU. The map-sharded step's
calls (the D shard tables as rows, one source expanded over them, the D
stripes) are bit-equal row by row to the unbatched kernel, and a 3-frame
map-sharded drive on the card launches each kernel once per GN iteration
for all shards and matches the CPU within 1e-5 m. The port's bench
(tools/bench.py) headline child runs at a small config on the card and on
the CPU: the same iterations, poses within 1e-4 m, and one K1 launch a GN
iteration. A chunk and a lockstep step under the sync debug mode and the
profiler: every host sync inside a `kiss/sync/*` span (kiss_icp_tpu_torch/
trace.py), the batch's pageable copies inside `kiss/h2d`, and every kernel
launch inside a `kiss/` span. The Gauss-Newton loop on CUDA graphs
(ops/control.py: a trip after the first on a set of map tables is a graph
replay) against the Python loop on the same card, bit for bit with the same
K1/K2 launches: the single loop at gn_unroll 1 and 2 (a fresh state and a
re-base each capture anew), four lockstep rows whose solves end at
different trips, and the map-shard loop at map_shards 2.
"""

import numpy as np
import pytest
import torch

from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.kernels import cases, linsys, nn27
from kiss_icp_tpu_torch.ops import hash_map as hm
from kiss_icp_tpu_torch.ops import registration, se3

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


def _queries(dev, n=4096, seed=5):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.uniform(-14, 14, (n, 3)).astype(np.float32)).to(dev)
    q[::97, 2] = float("nan")
    return q, torch.from_numpy(rng.random(n) > 0.1).to(dev)


def _d2(q, nb):
    """(dx^2 + dy^2) + dz^2 of query to neighbour, each step rounded, on the
    tensors' own device (the order of hash_map.score_candidates and K2)."""
    sq = (q - nb) * (q - nb)
    return (sq[:, 0] + sq[:, 1]) + sq[:, 2]


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_loop27_on_card_launches_k2_and_equals_cpu_loop(cuda, storage):
    """nn_mode "loop27" runs K2 on the card; its answers are those of the
    27-offset loop wherever a query is found: bit for bit on the card. On
    the CPU the neighbours and their d² are bit-equal too; the distances
    differ only by the final sqrt: K2's is the correctly rounded root of d²
    (f64 sqrt rounded to f32), the CPU's torch.sqrt is one ulp away from it
    on some values (its vectorised path is not correctly rounded)."""
    cfg, m = _map(storage, cuda)
    q, valid = _queries(cuda)
    before = nn27.query_nearest.launches
    res = registration.align_points_to_map(
        cfg, m, q[:512].nan_to_num(), valid[:512], torch.eye(4, device=cuda),
        torch.tensor(3.0, device=cuda), torch.tensor(1.0, device=cuda),
        max_iterations=5, convergence=1e-4, nn_mode="loop27")
    torch.cuda.synchronize()
    assert nn27.query_nearest.launches == before + res.num_iterations + 1
    got = nn27.query_nearest(cfg, m, q, valid)
    loop = hm.query_nearest_loop(cfg, m, q, valid)
    assert torch.equal(loop.found, got.found)
    f = got.found
    assert torch.equal(loop.distances[f], got.distances[f])
    assert torch.equal(loop.neighbors[f], got.neighbors[f])
    ref = hm.query_nearest_loop(cfg, _map_cpu(m), q.cpu(), valid.cpu())
    f = ref.found
    assert torch.equal(got.found.cpu(), f)
    assert torch.equal(got.neighbors.cpu()[f], ref.neighbors[f])
    d2 = _d2(q.cpu(), ref.neighbors)
    assert torch.equal(_bits(_d2(q, got.neighbors).cpu()[f]), _bits(d2[f]))
    assert torch.equal(_bits(ref.distances[f]), _bits(torch.sqrt(d2)[f]))
    exact = torch.sqrt(d2[f].double()).float()
    assert torch.equal(_bits(got.distances.cpu()[f]), _bits(exact))
    ulps = (_bits(ref.distances[f]) - _bits(exact)).abs()
    assert int(ulps.max()) <= 1


@pytest.mark.parametrize("nn_mode", ["compact", "compact_loop"])
@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_compact_view_on_card(cuda, storage, nn_mode):
    """build_compact on the card gives the CPU's view bit for bit, and a
    registration in a compact mode on the card launches K2 once an
    iteration and once for the final count, and gives gather27's bits."""
    from kiss_icp_tpu_torch.ops import compact_map as cm

    cfg, m = _map(storage, cuda)
    ccfg = cm.CompactConfig(live_capacity_log2=13, hash_capacity_log2=15)
    view = cm.build_compact(cfg, ccfg, m)
    ref_view = cm.build_compact(cfg, ccfg, _map_cpu(m))
    for name, a, b in zip(cm.CompactMap._fields, view, ref_view):
        assert torch.equal(_bits(a), _bits(b)), name
    assert int(view.num_dropped) == 0
    q, valid = _queries(cuda)
    args = (cfg, m, q[:512].nan_to_num(), valid[:512], torch.eye(4, device=cuda),
            torch.tensor(3.0, device=cuda), torch.tensor(1.0, device=cuda))
    common = dict(max_iterations=5, convergence=1e-4, nn_live_capacity_log2=13)
    ref = registration.align_points_to_map(*args, nn_mode="gather27", **common)
    before = nn27.query_nearest.launches
    res = registration.align_points_to_map(*args, nn_mode=nn_mode, **common)
    torch.cuda.synchronize()
    assert nn27.query_nearest.launches == before + res.num_iterations + 1
    assert torch.equal(res.pose, ref.pose) and res.num_iterations == ref.num_iterations
    assert int(res.num_dropped_compact) == 0


def test_query_topc_on_card_equals_cpu(cuda):
    cfg, m = _map("f32", cuda)
    q, _ = _queries(cuda)
    cand, cval = hm.query_topc(cfg, m, q, 8)
    ref_cand, ref_cval = hm.query_topc(cfg, _map_cpu(m), q.cpu(), 8)
    assert torch.equal(cval.cpu(), ref_cval)
    assert torch.equal(cand.cpu()[ref_cval], ref_cand[ref_cval])
    assert int(ref_cval.sum()) > 10_000


def test_ground_fit_on_card_equals_cpu(cuda):
    from kiss_icp_tpu_torch.ops import ground

    rng = np.random.default_rng(6)
    r, th = rng.uniform(4, 28, 6000), rng.uniform(0, 2 * np.pi, 6000)
    pts = np.stack([r * np.cos(th), r * np.sin(th),
                    0.02 * r * np.cos(th) - 1.7 + rng.normal(0, 0.01, 6000)], 1)
    pts = torch.from_numpy(pts.astype(np.float32))
    valid = torch.from_numpy(rng.random(6000) > 0.1)
    assert torch.equal(_bits(ground.nanquantile(pts[:, 2].to(cuda), 0.15)),
                       _bits(ground.nanquantile(pts[:, 2], 0.15)))
    got = ground.estimate_ground_plane(pts.to(cuda), valid.to(cuda))
    ref = ground.estimate_ground_plane(pts, valid)
    assert bool(got.ok) and bool(ref.ok) and int(got.num_points) == int(ref.num_points)
    torch.testing.assert_close(got.normal_body.cpu(), ref.normal_body, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine", [
    dict(nn_mode="loop27"), dict(nn_mode="compact"), dict(nn_mode="compact_loop"),
    dict(nn_mode="cached"), dict(nn_mode="compact", nn_live_capacity_log2=6),
    dict(deskew_refine=1), dict(deskew_refine_map=True), dict(ground_align=0.1)],
    ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()))
def test_small_drive_modes_card_match_cpu(cuda, engine):
    """Every mode and option: 3 frames on the card and on the CPU within
    atol 1e-4, iterations and drops equal; K1 launched on the card."""
    from kiss_icp_tpu_torch.odometry import KissICP

    cfg = _drive_config(trigger=0)
    for key, value in engine.items():
        setattr(cfg.engine, key, value)
    scans = _drive_scans(3)
    runs = {}
    before = linsys.build_linear_system.launches
    for dev in ("cuda", "cpu"):
        icp = KissICP(cfg, device=dev)
        runs[dev] = []
        for f, t in scans:
            icp.register_frame(f, t)
            runs[dev].append((icp.last_pose, icp.last_result.num_iterations,
                              icp.last_overflow()))
    assert linsys.build_linear_system.launches > before
    for (pg, ig, dg), (pc, ic, dc) in zip(runs["cuda"], runs["cpu"]):
        np.testing.assert_allclose(pg, pc, atol=1e-4)
        assert ig == ic and dg == dc


@pytest.mark.parametrize("op", ["linsys", "nn27"])
def test_operators_pass_opcheck_on_card(cuda, op):
    """The registered operators' CUDA implementations against their schemas
    and fake implementations (`torch.library.opcheck`), at the main path's
    8192 queries. An f32 map: opcheck compares and copies the inputs, and
    PyTorch has few CUDA kernels for uint16 (the u16 map is checked on the
    CPU, tests/test_torch_ops_export.py)."""
    if op == "linsys":
        args = _k1_case(8192, 3, True, cuda)
    else:
        cfg, m = _map("f32", cuda)
        rng = np.random.default_rng(4)
        q = torch.from_numpy(rng.uniform(-12, 12, (8192, 3)).astype(np.float32)).to(cuda)
        args = (q, torch.from_numpy(rng.random(8192) > 0.1).to(cuda), m.vkeys, m.fprints,
                m.counts, m.points, float(cfg.voxel_size), int(cfg.probe_length))
    torch.library.opcheck(getattr(torch.ops.kiss_icp_torch, op).default, args)


def test_exported_step_on_card_matches_live(cuda, tmp_path):
    """A step exported on the card (io/aot.py), loaded and driven over four
    frames: poses, iterations and the map bit-identical to the live step,
    with the live step's K1 and K2 launches."""
    from kiss_icp_tpu_torch import odometry
    from kiss_icp_tpu_torch.io import aot

    cfg = KISSConfig()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 4096
    cfg.engine.frame_capacity = 4096
    cfg.engine.source_capacity = 1024
    cfg.engine.map_capacity_log2 = 15
    aot.save_step(tmp_path / "step.npz", cfg)
    step, meta = aot.load_step(tmp_path / "step.npz")
    assert meta["device_type"] == "cuda"
    base = np.random.default_rng(2).uniform(-30, 30, (4096, 3)).astype(np.float32)
    runs = {}
    for label, fn in (("live", odometry.make_step(cfg)), ("artifact", step)):
        state = odometry.init_state(cfg)
        k1, k2 = linsys.build_linear_system.launches, nn27.query_nearest.launches
        out = []
        for i in range(4):
            pts = torch.from_numpy(base + np.float32([0.3, 0.04, 0.0]) * i).to(cuda)
            state, res = fn(state, pts, torch.zeros(4096, device=cuda),
                            torch.ones(4096, dtype=torch.bool, device=cuda))
            out.append((res.pose, int(res.num_iterations)))
        runs[label] = (out, state, linsys.build_linear_system.launches - k1,
                       nn27.query_nearest.launches - k2)
    (live, lstate, l1, l2), (art, astate, a1, a2) = runs["live"], runs["artifact"]
    assert all(torch.equal(a[0], b[0]) and a[1] == b[1] for a, b in zip(live, art))
    assert all(torch.equal(a, b) for a, b in zip(lstate.map, astate.map))
    assert (a1, a2) == (l1, l2) and l1 > 0 and l2 > 0


def _stacked_k1(b, n, dev):
    rows = [_k1_case(n, 10 + i, True, dev) for i in range(b)]
    src, tgt, mask = (torch.stack([r[j] for r in rows]) for j in range(3))
    scale = torch.tensor([0.7, 1.3, 0.4, 2.0][:b], device=dev)
    center = torch.tensor([[3.0, -2.0, 1.0], [0.0, 5.0, -1.0], [-4.0, 1.0, 2.0],
                           [1.0, 1.0, 1.0]][:b], device=dev)
    return src, tgt, mask, scale, center


# 8193: rows start off the 16 B alignment (the scalar staging path).
@pytest.mark.parametrize("n", [8192, 8193, 100, 0])
def test_linsys_batched_rows_bit_equal_to_unbatched(cuda, n):
    src, tgt, mask, scale, center = _stacked_k1(4, n, cuda)
    active = torch.tensor([True, True, False, True], device=cuda)
    before = linsys.build_linear_system.launches
    got = linsys.build_linear_systems(src, tgt, mask, scale, center, active)
    torch.cuda.synchronize()
    assert linsys.build_linear_system.launches == before + 1
    plain = linsys.plain_linsys_batched(src, tgt, mask, scale, center, active)
    for b in range(4):
        if not bool(active[b]):
            assert not bool(got.jtj[b].any()) and not bool(got.jtr[b].any())
            assert int(got.num_correspondences[b]) == 0
            continue
        one = linsys.build_linear_system(src[b], tgt[b], mask[b], scale[b],
                                         center[b].contiguous())
        assert torch.equal(got.jtj[b], one.jtj) and torch.equal(got.jtr[b], one.jtr)
        assert int(got.num_correspondences[b]) == int(one.num_correspondences)
        torch.testing.assert_close(got.jtj[b], plain[0][b], rtol=2e-5, atol=1e-3)
        torch.testing.assert_close(got.jtr[b], plain[1][b], rtol=2e-5, atol=1e-3)
        assert int(got.num_correspondences[b]) == int(plain[2][b])


def _stack_maps(rows):
    """Maps stacked on a leading axis (u16 points as their int16 bits: CUDA
    has few uint16 kernels)."""
    def stack(ts):
        if ts[0].dtype == torch.uint16:
            return torch.stack([t.view(torch.int16) for t in ts]).view(torch.uint16)
        return torch.stack(ts)
    return hm.VoxelMap(*(stack(f) for f in zip(*rows)))


def _assert_nn_rows(cfg, m, rows, q, valid, active):
    """The batched kernel against the unbatched kernel row by row, and
    against the batched plain version on the card, bit for bit."""
    before = nn27.query_nearest.launches
    got = nn27.query_nearest_batched(cfg, m, q, valid, active)
    torch.cuda.synchronize()
    assert nn27.query_nearest.launches == before + 1
    plain = nn27.plain_nn27_batched(q, valid, active, *m[:4], float(cfg.voxel_size),
                                    int(cfg.probe_length))
    for b in range(q.shape[0]):
        for x, y in zip(got, plain):
            assert torch.equal(x[b].view(torch.int8), y[b].view(torch.int8))
        if not bool(active[b]):
            assert not bool(got.found[b].any()) and bool(torch.isinf(got.distances[b]).all())
            continue
        one = nn27.query_nearest(cfg, rows[b], q[b], valid[b])
        assert torch.equal(got.found[b], one.found)
        assert torch.equal(got.distances[b].view(torch.int32), one.distances.view(torch.int32))
        assert torch.equal(got.neighbors[b], one.neighbors)
    return got


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_nn27_batched_bit_equal_to_unbatched(cuda, storage):
    rows = [_map(storage, cuda, 20, seed=s)[1] for s in range(3)]
    cfg = _map(storage, cuda, 20)[0]
    m = _stack_maps(rows)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.uniform(-14, 14, (3, 4096, 3)).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random((3, 4096)) > 0.1).to(cuda)
    got = _assert_nn_rows(cfg, m, rows, q, valid,
                          torch.tensor([True, False, True], device=cuda))
    assert int(got.found[0].sum()) > 1000


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_nn27_batched_hand_made_rules(cuda, name):
    """Each hand-made map twice, the second row with its queries shifted:
    row 0 gives the case's answer, both rows the unbatched kernel's."""
    case = cases.CASES[name]()
    cfg, one = cases.to_map(case, cuda)
    m = _stack_maps([one, one])
    q0 = torch.from_numpy(case.queries).to(cuda)
    q = torch.stack([q0, q0 + 0.25])
    valid = torch.from_numpy(case.valid).to(cuda).expand(2, -1).contiguous()
    got = _assert_nn_rows(cfg, m, [one, one], q, valid,
                          torch.ones(2, dtype=torch.bool, device=cuda))
    assert np.array_equal(got.neighbors[0].cpu().numpy(), case.neighbors)
    assert np.array_equal(got.distances[0].cpu().numpy(), case.distances, equal_nan=True)
    assert np.array_equal(got.found[0].cpu().numpy(), case.found)


@pytest.mark.parametrize("op", ["linsys_batched", "nn27_batched"])
def test_batched_operators_pass_opcheck_on_card(cuda, op):
    if op == "linsys_batched":
        args = _stacked_k1(3, 8192, cuda) + (torch.tensor([True, False, True], device=cuda),)
    else:
        rows = [_map("f32", cuda, 20, seed=s)[1] for s in range(2)]
        cfg = _map("f32", cuda, 20)[0]
        m = _stack_maps(rows)
        rng = np.random.default_rng(4)
        q = torch.from_numpy(rng.uniform(-12, 12, (2, 8192, 3)).astype(np.float32)).to(cuda)
        args = (q, torch.from_numpy(rng.random((2, 8192)) > 0.1).to(cuda),
                torch.tensor([True, False], device=cuda), m.vkeys, m.fprints, m.counts,
                m.points, float(cfg.voxel_size), int(cfg.probe_length))
    torch.library.opcheck(getattr(torch.ops.kiss_icp_torch, op).default, args)


def test_lockstep_step_on_card_matches_cpu_and_launches_once_per_iteration(cuda):
    """Three sequences at distinct velocities through the batched step on the
    card and on the CPU: equal iterations, poses within 1e-4; on the card K1
    launches once per lockstep iteration and K2 once more a frame."""
    from kiss_icp_tpu_torch.parallel import batch as pbatch

    cfg = KISSConfig()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 4096
    cfg.engine.frame_capacity = 4096
    cfg.engine.source_capacity = 1024
    cfg.engine.map_capacity_log2 = 15
    b, k = 3, 4
    rng = np.random.default_rng(2)
    base = rng.uniform(-30, 30, (b, 4096, 3)).astype(np.float32)
    pts = np.stack([base + np.arange(1, b + 1)[:, None, None].astype(np.float32)
                    * np.float32([0.15, 0.02, 0.0]) * i for i in range(k)])
    ts, valid = np.zeros((k, b, 4096), np.float32), np.ones((k, b, 4096), bool)
    runs = {}
    for d in ("cuda", "cpu"):
        step = pbatch.make_batched_step(cfg, pbatch.make_mesh(device=d))
        state = pbatch.init_batched_state(cfg, b, d)
        k1, k2 = linsys.build_linear_system.launches, nn27.query_nearest.launches
        poses, iters = [], []
        for i in range(k):
            state, res = step(state, pts[i], ts[i], valid[i])
            poses.append(res.pose.cpu().numpy())
            iters.append(res.num_iterations.cpu().numpy())
        runs[d] = (np.stack(poses), np.stack(iters), linsys.build_linear_system.launches - k1,
                   nn27.query_nearest.launches - k2)
    (pc, ic, c1, c2), (pp, ip, _, _) = runs["cuda"], runs["cpu"]
    np.testing.assert_array_equal(ic, ip)
    np.testing.assert_allclose(pc, pp, atol=1e-4)
    lockstep = int(ic.max(axis=1).sum())
    assert (c1, c2) == (lockstep, lockstep + k - 1) and lockstep > 0


def _sharded_config(shards):
    cfg = KISSConfig()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 4096
    cfg.engine.frame_capacity = 4096
    cfg.engine.source_capacity = 1024
    cfg.engine.map_capacity_log2 = 15
    cfg.engine.map_shards = shards
    cfg.registration.max_num_iterations = 20
    return cfg


def _sharded_scans(k=3, n=4000, seed=6):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    return [base + np.float32([0.3, 0.05, 0.0]) * i for i in range(k)]


@pytest.mark.parametrize("storage", ["f32", "u16"])
def test_batched_kernels_over_shard_rows_bit_equal(cuda, storage):
    """The map-sharded step's kernel calls (parallel/sharded_map.py): the
    batched K2 with the D = 4 shard tables as rows and one source expanded
    over them, the batched K1 over the D stripes. The expanded (stride-0)
    source is refused by the wrappers as it stands; made contiguous, each
    row is bit-equal to the unbatched kernel on that shard and to the plain
    versions (K1 within its tolerance)."""
    from kiss_icp_tpu_torch import odometry
    from kiss_icp_tpu_torch.parallel import sharded_map as psm

    cfg = _sharded_config(4)
    cfg.engine.map_storage = storage
    icp = odometry.create_odometry(cfg, device=cuda)
    for f in _sharded_scans(2):
        icp.register_frame(f)
    d, mcfg = 4, psm.local_map_config(cfg, icp.mesh)
    rows = psm.shard_rows(icp.state, d)
    res = icp.last_result
    src = se3.transform(icp.state.pose, res.source_points)
    s = src.shape[0]
    expanded = src.expand(d, s, 3)
    valid = res.source_valid.expand(d, s)
    active = torch.ones(d, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        nn27.query_nearest_batched(mcfg, rows, expanded, valid.contiguous(), active)
    q, v = expanded.contiguous(), valid.contiguous()
    shard_maps = [hm.VoxelMap(*(t[i] for t in rows[:4]), None, None, None) for i in range(d)]
    got = _assert_nn_rows(mcfg, rows, shard_maps, q, v, active)
    assert all(int(got.found[i].sum()) > 0 for i in range(d))
    stripe = (torch.arange(s, device=cuda) % d)[None, :] == torch.arange(d, device=cuda)[:, None]
    corr = got.found & (got.distances < 3.0 * res.sigma) & stripe
    center = icp.state.pose[:3, 3].expand(d, 3).contiguous()
    scale = res.sigma.expand(d).contiguous()
    before = linsys.build_linear_system.launches
    sys_ = linsys.build_linear_systems(q, got.neighbors, corr, scale, center, active)
    torch.cuda.synchronize()
    assert linsys.build_linear_system.launches == before + 1
    plain = linsys.plain_linsys_batched(q, got.neighbors, corr, scale, center, active)
    for i in range(d):
        one = linsys.build_linear_system(q[i], got.neighbors[i], corr[i], scale[i], center[i])
        assert torch.equal(sys_.jtj[i], one.jtj) and torch.equal(sys_.jtr[i], one.jtr)
        torch.testing.assert_close(sys_.jtj[i], plain[0][i], rtol=2e-5, atol=1e-3)
        assert int(sys_.num_correspondences[i]) == int(plain[2][i])


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_drive_on_card_matches_cpu_and_launches_once_per_iteration(cuda, shards):
    """3 frames through `create_odometry` with map_shards = D on the card
    and on the CPU: equal iterations, poses within 1e-5 m; on the card K1
    and K2 launch once per GN iteration for all D shards, K2 once more for
    each frame's final count (none on the first frame: empty map)."""
    from kiss_icp_tpu_torch import odometry
    from kiss_icp_tpu_torch.parallel.sharded_engine import ShardedKissICP

    runs = {}
    for dev in ("cuda", "cpu"):
        icp = odometry.create_odometry(_sharded_config(shards), device=dev)
        assert isinstance(icp, ShardedKissICP)
        k1, k2 = linsys.build_linear_system.launches, nn27.query_nearest.launches
        out = []
        for f in _sharded_scans():
            icp.register_frame(f)
            out.append((icp.last_pose, int(icp.last_result.num_iterations)))
        runs[dev] = out, (linsys.build_linear_system.launches - k1,
                          nn27.query_nearest.launches - k2)
    (gpu, (c1, c2)), (cpu, _) = runs["cuda"], runs["cpu"]
    for (pg, ig), (pc, ic) in zip(gpu, cpu):
        np.testing.assert_allclose(pg, pc, atol=1e-5)
        assert ig == ic
    iters = sum(i for _, i in gpu)
    assert iters > 0 and (c1, c2) == (iters, iters + len(gpu) - 1)


def test_bench_chunked_child_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The port's bench (tools/bench.py) headline child at a small config
    (16 x 128 beams, 4096 points, 2^14 slots, 4 frames) on the card and on
    the CPU: equal iterations, poses within 1e-4 m; on the card one round
    launches K1 once per GN iteration and K2 once more a frame but the
    first (empty map)."""
    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
    from kiss_icp_tpu_torch.tools import bench

    make = bench._config

    def small(*args, **kwargs):
        cfg = make(*args, **kwargs)
        cfg.engine.max_points_per_frame = cfg.engine.frame_capacity = 4096
        cfg.engine.source_capacity = 1024
        cfg.engine.map_capacity_log2 = 14
        return cfg

    def render(n, cap):  # in-process: worker processes would not see these patches
        gt = SyntheticDataset(n_scans=n, **bench.DRIVE).gt_poses[:n]
        return (gt, *bench._render_block(bench.DRIVE, n, range(n), cap))

    monkeypatch.setenv("KISS_BENCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(bench, "_render", render)
    monkeypatch.setattr(bench, "_config", small)
    monkeypatch.setattr(bench, "DRIVE", dict(bench.DRIVE, n_beams=16, n_azimuth=128))
    monkeypatch.setattr(bench, "N_FRAMES", 4)
    monkeypatch.setattr(bench, "CHUNKED_ROUNDS", bench.MIN_ROUNDS)
    seen = {}
    out = {dev: bench.child_chunked(dev, observe=lambda mode, dev=dev, **a: seen.update({dev: a}))
           for dev in ("cuda", "cpu")}
    np.testing.assert_allclose(seen["cuda"]["poses"], seen["cpu"]["poses"], atol=1e-4)
    np.testing.assert_array_equal(seen["cuda"]["iterations"], seen["cpu"]["iterations"])
    iters = out["cuda"]["gn_iterations"]
    assert iters > 0 and out["cuda"]["launches"] == {"k1": iters, "k2": iters + 3}
    assert out["cuda"]["dropped"] == 0 and out["cpu"]["launches"] == {"k1": 0, "k2": 0}


def _span_stack(monkeypatch):
    """The names of the port's spans open at each moment (the innermost
    last), kept beside the profiler's own record of them."""
    import contextlib

    from kiss_icp_tpu_torch import trace

    stack = []
    real_span = trace.span

    @contextlib.contextmanager
    def span(name):
        with real_span(name):
            stack.append(name)
            try:
                yield
            finally:
                stack.pop()

    def read(site, fn, *args):
        with span(f"kiss/sync/{site}"):
            return fn(*args)

    monkeypatch.setattr(trace, "span", span)
    monkeypatch.setattr(trace, "read", read)
    return stack


def test_every_sync_and_launch_on_card_inside_a_span(cuda, monkeypatch):
    """One chunk (KissICP: build_chunk -> dispatch_chunk -> summary_poses)
    and one 2-row lockstep step (BatchedOdometry.register_frames), after a
    warm-up, under torch.cuda.set_sync_debug_mode("warn") and torch.profiler:
    every sync warning is raised with a `kiss/sync/*` span innermost, one a
    sync span, except the batch's copies of pageable host arrays, which
    block the host themselves inside `kiss/h2d` (the chunk's pinned copy
    does not block); every CUDA kernel launch falls inside a `kiss/` span."""
    import warnings

    from kiss_icp_tpu_torch.odometry import KissICP
    from kiss_icp_tpu_torch.parallel.batch import BatchedOdometry

    scans = _drive_scans(6)
    icp = KissICP(_drive_config(trigger=0), device="cuda")
    odo = BatchedOdometry(_drive_config(trigger=0), 2, device="cuda")

    def chunk(part):
        packed, dropped = icp.build_chunk([s[0] for s in part], [s[1] for s in part])
        icp.summary_poses(icp.dispatch_chunk(packed, dropped))

    def step(i):
        odo.register_frames([scans[i][0], scans[i + 1][0]], [scans[i][1], scans[i + 1][1]])

    chunk(scans[:3])
    step(0)
    stack = _span_stack(monkeypatch)
    syncs = []
    phase = "start"

    def hook(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" in str(message):
            syncs.append((phase, stack[-1] if stack else None))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                phase = "chunk"
                chunk(scans[3:6])
                phase = "batch"
                step(2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()

    host = [e for e in prof.events() if e.device_type != torch.autograd.DeviceType.CUDA]
    spans = [e for e in host if e.name.startswith("kiss/")]
    sync_spans = [e for e in spans if e.name.startswith("kiss/sync/")]
    in_sync = [s for s in syncs if s[1] is not None and s[1].startswith("kiss/sync/")]
    rest = [s for s in syncs if s not in in_sync]
    assert len(in_sync) == len(sync_spans) > 0, (len(sync_spans), syncs)
    assert all(s == ("batch", "kiss/h2d") for s in rest), rest
    launches = [e for e in host if "LaunchKernel" in e.name]
    outside = [e.name for e in launches
               if not any(s.time_range.start <= e.time_range.start
                          and e.time_range.end <= s.time_range.end for s in spans)]
    assert launches and not outside, (len(launches), outside[:10])


# --- The Gauss-Newton loop on CUDA graphs (ops/control.py) -------------------


def _graph_drive(monkeypatch, run, graphs):
    """`run()` (a drive: returns its poses and iterations) with each GN loop
    trip on a CUDA graph (`graphs`) or on the Python loop, counting K1/K2
    launches, GN loop trips and iterations run (tests/torch_gn_count.py),
    captures and replays."""
    import torch_gn_count

    from kiss_icp_tpu_torch.ops import control

    control.clear_graphs()
    events = {"capture": 0, "replay": 0}
    real_capture, real_replay = control.TripGraph.capture, control.TripGraph.replay

    def capture(self, *args):
        events["capture"] += 1
        return real_capture(self, *args)

    def replay(self):
        events["replay"] += 1
        return real_replay(self)

    with monkeypatch.context() as mp:
        mp.setattr(control.TripGraph, "capture", capture)
        mp.setattr(control.TripGraph, "replay", replay)
        if not graphs:
            mp.setattr(control, "uses_graph", lambda carry, key: False)
        k1, k2 = linsys.build_linear_system.launches, nn27.query_nearest.launches
        with torch_gn_count.counting() as rec:
            out = run()
        torch.cuda.synchronize()
        launches = (linsys.build_linear_system.launches - k1,
                    nn27.query_nearest.launches - k2)
    control.clear_graphs()
    return out, launches, (rec.total("trips"), rec.total("evals")), events


def _assert_graph_drive(monkeypatch, run, new_tables=1):
    """The drive on graphs gives the Python loop's poses and iterations bit
    for bit and its K1/K2 launches; it captures once for each set of map
    tables (`new_tables`) and replays every other trip."""
    (poses, iters), launches, (trips, evals), ev = _graph_drive(monkeypatch, run, True)
    (ref_poses, ref_iters), ref_launches, ref_counts, ref_ev = _graph_drive(
        monkeypatch, run, False)
    for a, b in zip(poses, ref_poses):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert iters == ref_iters and launches == ref_launches and (trips, evals) == ref_counts
    assert ref_ev == {"capture": 0, "replay": 0}
    assert ev == {"capture": new_tables, "replay": trips - new_tables}
    assert trips > 2 * new_tables
    return iters, launches


@pytest.mark.parametrize("unroll", [1, 2])
def test_single_loop_on_graphs_bit_identical_to_python_loop(cuda, monkeypatch, unroll):
    """13 frames through KissICP, a fresh state for 3 more while the first
    is kept (its tables lie elsewhere: a new capture), then a re-base of
    the second (new tables: a new capture) and 3 frames after it."""
    from kiss_icp_tpu_torch.odometry import KissICP

    scans = _drive_scans(16)
    cfg = _drive_config(trigger=0)
    cfg.engine.gn_unroll = unroll

    def run():
        first, second = KissICP(cfg, device="cuda"), KissICP(cfg, device="cuda")
        poses, iters = [], []
        for icp, part in ((first, scans[:13]), (second, scans[:3])):
            for f, t in part:
                icp.register_frame(f, t)
                poses.append(icp.last_pose)
                iters.append(int(icp.last_result.num_iterations))
        second._apply_rebase(np.array([2, -1, 0], np.int32))
        for f, t in scans[3:6]:
            second.register_frame(f, t)
            poses.append(second.last_pose)
            iters.append(int(second.last_result.num_iterations))
        return poses, iters

    iters, (k1, k2) = _assert_graph_drive(monkeypatch, run, new_tables=3)
    if unroll == 1:
        # Two frames on an empty map: no loop, no launch.
        assert (k1, k2) == (sum(iters), sum(iters) + len(iters) - 2)


def test_lockstep_loop_on_graphs_bit_identical_to_python_loop(cuda, monkeypatch):
    """Four rows at distinct velocities (their solves end at different
    trips) through the batched step for 12 frames."""
    from kiss_icp_tpu_torch.parallel import batch as pbatch

    cfg = KISSConfig()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 4096
    cfg.engine.frame_capacity = 4096
    cfg.engine.source_capacity = 1024
    cfg.engine.map_capacity_log2 = 15
    b, k = 4, 12
    rng = np.random.default_rng(2)
    base = rng.uniform(-30, 30, (b, 4096, 3)).astype(np.float32)
    vel = np.arange(1, b + 1)[:, None, None].astype(np.float32) * np.float32([0.15, 0.02, 0.0])
    pts = np.stack([base + vel * i for i in range(k)])
    ts, valid = np.zeros((k, b, 4096), np.float32), np.ones((k, b, 4096), bool)

    def run():
        step = pbatch.make_batched_step(cfg, pbatch.make_mesh(device="cuda"))
        state = pbatch.init_batched_state(cfg, b, "cuda")
        poses, iters = [], []
        for i in range(k):
            state, res = step(state, pts[i], ts[i], valid[i])
            poses.append(res.pose.clone())
            iters.append(res.num_iterations.cpu().tolist())
        return poses, iters

    iters, (k1, k2) = _assert_graph_drive(monkeypatch, run)
    assert any(len(set(row)) > 1 for row in iters[1:])  # rows part within a frame
    lockstep = sum(max(row) for row in iters)
    assert (k1, k2) == (lockstep, lockstep + k - 1)


def test_map_shard_loop_on_graphs_bit_identical_to_python_loop(cuda, monkeypatch):
    """map_shards = 2 on one process for 12 frames: each trip of the
    sharded step's loop replays a graph."""
    from kiss_icp_tpu_torch import odometry

    scans = _sharded_scans(k=12)

    def run():
        icp = odometry.create_odometry(_sharded_config(2), device="cuda")
        poses, iters = [], []
        for f in scans:
            icp.register_frame(f)
            poses.append(icp.last_pose)
            iters.append(int(icp.last_result.num_iterations))
        return poses, iters

    iters, (k1, k2) = _assert_graph_drive(monkeypatch, run)
    assert (k1, k2) == (sum(iters), sum(iters) + len(iters) - 1)
