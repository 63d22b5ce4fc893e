"""The step's operators and loops under `torch.export` (kiss_icp_tpu_torch).

K1 and K2 are the registered operators `kiss_icp_torch::linsys` and
`kiss_icp_torch::nn27` (`torch.library.opcheck` on CPU inputs, n = 0 and a
u16 map included). Each loop and branch of the step written on
ops/control.py gives the same carry, bit for bit, run live (a Python loop)
and through `torch.export` of a small wrapper (a `torch.while_loop` /
`torch.cond`): the GN loop and the empty-map branch, the cached loop with
forced re-gathers, and the compact view's claim rounds; so do the insert's
claim rounds (`probe_length` plain rounds) on contested slots and a full
window, and the whole insert. A live drive never enters
dynamo, so the live path never pays `torch.compile` for them.
"""

import numpy as np
import pytest
import torch

from kiss_icp_tpu_torch import odometry
from kiss_icp_tpu_torch.config.schema import KISSConfig
from kiss_icp_tpu_torch.kernels import linsys, nn27
from kiss_icp_tpu_torch.ops import compact_map as cm
from kiss_icp_tpu_torch.ops import hash_map as hm
from kiss_icp_tpu_torch.ops import registration

torch.set_num_threads(1)


class _Wrap(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _exported(fn, *args):
    """`fn` exported on `args` and loaded back as a callable module."""
    return torch.export.export(_Wrap(fn), args).module()


def _assert_same(got, want):
    got, want = torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _map(storage="f32", n=3000, seed=3, spread=20.0, capacity_log2=13):
    cfg = hm.MapConfig(voxel_size=1.0, max_distance=100.0, max_points_per_voxel=8,
                       capacity_log2=capacity_log2, probe_length=16,
                       group_capacity=16, storage=storage)
    pts = np.random.default_rng(seed).uniform(-spread, spread, (n, 3)).astype(np.float32)
    m, _ = hm.insert(cfg, hm.create_map(cfg), torch.from_numpy(pts),
                     torch.ones(n, dtype=torch.bool))
    return cfg, m


def _source(n=1024, seed=5):
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.uniform(-15, 15, (n, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    guess = torch.eye(4)
    guess[:3, 3] = torch.tensor([0.6, -0.4, 0.1])
    return src, valid, guess


@pytest.mark.parametrize("n", [300, 0])
def test_linsys_operator_opcheck(n):
    rng = np.random.default_rng(n)
    src = torch.from_numpy(rng.uniform(-50, 50, (n, 3)).astype(np.float32))
    tgt = src + torch.from_numpy(rng.normal(0, 0.3, (n, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) > 0.3)
    args = (src, tgt, mask, torch.tensor(0.7), torch.tensor([3.0, -2.0, 1.0]))
    torch.library.opcheck(torch.ops.kiss_icp_torch.linsys.default, args)
    got = linsys.build_linear_system(*args)
    want = registration.build_linear_system(*args)
    _assert_same(got, want)


@pytest.mark.parametrize("storage,n", [("f32", 500), ("u16", 500), ("f32", 0)])
def test_nn27_operator_opcheck(storage, n):
    cfg, m = _map(storage, n=1500, capacity_log2=12)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.uniform(-20, 20, (n, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    args = (q, valid, m.vkeys, m.fprints, m.counts, m.points, float(cfg.voxel_size),
            int(cfg.probe_length))
    torch.library.opcheck(torch.ops.kiss_icp_torch.nn27.default, args)
    _assert_same(nn27.query_nearest(cfg, m, q, valid), hm.query_nearest(cfg, m, q, valid))


@pytest.mark.parametrize("nn_mode", ["gather27", "compact"])
def test_align_loop_and_empty_branch_export_like_eager(nn_mode):
    """One exported registration runs both branches of the empty-map
    `cond` and the GN `while_loop`, as the live path does."""
    cfg, m = _map()
    src, valid, guess = _source()

    def align(m, src, valid, guess):
        return tuple(registration.align_points_to_map(
            cfg, m, src, valid, guess, torch.tensor(3.0), torch.tensor(1.0),
            max_iterations=60, convergence=1e-4, nn_mode=nn_mode,
            nn_live_capacity_log2=12))

    prog = _exported(align, m, src, valid, guess)
    empty = hm.create_map(cfg)
    for mm in (m, empty):
        want = align(mm, src, valid, guess)
        _assert_same(prog(mm, src, valid, guess), want)
    assert int(align(m, src, valid, guess)[1]) > 1
    assert int(align(empty, src, valid, guess)[1]) == 0


def test_cached_loop_with_regathers_exports_like_eager():
    cfg, m = _map()
    src, valid, guess = _source()

    def loop(m, src, valid, guess):
        return registration.gauss_newton_loop_cached(
            src, valid, guess, torch.tensor(3.0), torch.tensor(1.0),
            gather_fn=lambda s: hm.query_topc(cfg, m, s, 8),
            refresh_dist=0.05, max_iterations=60, convergence=1e-4,
            linsys_fn=linsys.build_linear_system)

    want = loop(m, src, valid, guess)
    assert int(want[1]) > 1 and int(want[2]) > 1  # re-gathers taken
    _assert_same(_exported(loop, m, src, valid, guess)(m, src, valid, guess), want)


def test_insert_claim_rounds_export_like_eager():
    """Contested slots (many new voxels in few windows) and full windows:
    a 2^6-slot map with 4-slot windows takes 300 new voxels."""
    cfg = hm.MapConfig(voxel_size=1.0, max_distance=100.0, max_points_per_voxel=2,
                       capacity_log2=6, probe_length=4)
    coords = torch.from_numpy(
        np.random.default_rng(2).integers(-40, 40, (300, 3)).astype(np.int32))
    coords = torch.unique(coords, dim=0)
    fp = hm.fingerprint(coords)
    rows = hm.window_row(coords, cfg.capacity_log2, cfg.probe_length)
    m = hm.create_map(cfg)
    pending = torch.ones(coords.shape[0], dtype=torch.bool)

    def claim(fprints, vkeys, coords, fp, rows, pending):
        return hm._claim_slots(fprints, vkeys, coords, fp, rows, pending,
                               probe_length=cfg.probe_length, capacity=cfg.capacity)

    args = (m.fprints, m.vkeys, coords, fp, rows, pending)
    want = claim(*args)
    assigned = want[0]
    assert int((assigned >= 0).sum()) == cfg.capacity  # every slot taken
    assert int((assigned < 0).sum()) > 0  # rows left over: full windows
    _assert_same(_exported(claim, *args)(*args), want)
    assert torch.equal(m.fprints, torch.zeros_like(m.fprints))  # inputs unwritten


def test_insert_exports_like_eager():
    """The whole insert (claim rounds, then every row written back in
    place) on a map that already holds voxels."""
    cfg, m = _map(capacity_log2=12)
    pts = torch.from_numpy(
        np.random.default_rng(9).uniform(-25, 25, (2000, 3)).astype(np.float32))
    valid = torch.ones(2000, dtype=torch.bool)

    def insert(m, pts, valid):
        m = odometry.copy_map(m)
        return hm.insert(cfg, m, pts, valid)

    want = insert(m, pts, valid)
    assert int(want[1].num_added_points) > 0
    _assert_same(_exported(insert, m, pts, valid)(m, pts, valid), want)


def test_compact_claim_rounds_export_like_eager():
    """The view's claim rounds with a full index window (twelve voxels
    hashed to window 0 of an 8-slot-window index) and a view too small for
    the map (rows past the live capacity)."""
    ccfg = cm.CompactConfig(live_capacity_log2=4, hash_capacity_log2=6, probe_length=8)
    cand = torch.stack([torch.arange(4000, dtype=torch.int32),
                        torch.zeros(4000, dtype=torch.int32),
                        torch.zeros(4000, dtype=torch.int32)], dim=1)
    keys = cand[cm._hash_rows(cand, ccfg) == 0][:20]
    cfg = hm.MapConfig(voxel_size=1.0, max_distance=1e5, max_points_per_voxel=2,
                       capacity_log2=10)
    m = hm.create_map(cfg)
    slots = torch.arange(0, 20 * 16, 16)
    m.vkeys[slots] = keys
    m.counts[slots] = 1
    m.points[slots, 0] = keys.float()

    def build(m):
        return tuple(cm.build_compact(cfg, ccfg, m))

    want = build(m)
    assert int(want[5]) == 16 and int(want[6]) == 4  # 16 rows, 4 past them
    assert int((want[3] != 0).sum()) == 8  # the full window
    _assert_same(_exported(build, m)(m), want)


def test_live_drive_never_enters_dynamo(monkeypatch):
    """Three frames through KissICP on the CPU: the loops run as Python
    loops (no torch.while_loop / torch.cond, which would compile)."""
    from torch._dynamo.utils import counters

    def refuse(*args, **kwargs):
        raise AssertionError("the live path called torch.compile")

    monkeypatch.setattr(torch, "compile", refuse)
    cfg = KISSConfig()
    cfg.data.max_range = 50.0
    cfg.data.min_range = 1.0
    cfg.mapping.voxel_size = 0.5
    cfg.engine.max_points_per_frame = 1024
    cfg.engine.frame_capacity = 1024
    cfg.engine.source_capacity = 256
    cfg.engine.map_capacity_log2 = 13
    cfg.engine.nn_mode = "cached"
    frames_before = dict(counters["frames"])
    icp = odometry.KissICP(cfg, device="cpu")
    base = np.random.default_rng(7).uniform(-30, 30, (1024, 3)).astype(np.float32)
    for i in range(3):
        icp.register_frame(base + np.float32(0.3 * i))
    assert int(icp.last_result.num_iterations) > 0
    assert dict(counters["frames"]) == frames_before
