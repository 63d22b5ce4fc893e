"""The reference (`odobench/reference/kiss.py`) against the port on the
CPU at a small size, the work arithmetic against the port's smoke, and the
benchmark's isolation from JAX and, where required, from the port."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from odobench import work
from odobench.reference import kiss
from odobench.scans import Drive, Sensor
from odobench.tests.tiny import TINY_CONFIG

BENCH_DIR = Path(__file__).resolve().parent.parent
N_FRAMES = 10


@pytest.fixture(scope="module")
def drive():
    torch.set_num_threads(2)
    sensor = Sensor(**TINY_CONFIG["sensor"])
    return Drive(sensor, N_FRAMES, world_seed=[11, 0, 0], noise_seed=12,
                 **TINY_CONFIG["drive"]).render()


@pytest.fixture(scope="module")
def port_poses(drive):
    from kiss_icp_tpu_torch.config.schema import config_from_dict
    from kiss_icp_tpu_torch.odometry import KissICP

    icp = KissICP(config_from_dict(TINY_CONFIG["kiss"]), device="cpu")
    poses, iters = [], []
    for pts, stamps in drive:
        icp.register_frame(pts, stamps)
        poses.append(icp.last_pose)
        iters.append(int(icp.last_result.num_iterations))
    return np.array(poses), iters


def test_reference_follows_the_port(drive, port_poses):
    poses, iters = port_poses
    params = kiss.Params.from_config(TINY_CONFIG["kiss"])
    out = kiss.follow(params, drive, poses, list(range(N_FRAMES)))
    gaps = [kiss.pose_gap(params, out[k][0], poses[k]) for k in range(N_FRAMES)]
    assert gaps[0] == 0.0 and out[0][1] == 0
    assert float(np.median(gaps)) < 1e-4
    assert sum(out[k][1] == iters[k] for k in range(N_FRAMES)) >= N_FRAMES - 2


def test_the_tf32_control_departs(drive, port_poses):
    params = kiss.Params.from_config(TINY_CONFIG["kiss"])
    odo = kiss.Odometry(params, kiss.Math(precision="tf32"))
    poses = np.array([odo.step(p, s)[0].double().numpy() for p, s in drive])
    out = kiss.follow(params, drive, poses, list(range(1, N_FRAMES)))
    gaps = [kiss.pose_gap(params, out[k][0], poses[k]) for k in range(1, N_FRAMES)]
    assert float(np.median(gaps)) > 1e-3


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 3.0, float("inf")])
    np.testing.assert_array_equal(kiss.round_tf32(x).numpy(),
                                  [1.0, 1.0 + 2.0**-9, 3.0, float("inf")])


def test_map_and_work_match_the_port_and_its_smoke():
    """The reference's map holds the port's voxels and counts, and the
    semantic K1/K2 work equals chip_smoke's count less what the port's hash
    layout adds (each probe window's fingerprints)."""
    import chip_smoke
    from kiss_icp_tpu_torch.ops import hash_map, voxel

    gen = torch.Generator().manual_seed(3)
    pts = (torch.rand((3000, 3), generator=gen, dtype=torch.float64) * 12.0 - 6.0)
    queries = (torch.rand((400, 3), generator=gen, dtype=torch.float64) * 14.0 - 7.0)
    mcfg = hash_map.MapConfig(capacity_log2=13, probe_length=16)
    m = hash_map.create_map(mcfg)
    m, _ = hash_map.insert(mcfg, m, pts.float(), torch.ones(3000, dtype=torch.bool))
    params = kiss.Params(voxel_size=1.0, max_points_per_voxel=20, group_capacity=16)
    ref = kiss.VoxelMap(params, kiss.Math())
    ref.insert(pts)
    live = m.counts > 0
    port = sorted(zip(map(tuple, m.vkeys[live].tolist()), m.counts[live].tolist()))
    mine = sorted(zip(map(tuple, (((ref.keys[:, None] >> torch.tensor([42, 21, 0]))
                                   & ((1 << 21) - 1)) - (1 << 20)).tolist()),
                      ref.cnt.tolist()))
    assert port == mine

    q = queries.float().double()
    slot, present = ref._candidates(q)
    odo = kiss.Odometry(params, kiss.Math())
    odo.map = ref
    rec = odo._work(slot, present, torch.ones(len(q), dtype=torch.bool))
    nbytes, flops = work.k2_work(rec["queries"], rec["voxels"], rec["voxel_points"],
                                 rec["candidates"])
    smoke_bytes, smoke_flops = chip_smoke.k2_work(mcfg, m, queries.float())
    qvox = voxel.point_to_voxel(queries.float(), mcfg.voxel_size)
    neigh = qvox[:, None, :] + hash_map.neighbor_shifts()[None]
    windows = int(torch.unique(hash_map.window_row(neigh, mcfg.capacity_log2, 16)).numel())
    assert flops == smoke_flops
    assert nbytes == smoke_bytes - windows * 16 * 4
    assert work.k1_work(8192, 5000) == chip_smoke.k1_work(8192, 5000)
    assert work.bound(nbytes, flops)[0] * 1e3 == pytest.approx(
        chip_smoke.bound(nbytes, flops)[0])


def _imports(path: Path):
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_module_imports_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "kiss_icp_tpu"}


@pytest.mark.parametrize("path", sorted(
    [*(BENCH_DIR / "reference").glob("*.py"), BENCH_DIR / "work.py", BENCH_DIR / "scans.py"]),
    ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_yardstick_imports_nothing_of_the_port(path):
    assert "kiss_icp_tpu_torch" not in _imports(path)
