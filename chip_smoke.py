#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kiss_icp_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each (a failed check raises; the script then exits
non-zero without printing the final result line):
  1. card      device name, and name + power limit from nvidia-smi
  2. build     nvcc builds every csrc/*.cu kernel from the checkout
  3. k1        normal-equation kernel vs its plain PyTorch version on the card
               (n = 0, 1, 100, 5000, 8192, 8193, 100 000, all-masked, unaligned)
  4. k2        27-voxel NN kernel vs its plain version on 2^19-slot maps
               (f32/u16, P = 20/5, 100 000 queries, NaN queries, hand-made
               tie, fingerprint-collision and NaN-point maps, unaligned
               fingerprint table)
  5. drive     12 frames of the synthetic 64x1024 LiDAR through
               KissICP.register_frame (the verify drive's config and gates),
               plus a small 3-frame drive on the card vs the CPU
  6. probes    empty / all-NaN / out-of-range scans, then a normal scan
  7. times     each kernel and its plain version at the main path's shapes,
               beside a launch floor (a one-element add_ timed the same way)
  8. rebase    hash_map.rebase of the drive's 2^19-slot map (f32, and a u16
               twin) and of an over-full small map, on the card and on the
               CPU: tables bit-equal, drop counts equal
  9. cli       `python -m kiss_icp_tpu_torch.tools.cmd` over 100 full-width
               synthetic scans, twice, in subprocesses: run A (default
               rebase trigger) against the JAX golden
               (kiss_icp_tpu_torch/tools/golden_cli_drive.json), run B with
               the origin rolled every 16 voxels against run A
 10. resume    drive, save_checkpoint, load into a fresh KissICP, one more
               frame on both: bit-identical (f32 and u16 maps)
Then one JSON line of per-kernel numbers, and the result line
{"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package. Exits non-zero when no CUDA
device is available or when run outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the f32
# and f64 rates outside the tensor cores, for the per-kernel lower bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12
# K1 operations per masked correspondence, as csrc/linsys.cu does them. f32:
# residual (3), |r|^2 (5), k + |r|^2, d^2 and the division (3), lever arms
# (3), w*l (3). f64: the 22 sums (22), their products (18), the 6 cross
# differences (6).
K1_F32_FLOPS_PER_POINT = 17
K1_F64_FLOPS_PER_POINT = 46
# K2 float operations per candidate point: 3 sub, 3 mul, 2 add (and 6 more
# to decode a u16 point).
K2_FLOPS_PER_CANDIDATE = 8

N_FRAMES = 12
# test_rebase.py:170-171: a forced re-base moves world poses by f32
# re-expression noise only.
REBASE_ATOL_T, REBASE_ATOL_R = 5e-3, 1e-3
# The cli phase's run A: frames 1-12 within 1e-3 m of the JAX golden.
CLI_FRAME_TOL = 1e-3

# The cli phase's subprocess: `tools.cmd.main(argv)`, which `python -m
# kiss_icp_tpu_torch.tools.cmd` runs, wrapped only to read what the run
# leaves in memory: the kernels' launch counters (0 when the process
# starts), each chunk's GN iterations, the frames done at each origin roll,
# the engine's own time (dispatch_chunk and the poses' read, without the
# loading of scans in between) and the pipeline's totals.
CLI_DRIVER = r"""
import json, sys, time
from kiss_icp_tpu_torch import odometry, pipeline
from kiss_icp_tpu_torch.kernels import linsys, nn27
from kiss_icp_tpu_torch.tools import cmd

seen = {"pipes": [], "iters": [], "rolls": [], "engine_s": 0.0}
K, P = odometry.KissICP, pipeline.OdometryPipeline
init, dispatch, read, rebase = P.__init__, K.dispatch_chunk, K.summary_poses, K.maybe_rebase

def p_init(self, *a, **k):
    init(self, *a, **k)
    seen["pipes"].append(self)

def k_dispatch(self, *a, **k):
    t0 = time.perf_counter()
    s = dispatch(self, *a, **k)
    seen["engine_s"] += time.perf_counter() - t0
    seen["iters"].append(s.num_iterations)
    return s

def k_read(self, s):
    t0 = time.perf_counter()
    out = read(self, s)
    seen["engine_s"] += time.perf_counter() - t0
    return out

def k_rebase(self, *a, **k):
    rolled = rebase(self, *a, **k)
    if rolled:
        seen["rolls"].append(sum(len(i) for i in seen["iters"]))
    return rolled

P.__init__, K.dispatch_chunk, K.summary_poses, K.maybe_rebase = p_init, k_dispatch, k_read, k_rebase
linsys.build_linear_system.launches = 0
nn27.query_nearest.launches = 0
rc = cmd.main(sys.argv[1:])
p = seen["pipes"][0]
iters = [int(x) for s in seen["iters"] for x in s.cpu().tolist()]
print("cli-run " + json.dumps({
    "rc": rc, "launches": {"k1": linsys.build_linear_system.launches,
                           "k2": nn27.query_nearest.launches},
    "iterations": iters, "rolls": seen["rolls"],
    "engine_ms_per_frame": seen["engine_s"] * 1e3 / len(iters),
    "results": p.results.as_dict(), "results_dir": str(p.results_dir),
    "sequence": str(p.dataset_sequence), "chunk": p._effective_chunk,
    "device": str(p.odometry.device), "origin": p.odometry.origin.tolist(),
    "drops": {"downsample": p.total_dropped_downsample, "map": p.total_dropped_map_voxels,
              "input": p.total_dropped_input, "oob": p.total_dropped_oob,
              "rebase": p.odometry.total_rebase_dropped}}))
sys.exit(rc)
"""


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not bool(cond):
        raise CheckFailed(msg)


def paired_times(kernel_fn, plain_fn, reps_kernel: int, reps_plain: int):
    """Kernel and plain version timed in turns (kernel, plain, plain,
    kernel); each one's best (device ms, eager ms)."""
    from kiss_icp_tpu_torch.tools.timing import time_ms

    k1 = time_ms(kernel_fn, reps_kernel)
    p1 = time_ms(plain_fn, reps_plain)
    p2 = time_ms(plain_fn, reps_plain)
    k2 = time_ms(kernel_fn, reps_kernel)
    return (min(k1[0], k2[0]), min(k1[1], k2[1])), (min(p1[0], p2[0]), min(p1[1], p2[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "kiss_icp_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository "
              "(kiss_icp_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
    from kiss_icp_tpu_torch.kernels import _build, cases, linsys, nn27
    from kiss_icp_tpu_torch.odometry import KissICP, map_config
    from kiss_icp_tpu_torch.ops import hash_map, registration, se3, voxel
    from kiss_icp_tpu_torch.tools.profile_drive import verify_drive_config
    from kiss_icp_tpu_torch.tools.timing import time_ms

    dev = torch.device("cuda")
    f32 = dict(dtype=torch.float32, device=dev)

    # 1. card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0].strip()
    print(f"card: {name}", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_build.build_dir().name}); "
          + " | ".join(_build.ptxas_report()), flush=True)

    # 3. k1 vs plain, on the card (tolerance of tests/test_pallas_kernels.py)
    def k1_case(n, seed, masked=True):
        rng = np.random.default_rng(seed)
        src = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
        tgt = (src + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
        mask = rng.random(n) > 0.3 if masked else np.zeros(n, bool)
        return (torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev),
                torch.from_numpy(mask).to(dev), torch.tensor(0.7, **f32),
                torch.tensor([3.0, -2.0, 1.0], **f32))

    def unaligned(t):
        """A contiguous copy of `t` one element past an aligned address."""
        step = t[:1].numel()
        out = torch.empty(t.numel() + step, dtype=t.dtype, device=dev)[step:].view(t.shape)
        return out.copy_(t)

    k1_err = k1_rel = 0.0
    # n = 0 and all-masked must give exact zeros; n = 1 (seed 1: masked in);
    # 8193 is one past the main path's width; 100 000 grid-strides.
    k1_sizes = ((8192, 0, True), (5000, 1, True), (100, 2, True), (8192, 3, False),
                (0, 0, True), (1, 1, True), (8193, 5, True), (100_000, 6, True))
    for n, seed, masked in k1_sizes:
        args = k1_case(n, seed, masked)
        ref = registration.build_linear_system(*args)
        got = linsys.build_linear_system(*args)
        again = linsys.build_linear_system(*args)
        torch.cuda.synchronize()
        for a, b in ((got.jtj, ref.jtj), (got.jtr, ref.jtr)):
            check(torch.allclose(a, b, rtol=2e-5, atol=1e-3),
                  f"k1 n={n}: kernel disagrees with the plain version "
                  f"(max |diff| {float((a - b).abs().max())})")
            k1_err = max(k1_err, float((a - b).abs().max()))
            k1_rel = max(k1_rel, float(((a - b).abs() / b.abs().clamp(min=1.0)).max()))
        check(int(got.num_correspondences) == int(ref.num_correspondences),
              f"k1 n={n}: count {int(got.num_correspondences)} != "
              f"{int(ref.num_correspondences)}")
        check(torch.equal(got.jtj, again.jtj) and torch.equal(got.jtr, again.jtr),
              f"k1 n={n}: two launches on the same input differ")
        if not masked or n == 0:
            check(bool(torch.all(got.jtj == 0)) and bool(torch.all(got.jtr == 0))
                  and int(got.num_correspondences) == 0,
                  f"k1 n={n} all-masked: J^T W J and J^T W r must be exactly 0, count 0")
    # Inputs off the 16 B / 4 B alignment take the scalar staging path, which
    # stages the same values: identical bits.
    args = k1_case(8193, 5, True)
    got = linsys.build_linear_system(*args)
    off = linsys.build_linear_system(*(unaligned(a) for a in args[:3]), *args[3:])
    torch.cuda.synchronize()
    check(torch.equal(got.jtj, off.jtj) and torch.equal(got.jtr, off.jtr)
          and int(got.num_correspondences) == int(off.num_correspondences),
          "k1: unaligned inputs give other bits than aligned ones")
    print(f"k1: {len(k1_sizes)} cases (n = {', '.join(str(c[0]) for c in k1_sizes)}; "
          f"one all-masked) within rtol 2e-5 / atol 1e-3 "
          f"of the plain version, counts exact, reruns bit-identical, unaligned "
          f"inputs bit-identical to aligned; "
          f"max |diff| {k1_err:.3e}, max |diff|/max(|plain|, 1) {k1_rel:.3e}",
          flush=True)

    # Scans for phases 4-7: the benchmark's synthetic drive at full width.
    t0 = time.perf_counter()
    cfg = verify_drive_config()
    ds = SyntheticDataset(sequence=0, n_scans=N_FRAMES, speed=1.0, accel_frames=30)
    scans = [ds[i] for i in range(N_FRAMES)]
    scan_s = time.perf_counter() - t0

    # 4. k2 vs plain on maps built by the port's insert on the card
    def build_map(storage, p=20):
        mcfg = hash_map.MapConfig(voxel_size=1.0, max_distance=100.0,
                                  max_points_per_voxel=p, capacity_log2=19,
                                  probe_length=16, storage=storage)
        m = hash_map.create_map(mcfg, device=dev)
        for i in range(3):
            pts = torch.from_numpy(scans[i][0].astype(np.float32)).to(dev)
            ds_ = voxel.voxel_downsample(pts, torch.ones(len(pts), dtype=torch.bool,
                                                         device=dev),
                                         voxel_size=0.5, capacity=16384)
            pose = torch.from_numpy(ds.gt_poses[i].astype(np.float32)).to(dev)
            m, _ = hash_map.insert(mcfg, m, se3.transform(pose, ds_.points), ds_.valid)
        return mcfg, m

    def k2_queries():
        pts = torch.from_numpy(scans[3][0].astype(np.float32)).to(dev)
        src = voxel.voxel_downsample(pts, torch.ones(len(pts), dtype=torch.bool,
                                                     device=dev),
                                     voxel_size=1.5, capacity=8192)
        pose = torch.from_numpy(ds.gt_poses[3].astype(np.float32)).to(dev)
        noise = torch.from_numpy(np.random.default_rng(4).normal(
            0, 0.05, (8192, 3)).astype(np.float32)).to(dev)
        q = (se3.transform(pose, src.points) + noise).contiguous()
        valid = src.valid.clone()
        valid[::10] = False  # some invalid queries
        return q, valid

    def many_queries(n):
        """n raw scan points of frames 3 and 4 in the world frame, with noise:
        more warps than the card holds at once."""
        world = [se3.transform(torch.from_numpy(ds.gt_poses[i].astype(np.float32)).to(dev),
                               torch.from_numpy(scans[i][0].astype(np.float32)).to(dev))
                 for i in (3, 4)]
        noise = torch.from_numpy(np.random.default_rng(5).normal(
            0, 0.05, (n, 3)).astype(np.float32)).to(dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[::10] = False
        return (torch.cat(world)[:n] + noise).contiguous(), valid

    k2_err = 0.0
    k2_found = {}

    def k2_hold(label, mcfg, m, q, valid):
        """The kernel against the plain version, bit for bit; the result."""
        nonlocal k2_err
        ref = hash_map.query_nearest(mcfg, m, q, valid)
        got = nn27.query_nearest(mcfg, m, q, valid)
        torch.cuda.synchronize()
        check(torch.equal(got.found, ref.found), f"k2 {label}: found differs")
        # Bits, so that NaN distances compare too.
        check(torch.equal(got.distances.view(torch.int32), ref.distances.view(torch.int32)),
              f"k2 {label}: distances not bit-equal (max |diff| "
              f"{float((got.distances - ref.distances).nan_to_num(posinf=0).abs().max())})")
        check(torch.equal(got.neighbors, ref.neighbors),
              f"k2 {label}: neighbors not bit-equal")
        fin = torch.isfinite(ref.distances)
        if bool(fin.any()):
            k2_err = max(k2_err,
                         float((got.distances[fin] - ref.distances[fin]).abs().max()),
                         float((got.neighbors - ref.neighbors).abs().max()))
        k2_found[label] = int(got.found.sum())
        return got

    queries, qvalid = k2_queries()
    maps = {}
    for storage in ("f32", "u16"):
        for p in (20, 5):  # P = 5: rows only 4 B (f32) or 2 B (u16) aligned
            maps[storage, p] = build_map(storage, p)
            k2_hold(f"{storage}/P={p}", *maps[storage, p], queries, qvalid)
            check(k2_found[f"{storage}/P={p}"] > 0,
                  f"k2 {storage}/P={p}: no query found a neighbour")
    big_q, big_valid = many_queries(100_000)
    k2_hold("f32/100000", *maps["f32", 20], big_q, big_valid)
    check(k2_found["f32/100000"] > 50_000, "k2 100 000 queries: too few found")
    # The fingerprint table 4 B past a 16 B boundary: the scalar probe path.
    mcfg, m = maps["f32", 20]
    m_off = m._replace(fprints=unaligned(m.fprints))
    k2_hold("f32/scalar-probe", mcfg, m_off, queries, qvalid)
    # NaN queries: a NaN distance wins the plain version's argmin.
    q_nan = queries.clone()
    q_nan[::7, 0] = float("nan")
    k2_hold("f32/nan-queries", mcfg, m, q_nan, qvalid)
    del maps, m_off, big_q, big_valid
    # Empty map, full size.
    mcfg_e = hash_map.MapConfig(voxel_size=1.0, capacity_log2=19, probe_length=16)
    got = nn27.query_nearest(mcfg_e, hash_map.create_map(mcfg_e, device=dev),
                             queries, qvalid)
    check(not bool(got.found.any()) and bool(torch.isinf(got.distances).all()),
          "k2 empty map: a query found a neighbour")
    # Within-voxel tie: two stored points equidistant from the query; the
    # lowest (neighbour, lane) index wins (tests/test_pallas_nn.py).
    mcfg_t = hash_map.MapConfig(voxel_size=1.0, max_distance=30.0,
                                max_points_per_voxel=4, capacity_log2=10)
    m_t, _ = hash_map.insert(
        mcfg_t, hash_map.create_map(mcfg_t, device=dev),
        torch.tensor([[0.5, 0.5, 0.25], [0.5, 0.5, 0.75]], **f32),
        torch.ones(2, dtype=torch.bool, device=dev))
    got = k2_hold("tie-within", mcfg_t, m_t, torch.tensor([[0.5, 0.5, 0.5]], **f32),
                  torch.ones(1, dtype=torch.bool, device=dev))
    check(torch.equal(got.neighbors, torch.tensor([[0.5, 0.5, 0.25]], **f32)),
          f"k2 tie within a voxel: got {got.neighbors.tolist()}")
    # Hand-made maps (kernels/cases.py): a tie across neighbour voxels (the
    # lower j wins) and a fingerprint collision (the first match decides).
    for cname, make in cases.CASES.items():
        case = make()
        got = k2_hold(cname, *cases.to_map(case, dev),
                      torch.from_numpy(case.queries).to(dev),
                      torch.from_numpy(case.valid).to(dev))
        check(np.array_equal(got.neighbors.cpu().numpy(), case.neighbors)
              and np.array_equal(got.distances.cpu().numpy(), case.distances, equal_nan=True)
              and np.array_equal(got.found.cpu().numpy(), case.found),
              f"k2 {cname}: got {got.neighbors.tolist()} {got.distances.tolist()}")
    print(f"k2: {len(k2_found)} cases bit-equal to the plain version in found, "
          f"distances and neighbours (found per case {k2_found}): 8192 queries "
          f"({int((~qvalid).sum())} invalid) on 2^19-slot maps built by insert, f32 "
          f"and u16, P = 20 and 5; 100 000 queries; an unaligned fingerprint table; "
          f"NaN queries; the within-voxel tie, the cross-voxel tie, the fingerprint "
          f"collision and a NaN stored point; empty map ok", flush=True)

    # 5. main path: KissICP.register_frame on the card, the verify gates
    icp = KissICP(cfg)
    check(icp.device.type == "cuda", "KissICP did not default to the GPU")
    linsys.build_linear_system.launches = 0
    nn27.query_nearest.launches = 0
    frame_ms, iters, drops, poses = [], [], 0, []
    for pts, stamps in scans:
        t0 = time.perf_counter()
        icp.register_frame(pts, stamps)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        res = icp.last_result
        iters.append(int(res.num_iterations))
        drops += int(res.num_dropped_downsample) + int(res.num_dropped_map_voxels)
        poses.append(icp.last_pose)
    launches = {"k1": linsys.build_linear_system.launches,
                "k2": nn27.query_nearest.launches}
    poses = np.stack(poses)
    err = np.linalg.norm(poses[:, :3, 3] - ds.gt_poses[:N_FRAMES, :3, 3], axis=1)
    check(np.all(np.isfinite(poses)), "drive: non-finite pose")
    check(err.max() < 0.7, f"drive: max translation error {err.max():.4f} m >= 0.7")
    check(max(iters) < 200, f"drive: {max(iters)} iterations >= 200")
    check(drops == 0, f"drive: {drops} voxels dropped")
    check(launches["k1"] > 0 and launches["k2"] > 0,
          f"drive: a kernel was not launched on the main path ({launches})")
    steady = frame_ms[1:]
    p50 = float(np.median(steady))
    print(f"drive: {N_FRAMES} frames x ~{int(np.mean([len(s[0]) for s in scans]))} "
          f"points (scans made in {scan_s:.1f} s): max_err={err.max():.4f} m "
          f"final_err={err[-1]:.4f} m iters={iters} drops={drops} launches={launches}; "
          f"p50 {p50:.2f} ms/frame ({1e3 / p50:.1f} frames/s) after frame 1, "
          f"frame 1 {frame_ms[0]:.1f} ms; on {smi}", flush=True)
    print("drive-poses: translations per frame (m) "
          + json.dumps([[float(f"{x:.7g}") for x in p[:3, 3]] for p in poses]), flush=True)

    # Small input: the same 3 frames on the card (kernels) and on the CPU
    # (plain versions) must agree (atol 1e-4, tests/test_pallas_kernels.py).
    small = verify_drive_config()
    small.engine.max_points_per_frame = 8192
    small.engine.frame_capacity = 8192
    small.engine.source_capacity = 2048
    small.engine.map_capacity_log2 = 15
    sds = SyntheticDataset(sequence=1, n_scans=3, n_beams=16, n_azimuth=512,
                           speed=1.0, accel_frames=6)
    runs = {}
    for d in ("cuda", "cpu"):
        eng = KissICP(small, device=d)
        runs[d] = [(eng.register_frame(*sds[i]), eng.last_pose,
                    eng.last_result.num_iterations)[1:] for i in range(3)]
    gpu_p = np.stack([r[0] for r in runs["cuda"]])
    cpu_p = np.stack([r[0] for r in runs["cpu"]])
    small_err = float(np.abs(gpu_p - cpu_p).max())
    check(small_err < 1e-4, f"small drive: card vs CPU poses differ by {small_err}")
    check([r[1] for r in runs["cuda"]] == [r[1] for r in runs["cpu"]],
          "small drive: iteration counts differ between card and CPU")
    print(f"drive-small: 3 frames (16x512 beams) card vs CPU plain path: "
          f"max |pose diff| {small_err:.3e}, iterations {[r[1] for r in runs['cuda']]}",
          flush=True)

    # 6. degradation probes
    probe = KissICP(cfg)
    cap = cfg.engine.max_points_per_frame
    probe.register_frame(*scans[0])
    probe_poses = []
    for pts in (np.zeros((0, 3)), np.full((cap, 3), np.nan),
                np.full((cap, 3), 5000.0)):
        probe.register_frame(pts)
        probe_poses.append(probe.last_pose)
    probe.register_frame(*scans[1])
    probe_poses.append(probe.last_pose)
    check(all(np.all(np.isfinite(p)) for p in probe_poses),
          "probes: a pose went non-finite")
    print("probes: empty / all-NaN / all-far / recover: all poses finite", flush=True)

    # 7. kernel times at the main path's shapes, on the drive's own data:
    # the final map, queried by the last frame's ICP source at its final
    # pose (what the drive's last GN iteration ran), and the normal
    # equations of those correspondences.
    mcfg = map_config(cfg)
    m = icp.state.map
    res = icp.last_result
    q2 = se3.transform(icp.state.pose, res.source_points).contiguous()
    v2 = res.source_valid
    k2_ms, k2_plain_ms = paired_times(
        lambda: nn27.query_nearest(mcfg, m, q2, v2),
        lambda: hash_map.query_nearest(mcfg, m, q2, v2), 100, 10)
    nn = nn27.query_nearest(mcfg, m, q2, v2)
    sigma = res.sigma
    corr = nn.found & (nn.distances < 3.0 * sigma)
    k1_args = (q2, nn.neighbors, corr, sigma, icp.state.pose[:3, 3].contiguous())
    k1_ms, k1_plain_ms = paired_times(
        lambda: linsys.build_linear_system(*k1_args),
        lambda: registration.build_linear_system(*k1_args), 200, 50)
    # Launch floor: one launch of PyTorch's one-element elementwise kernel,
    # timed the same way; no kernel of any size can take less per call.
    one = torch.zeros(1, **f32)
    floor_ms = min(time_ms(lambda: one.add_(1.0), 200)[0] for _ in range(2))

    # What the wrappers' host work is made of: one allocation, one slice and
    # one view, each timed alone on the host clock.
    def host_us(fn, reps=2000):
        for _ in range(100):
            fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    buf = torch.empty(42, **f32)
    host = {"torch.empty": host_us(lambda: torch.empty(8192, **f32)),
            "slice": host_us(lambda: buf[:36]), "view": host_us(lambda: buf.view(6, 7))}
    print("host: per op, host clock: " + ", ".join(f"{k} {v:.2f} us" for k, v in host.items())
          + f"; on {smi}", flush=True)
    n2 = q2.shape[0]
    k1_bytes = n2 * (12 + 12 + 1) + (1 + 3) * 4 + (36 + 6 + 1) * 4
    k1_flops = {"f32": K1_F32_FLOPS_PER_POINT * int(corr.sum()),
                "f64": K1_F64_FLOPS_PER_POINT * int(corr.sum())}
    # Bytes this query needs: queries + mask + outputs, each distinct probe
    # window's 16 fingerprints, each distinct present slot's key, count and
    # stored points.
    k = mcfg.probe_length
    qvox = voxel.point_to_voxel(q2, mcfg.voxel_size)
    neigh = qvox[:, None, :] + hash_map.neighbor_shifts(dev)[None]
    rows = hash_map.window_row(neigh, mcfg.capacity_log2, k)
    match = hash_map._window_fp(m.fprints, rows, k) == hash_map.fingerprint(neigh)[..., None]
    slot = (rows << (k.bit_length() - 1)) + hash_map._first_true(match)
    present = match.any(-1) & torch.all(m.vkeys[slot] == neigh, dim=-1)
    uslots = torch.unique(slot[present])
    row_cnt = m.counts[uslots].to(torch.int64)
    k2_bytes = (n2 * (12 + 1 + 12 + 4 + 1) + int(torch.unique(rows).numel()) * k * 4
                + int(uslots.numel()) * 16 + int(row_cnt.sum()) * 12)
    k2_flops = {"f32": K2_FLOPS_PER_CANDIDATE * int(m.counts[slot[present]].sum())}

    def bound(nbytes, flops):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = (flops.get("f32", 0) / F32_FLOPS_PER_S + flops.get("f64", 0) / F64_FLOPS_PER_S) * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    kernels = []
    for kname, src, replaces, nl, err_, ms, pms, nb, fl in (
            ("linsys (K1)", "kiss_icp_tpu_torch/csrc/linsys.cu",
             "kiss_icp_tpu/ops/pallas_kernels.py:31", launches["k1"], k1_err,
             k1_ms, k1_plain_ms, k1_bytes, k1_flops),
            ("nn27 (K2)", "kiss_icp_tpu_torch/csrc/nn27.cu",
             "kiss_icp_tpu/ops/pallas_nn.py:60", launches["k2"], k2_err,
             k2_ms, k2_plain_ms, k2_bytes, k2_flops)):
        b_ms, b_by = bound(nb, fl)
        # ms / plain_ms: device time per call (CUDA-graph replay); the eager
        # times add the host work of issuing the call from Python.
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": nl, "max_abs_err": err_,
                        "ms": ms[0], "plain_ms": pms[0], "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None, "floor_ms": floor_ms,
                        "eager_ms": ms[1],
                        "plain_eager_ms": pms[1], "bytes": nb, "flops": fl})
        print(f"times: {kname}: {ms[0] * 1e3:.2f} us/call on the device, "
              f"{ms[1] * 1e3:.2f} us issued eagerly (plain {pms[0] * 1e3:.2f} / "
              f"{pms[1] * 1e3:.2f} us); bound {b_ms * 1e3:.4f} us by {b_by} "
              f"({nb} B, {fl} flop by type); launch floor {floor_ms * 1e3:.2f} us; "
              f"on {smi}", flush=True)

    phase_rebase(icp, cfg, scans, ds)
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches = phase_cli(Path(tmp), smi)
        phase_resume(Path(tmp))
    for k, key in zip(kernels, ("k1", "k2")):
        k["launches_cli"] = {run: cli_launches[run][key] for run in ("A", "B")}

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _bits(t):
    """A tensor's bits on the host (u16 crosses as int16, floats compare as
    int32), so that two tables compare exactly."""
    import torch

    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def phase_rebase(icp, cfg, scans, ds) -> None:
    """8. hash_map.rebase on the card against the CPU: the drive's own 2^19
    map (f32), a u16 twin of it (the same slots, points encoded), and an
    over-full 2^10 map whose rebuild must drop voxels."""
    import torch

    from kiss_icp_tpu_torch.odometry import map_config
    from kiss_icp_tpu_torch.ops import hash_map, se3, voxel

    dev = torch.device("cuda")
    mcfg = map_config(cfg)
    m32 = icp.state.map
    mcfg16 = dataclasses.replace(mcfg, storage="u16")
    keys = m32.vkeys[:, None, :]
    m16 = m32._replace(points=hash_map.encode_points(
        mcfg16, hash_map.decode_points(mcfg, m32.points, keys), keys))
    small = dataclasses.replace(mcfg, capacity_log2=10)
    m_small = hash_map.create_map(small, device=dev)
    for i in range(3):
        pts = torch.from_numpy(scans[i][0].astype(np.float32)).to(dev)
        d = voxel.voxel_downsample(pts, torch.ones(len(pts), dtype=torch.bool, device=dev),
                                   voxel_size=0.5, capacity=16384)
        pose = torch.from_numpy(ds.gt_poses[i].astype(np.float32)).to(dev)
        m_small, _ = hash_map.insert(small, m_small, se3.transform(pose, d.points), d.valid)

    shift = torch.tensor([7, -5, 3], dtype=torch.int32)
    report = []
    for label, c, m in (("f32 2^19", mcfg, m32), ("u16 2^19", mcfg16, m16),
                        ("over-full 2^10", small, m_small)):
        m_cpu = hash_map.VoxelMap(*(t.view(torch.int16).cpu().view(torch.uint16)
                                    if t.dtype == torch.uint16 else t.cpu() for t in m))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, dropped = hash_map.rebase(c, m, shift.to(dev))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref, ref_dropped = hash_map.rebase(c, m_cpu, shift)
        check(int(dropped) == int(ref_dropped),
              f"rebase {label}: card dropped {int(dropped)} voxels, CPU {int(ref_dropped)}")
        for field, a, b in zip(hash_map.VoxelMap._fields, got, ref):
            check(torch.equal(_bits(a), _bits(b)), f"rebase {label}: {field} not bit-equal")
        live = int((m.counts > 0).sum())
        report.append(f"{label}: {live} live voxels, {int(dropped)} dropped, {ms:.1f} ms")
    check(int(ref_dropped) > 0, "rebase: the over-full map's rebuild dropped nothing")
    print("rebase: shift (7, -5, 3), card bit-equal to the CPU in vkeys, fprints, counts, "
          "points, total_points and the drop counters; " + "; ".join(report)
          + " (host clock, one call each)", flush=True)


def _cli_run(tmp: Path, label: str, config: dict, frames: int, extra=()):
    """One CLI run in a subprocess on the card; its `cli-run` record."""
    cfg_file = tmp / f"{label}.yml"
    cfg_file.write_text(json.dumps(config))  # JSON is YAML
    out = subprocess.run(
        [sys.executable, "-c", CLI_DRIVER, str(tmp), "--dataloader", "synthetic",
         "--sequence", "0", "--config", str(cfg_file), "--n-scans", str(frames), *extra],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    check(out.returncode == 0,
          f"cli {label}: rc {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("cli-run ")]
    check(len(lines) == 1, f"cli {label}: no cli-run record in its output")
    return json.loads(lines[0][len("cli-run "):])


def phase_cli(tmp: Path, smi: str) -> dict:
    """9. The CLI over the JAX golden's drive, run A (default trigger) and
    run B (origin rolled every 16 voxels, checkpoint at the end). Returns
    each run's kernel launches."""
    from kiss_icp_tpu_torch.config.schema import config_to_dict
    from kiss_icp_tpu_torch.tools.profile_drive import verify_drive_config

    golden = json.loads((REPO / "kiss_icp_tpu_torch" / "tools"
                         / "golden_cli_drive.json").read_text())
    base = config_to_dict(verify_drive_config())
    check(golden["config"] == base, "cli: the golden was made with another config")
    n = golden["frames"]
    runs, poses = {}, {}
    for label, trigger, extra in (("A", base["engine"]["rebase_trigger_voxels"], ()),
                                  ("B", 16, ("--save-checkpoint",))):
        config = json.loads(json.dumps(base))
        config["out_dir"] = str(tmp / label)
        config["engine"]["rebase_trigger_voxels"] = trigger
        run = runs[label] = _cli_run(tmp, label, config, n, extra)
        out = Path(run["results_dir"])
        seq = run["sequence"]
        for f in (f"{seq}_poses.npy", f"{seq}_kitti.txt", f"{seq}_tum.txt", f"{seq}_gt.npy",
                  f"{seq}_gt_kitti.txt", f"{seq}_gt_tum.txt", "config.yml",
                  "result_metrics.log"):
            check((out / f).is_file(), f"cli {label}: {f} was not written")
        check((tmp / label / "latest").resolve() == out.resolve(),
              f"cli {label}: `latest` does not point at the run")
        check(run["chunk"] == 16 and run["device"].startswith("cuda"),
              f"cli {label}: chunk {run['chunk']} on {run['device']}")
        check(not any(run["drops"].values()), f"cli {label}: drops {run['drops']}")
        check(run["launches"]["k1"] > 0 and run["launches"]["k2"] > 0,
              f"cli {label}: a kernel was not launched ({run['launches']})")
        poses[label] = np.load(out / f"{seq}_poses.npy")
        check(poses[label].shape == (n, 4, 4) and np.all(np.isfinite(poses[label])),
              f"cli {label}: poses {poses[label].shape}")

    a, b = runs["A"], runs["B"]
    gold = np.asarray(golden["poses"]).reshape(n, 3, 4)
    diff = np.linalg.norm(poses["A"][:, :3, 3] - gold[:, :, 3], axis=1)
    check(np.all(diff[:12] <= CLI_FRAME_TOL),
          f"cli A: frames 1-12 depart from the JAX golden by {diff[:12].max():.3e} m "
          f"> {CLI_FRAME_TOL:.0e}")
    ate = a["results"]["Absolute Trajectory Error (ATE)"]
    check(abs(ate - golden["ate_jax"]) <= golden["ate_margin"],
          f"cli A: ATE {ate:.4f} m, JAX {golden['ate_jax']:.4f} +- {golden['ate_margin']:.4f}")
    it, jit = sum(a["iterations"]), sum(golden["iterations"])
    check(abs(it - jit) <= 0.05 * jit, f"cli A: {it} GN iterations, JAX {jit}")
    check(not a["rolls"], f"cli A: the default trigger rolled the origin at {a['rolls']}")

    check(len(b["rolls"]) >= 3, f"cli B: the origin rolled {len(b['rolls'])} times")
    with np.load(Path(b["results_dir"]) / "checkpoint.npz") as ck:
        origin = ck["extra_origin"]
    check(np.any(origin != 0) and np.array_equal(origin, b["origin"]),
          f"cli B: checkpoint origin {origin.tolist()}, run {b['origin']}")
    first = b["rolls"][0]
    check(np.array_equal(poses["B"][:first], poses["A"][:first]),
          f"cli B: poses before the first roll (frame {first}) differ from run A")
    nxt = slice(first, first + 16)
    dt = np.abs(poses["B"][nxt, :3, 3] - poses["A"][nxt, :3, 3]).max()
    dr = np.abs(poses["B"][nxt, :3, :3] - poses["A"][nxt, :3, :3]).max()
    check(dt <= REBASE_ATOL_T and dr <= REBASE_ATOL_R,
          f"cli B: the 16 frames after the first roll depart from run A by {dt:.3e} m, "
          f"{dr:.3e} in rotation")
    ate_b = b["results"]["Absolute Trajectory Error (ATE)"]
    check(abs(ate_b - ate) <= 0.02, f"cli B: ATE {ate_b:.4f} m against run A's {ate:.4f}")

    for label, run in runs.items():
        r = run["results"]
        print(f"cli {label}: {n} frames x 64x1024 beams, chunk {run['chunk']}: "
              f"Average Frequency (no warmup) {r['Average Frequency (no warmup)']:.3f} Hz, "
              f"Average Runtime {r['Average Runtime']:.3f} ms (scan loading included), "
              f"engine {run['engine_ms_per_frame']:.3f} ms/frame (dispatch and poses read "
              f"only); ATE {r['Absolute Trajectory Error (ATE)']:.6f} m; "
              f"GN iterations {sum(run['iterations'])}; origin rolls at frames "
              f"{run['rolls']}; launches {run['launches']}; on {smi}", flush=True)
    print(f"cli: A against the JAX golden: frames 1-12 within {diff[:12].max():.3e} m "
          f"(limit {CLI_FRAME_TOL:.0e}; the port's CPU run "
          f"{max(golden['port_cpu_translation_diff'][:12]):.3e}), ATE {ate:.6f} m against JAX "
          f"{golden['ate_jax']:.6f} (margin {golden['ate_margin']}), iterations {it} "
          f"against {jit}; B against A: bit-identical to frame {first}, the next 16 "
          f"within {dt:.3e} m / {dr:.3e}, ATE {ate_b:.6f} m", flush=True)
    return {label: run["launches"] for label, run in runs.items()}


def phase_resume(tmp: Path) -> None:
    """10. Resume on the card: drive, save_checkpoint, load into a fresh
    KissICP, one more frame on both: the same pose bits and origin (f32 map
    with the verify config, then a u16 map)."""
    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
    from kiss_icp_tpu_torch.odometry import KissICP
    from kiss_icp_tpu_torch.tools.profile_drive import verify_drive_config

    ds = SyntheticDataset(sequence=0, n_scans=21)
    scans = [ds[i] for i in range(21)]
    report = []
    for storage, frames, trigger in (("f32", 20, 8), ("u16", 20, 4)):
        cfg = verify_drive_config()
        cfg.engine.map_storage = storage
        cfg.engine.rebase_trigger_voxels = trigger
        a = KissICP(cfg)
        for f, t in scans[:frames]:
            a.register_frame(f, t)
        check(np.any(a.origin != 0), f"resume {storage}: the origin never rolled")
        path = tmp / f"resume_{storage}.npz"
        a.save_checkpoint(path)
        b = KissICP(cfg)
        b.load_checkpoint(path)
        a.register_frame(*scans[frames])
        b.register_frame(*scans[frames])
        check(np.array_equal(a.last_pose, b.last_pose) and np.array_equal(a.origin, b.origin),
              f"resume {storage}: frame {frames + 1} differs after the reload")
        report.append(f"{storage}: {frames} frames, origin {a.origin.tolist()}")
    print("resume: save_checkpoint, load into a fresh KissICP, one more frame: pose and "
          "origin bit-identical (" + "; ".join(report) + ")", flush=True)


if __name__ == "__main__":
    sys.exit(main())
