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
  6. modes     the drive again in nn_mode loop27, compact, compact_loop (each
               bit-identical to the drive, with its K1 and K2 launches),
               compact with a too-small view (drops reported, bit-identical)
               and cached (within tests/test_cached_assoc.py's bounds of
               the drive); each also on the small drive, card vs CPU
     options   the drive with deskew_refine = 1, deskew_refine_map and
               ground_align = 0.1 (the verify gates), each on the small
               drive card vs CPU; then the CLI with every option on over 6
               full-width scans, against the same drive in this process
  7. probes    empty / all-NaN / out-of-range scans, then a normal scan
  8. times     each kernel and its plain version at the main path's shapes,
               beside a launch floor (a one-element add_ timed the same way)
  9. rebase    hash_map.rebase of the drive's 2^19-slot map (f32, and a u16
               twin) and of an over-full small map, on the card and on the
               CPU: tables bit-equal, drop counts equal
 10. cli       `python -m kiss_icp_tpu_torch.tools.cmd` over 100 full-width
               synthetic scans, twice, in two subprocesses at once: run A
               (default rebase trigger) against the JAX golden
               (kiss_icp_tpu_torch/tools/golden_cli_drive.json), run B with
               the origin rolled every 16 voxels against run A
 11. resume    drive, save_checkpoint, load into a fresh KissICP, one more
               frame on both: bit-identical (f32 and u16 maps)
 12. aot       io/aot.py at the drive's full width: the per-frame artifact
               (save_step on the card, load_step) over the drive's 12 scans,
               bit-identical to the drive with its K1 and K2 launches; the
               chunked artifact (K = 2, 6 chunks) bit-identical to the live
               chunked step; with donate_state false, one step of the live
               step and of its artifact leaves the state it started from
               bit-identical
 13. loaders   the drive's 12 scans written in two loaders' on-disk layouts
               and run through the CLI on the card, in two subprocesses at
               once: helipr's Velodyne records (a float32 `t` field the
               loader normalises), against the drive's poses, and mulran's
               64 x 1024 column-major Ouster scans (stamps made by the
               loader), the verify gates; each loader returns what was
               written, no drops
 14. ros       the port's ROS 2 node (ros/odometry_server.main) under a
               minimal fake of rclpy and the message modules, its device left
               at the default: the drive's 12 scans published as PointCloud2
               records with a float32 `t` field, 12 odometry and TF messages,
               the drive's poses and launches, the shutdown checkpoint loads
 15. batch     the sequence axis (parallel/batch.py): the drive's scans as 4
               rows turned b x 90 deg about z. The batched K1 and K2 at the
               lockstep path's shapes, bit-equal to the unbatched kernels row
               by row, against their plain versions, an inactive row's empty
               answer, their times; BatchedOdometry over the 12 frames: row
               0 against the drive, each row against its own single drive
               (iterations equal, poses within 1e-5 m), the verify gates
               against each row's turned ground truth, and one K1 and one
               K2 launch per lockstep iteration (plus a final count a
               frame); the "map" chunked mode, launches summed over rows;
               ms per lockstep frame, sequence-frames/s, launches and peak
               memory at B = 1, 4, 8
 16. shards    the rest of parallel/: the drive's scans through create_odometry
               with map_shards = 2 and 4 (within 5e-4 m of the drive, the
               verify gates, one batched K1 and one batched K2 launch per GN
               iteration for all shards, the batched kernels over the shard
               rows bit-equal to the unbatched ones, balanced occupancy), a
               drive that rolls its origin every voxel and a checkpoint round
               trip, ms per frame and peak memory at D = 1, 2, 4 (one card
               holds every shard); the pod (2 sequences x 2 shards, each
               within 1e-5 m of its own map-sharded drive); the pts axis (2
               stripes against the single align); tools/scaling_bench.py at 1
               and 2 processes on this card, against one BatchedOdometry
 17. tools     tools/op_breakdown over 6 of the drive's scans on the card (its
               per-stage table, the kernels as the profiler saw them) and
               tools/capacity_plan over the drive's 12 scans
 18. bench     the port's bench (`python -m kiss_icp_tpu_torch.tools.bench`) as a
               subprocess on the card, with a 48-frame soak and a K = 2
               chunked artifact: it exits 0 with every child it spawned
               finished (none failed or cut at its timeout, every ab variant
               timed); its last line carries every headline field above 0,
               the resume and the re-base hold (the re-based trajectory is
               the straight one shifted by exactly the offset), the headline
               child has 0 drops, a max error under the verify gate, and
               K1/K2 launches equal to its GN iterations and final counts
Each mode and option is driven with the kernels' launch counters set to 0
just before it and read just after. Then one JSON line of per-kernel
numbers, and the result line
{"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package. Exits non-zero when no CUDA
device is available or when run outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
# tests/test_cached_assoc.py:76-101: nn_mode "cached" against the exact mode.
CACHED_MAX_T, CACHED_ROT_ATOL = 0.15, 6e-3
CACHED_ATE_FACTOR, CACHED_ATE_MARGIN, CACHED_ITER_FACTOR = 1.15, 0.01, 2.5
# The modes and options phases: engine settings on top of the drive's config.
MODES = {"loop27": dict(nn_mode="loop27"), "compact": dict(nn_mode="compact"),
         "compact_loop": dict(nn_mode="compact_loop"),
         "compact-overflow": dict(nn_mode="compact", nn_live_capacity_log2=10),
         "cached": dict(nn_mode="cached")}
OPTIONS = {"deskew_refine=1": dict(deskew_refine=1),
           "deskew_refine_map": dict(deskew_refine_map=True),
           "ground_align=0.1": dict(ground_align=0.1)}

# The cli phase's subprocess: `tools.cmd.main(argv)`, which `python -m
# kiss_icp_tpu_torch.tools.cmd` runs, wrapped only to read what the run
# leaves in memory: the kernels' launch counters (0 when the process
# starts), each chunk's GN iterations, the frames done at each origin roll,
# the engine's own time (dispatch_chunk and the poses' read, without the
# loading of scans in between; and each chunk's dispatch alone: the first
# holds the process's first kernel calls) and the pipeline's totals.
CLI_DRIVER = r"""
import json, sys, time
from kiss_icp_tpu_torch import odometry, pipeline
from kiss_icp_tpu_torch.kernels import linsys, nn27
from kiss_icp_tpu_torch.tools import cmd

seen = {"pipes": [], "iters": [], "rolls": [], "engine_s": 0.0, "chunk_s": []}
K, P = odometry.KissICP, pipeline.OdometryPipeline
init, dispatch, read, rebase = P.__init__, K.dispatch_chunk, K.summary_poses, K.maybe_rebase

def p_init(self, *a, **k):
    init(self, *a, **k)
    seen["pipes"].append(self)

def k_dispatch(self, *a, **k):
    t0 = time.perf_counter()
    s = dispatch(self, *a, **k)
    seen["engine_s"] += time.perf_counter() - t0
    seen["chunk_s"].append(time.perf_counter() - t0)
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
    "chunk_s": seen["chunk_s"],
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

    t_start = time.perf_counter()
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
    drive = drive_engine(icp, scans)
    launches, iters, poses, drops = drive["launches"], drive["iters"], drive["poses"], drive["drops"]
    err = np.linalg.norm(poses[:, :3, 3] - ds.gt_poses[:N_FRAMES, :3, 3], axis=1)
    check_verify_gates("drive", drive, err)
    check(launches["k1"] > 0 and launches["k2"] > 0,
          f"drive: a kernel was not launched on the main path ({launches})")
    p50 = drive["p50"]
    print(f"drive: {N_FRAMES} frames x ~{int(np.mean([len(s[0]) for s in scans]))} "
          f"points (scans made in {scan_s:.1f} s): max_err={err.max():.4f} m "
          f"final_err={err[-1]:.4f} m iters={iters} drops={drops} launches={launches}; "
          f"p50 {p50:.2f} ms/frame ({1e3 / p50:.1f} frames/s) after frame 1, "
          f"frame 1 {drive['frame_ms'][0]:.1f} ms; on {smi}", flush=True)
    print("drive-poses: translations per frame (m) "
          + json.dumps([[float(f"{x:.7g}") for x in p[:3, 3]] for p in poses]), flush=True)

    # Small input: the same 3 frames on the card (kernels) and on the CPU
    # (plain versions) must agree (atol 1e-4, tests/test_pallas_kernels.py).
    small_err, small_iters = small_drive({})
    print(f"drive-small: 3 frames (16x512 beams) card vs CPU plain path: "
          f"max |pose diff| {small_err:.3e}, iterations {small_iters}", flush=True)

    mode_launches = phase_modes(cfg, scans, ds, drive, smi)
    mode_launches.update(phase_options(cfg, scans, ds, smi))

    # 7. degradation probes
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

    # 8. kernel times at the main path's shapes, on the drive's own data:
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
    # What the operator's dispatch adds to an eager call: each kernel's CUDA
    # implementation called directly (the ctypes launch alone), issued the
    # same way.
    direct_ms = {
        "k1": min(time_ms(lambda: linsys._linsys_cuda(*k1_args), 200)[1] for _ in range(2)),
        "k2": min(time_ms(lambda: nn27._nn27_cuda(
            q2, v2, m.vkeys, m.fprints, m.counts, m.points, float(mcfg.voxel_size),
            int(mcfg.probe_length)), 100)[1] for _ in range(2))}
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
    k1_bytes, k1_flops = k1_work(q2.shape[0], int(corr.sum()))
    k2_bytes, k2_flops = k2_work(mcfg, m, q2)
    kernels = []
    for kname, src, replaces, nl, err_, ms, pms, nb, fl, dms in (
            ("linsys (K1)", "kiss_icp_tpu_torch/csrc/linsys.cu",
             "kiss_icp_tpu/ops/pallas_kernels.py:31", launches["k1"], k1_err,
             k1_ms, k1_plain_ms, k1_bytes, k1_flops, direct_ms["k1"]),
            ("nn27 (K2)", "kiss_icp_tpu_torch/csrc/nn27.cu",
             "kiss_icp_tpu/ops/pallas_nn.py:60", launches["k2"], k2_err,
             k2_ms, k2_plain_ms, k2_bytes, k2_flops, direct_ms["k2"])):
        b_ms, b_by = bound(nb, fl)
        # ms / plain_ms: device time per call (CUDA-graph replay); the eager
        # times add the host work of issuing the call from Python, through
        # the registered operator (eager_ms) or straight to its CUDA
        # implementation (eager_direct_ms).
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": nl, "max_abs_err": err_,
                        "ms": ms[0], "plain_ms": pms[0], "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None, "floor_ms": floor_ms,
                        "eager_ms": ms[1], "eager_direct_ms": dms,
                        "plain_eager_ms": pms[1], "bytes": nb, "flops": fl})
        print(f"times: {kname}: {ms[0] * 1e3:.2f} us/call on the device, "
              f"{ms[1] * 1e3:.2f} us issued eagerly through the operator, "
              f"{dms * 1e3:.2f} us straight to its CUDA implementation (plain "
              f"{pms[0] * 1e3:.2f} / "
              f"{pms[1] * 1e3:.2f} us); bound {b_ms * 1e3:.4f} us by {b_by} "
              f"({nb} B, {fl} flop by type); launch floor {floor_ms * 1e3:.2f} us; "
              f"on {smi}", flush=True)

    phase_rebase(icp, cfg, scans, ds)
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches = phase_cli(Path(tmp), smi)
        phase_resume(Path(tmp))
        mode_launches.update(phase_aot(cfg, scans, drive, Path(tmp), smi))
        t0 = time.perf_counter()
        mode_launches.update(phase_loaders(cfg, scans, ds, drive, Path(tmp), smi))
        t1 = time.perf_counter()
        mode_launches.update(phase_ros(cfg, scans, drive, Path(tmp), smi))
        t2 = time.perf_counter()
        batch_launches, batch_kernels = phase_batch(cfg, scans, ds, drive, smi)
        mode_launches.update(batch_launches)
        t3 = time.perf_counter()
        shard_launches, shard_kernels = phase_shards(cfg, scans, ds, drive, icp, Path(tmp), smi)
        mode_launches.update(shard_launches)
        t4 = time.perf_counter()
        phase_tools(cfg, scans, ds, smi)
        t5 = time.perf_counter()
        mode_launches.update(phase_bench(Path(tmp), smi))
        print(f"time: phase loaders {t1 - t0:.1f} s, phase ros {t2 - t1:.1f} s, phase batch "
              f"{t3 - t2:.1f} s, phase shards {t4 - t3:.1f} s, phase tools "
              f"{t5 - t4:.1f} s, phase bench {time.perf_counter() - t5:.1f} s, the script "
              f"{time.perf_counter() - t_start:.1f} s (host clock); on {smi}", flush=True)
    for k, key in zip(kernels, ("k1", "k2")):
        k["launches_cli"] = {run: cli_launches[run][key] for run in ("A", "B")}
        k["launches_modes"] = {name: counts[key] for name, counts in mode_launches.items()}
    kernels.extend(batch_kernels + shard_kernels)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def k1_work(n: int, n_corr: int):
    """(bytes, operations by type) K1 needs for one system of n points with
    n_corr correspondences: each input read once, each output written once."""
    return (n * (12 + 12 + 1) + (1 + 3) * 4 + (36 + 6 + 1) * 4,
            {"f32": K1_F32_FLOPS_PER_POINT * n_corr, "f64": K1_F64_FLOPS_PER_POINT * n_corr})


def k2_work(mcfg, m, q):
    """(bytes, operations) K2 needs for queries q on map m: queries + mask +
    outputs, each distinct probe window's fingerprints, each distinct
    present slot's key and count, and its stored points; 8 flops a
    candidate point."""
    import torch

    from kiss_icp_tpu_torch.ops import hash_map, voxel

    k = mcfg.probe_length
    qvox = voxel.point_to_voxel(q, mcfg.voxel_size)
    neigh = qvox[:, None, :] + hash_map.neighbor_shifts(q.device)[None]
    rows = hash_map.window_row(neigh, mcfg.capacity_log2, k)
    match = hash_map._window_fp(m.fprints, rows, k) == hash_map.fingerprint(neigh)[..., None]
    slot = (rows << (k.bit_length() - 1)) + hash_map._first_true(match)
    present = match.any(-1) & torch.all(m.vkeys[slot] == neigh, dim=-1)
    uslots = torch.unique(slot[present])
    row_cnt = m.counts[uslots].to(torch.int64)
    nbytes = (q.shape[0] * (12 + 1 + 12 + 4 + 1) + int(torch.unique(rows).numel()) * k * 4
              + int(uslots.numel()) * 16 + int(row_cnt.sum()) * 12)
    return nbytes, {"f32": K2_FLOPS_PER_CANDIDATE * int(m.counts[slot[present]].sum())}


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rates of their types."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = (flops.get("f32", 0) / F32_FLOPS_PER_S + flops.get("f64", 0) / F64_FLOPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def drive_engine(icp, scans) -> dict:
    """Drive `icp` over `scans` one frame a call (KissICP.register_frame),
    with the kernels' launch counters set to 0 just before and read just
    after: poses, iterations, drops, host ms per frame and launches."""
    from kiss_icp_tpu_torch.kernels import linsys, nn27

    linsys.build_linear_system.launches = 0
    nn27.query_nearest.launches = 0
    frame_ms, iters, poses, drops, map_drops = [], [], [], 0, 0
    for pts, stamps in scans:
        t0 = time.perf_counter()
        icp.register_frame(pts, stamps)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        res = icp.last_result
        iters.append(int(res.num_iterations))
        map_drops += int(res.num_dropped_map_voxels)
        drops += int(res.num_dropped_downsample) + int(res.num_dropped_map_voxels)
        poses.append(icp.last_pose)
    launches = {"k1": linsys.build_linear_system.launches, "k2": nn27.query_nearest.launches}
    return {"poses": np.stack(poses), "iters": iters, "drops": drops, "map_drops": map_drops,
            "frame_ms": frame_ms, "p50": float(np.median(frame_ms[1:])), "launches": launches}


def check_verify_gates(label: str, run: dict, err) -> None:
    """The verify drive's gates (.claude/skills/verify/drive.py): finite
    poses, max translation error < 0.7 m, < 200 iterations, no drops."""
    check(np.all(np.isfinite(run["poses"])), f"{label}: non-finite pose")
    check(err.max() < 0.7, f"{label}: max translation error {err.max():.4f} m >= 0.7")
    check(max(run["iters"]) < 200, f"{label}: {max(run['iters'])} iterations >= 200")
    check(run["drops"] == 0, f"{label}: {run['drops']} voxels dropped")


def engine_config(base, engine: dict):
    """A copy of `base` with the given engine settings."""
    import copy

    cfg = copy.deepcopy(base)
    for key, value in engine.items():
        setattr(cfg.engine, key, value)
    return cfg


def small_drive(engine: dict):
    """3 frames of the 16x512-beam procedural LiDAR on the card and on the
    CPU with the drive's config and `engine` on top: poses within atol 1e-4
    (tests/test_pallas_kernels.py), iterations and drops equal. Returns (max
    |pose diff|, iterations)."""
    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
    from kiss_icp_tpu_torch.odometry import KissICP
    from kiss_icp_tpu_torch.tools.profile_drive import verify_drive_config

    small = engine_config(verify_drive_config(), dict(
        max_points_per_frame=8192, frame_capacity=8192, source_capacity=2048,
        map_capacity_log2=15, **engine))
    sds = SyntheticDataset(sequence=1, n_scans=3, n_beams=16, n_azimuth=512,
                           speed=1.0, accel_frames=6)
    runs = {}
    for d in ("cuda", "cpu"):
        eng = KissICP(small, device=d)
        runs[d] = [(eng.register_frame(*sds[i]), eng.last_pose,
                    int(eng.last_result.num_iterations), eng.last_overflow())[1:]
                   for i in range(3)]
    err = float(np.abs(np.stack([r[0] for r in runs["cuda"]])
                       - np.stack([r[0] for r in runs["cpu"]])).max())
    label = "small drive" + (f" {engine}" if engine else "")
    check(err < 1e-4, f"{label}: card vs CPU poses differ by {err}")
    check([r[1:] for r in runs["cuda"]] == [r[1:] for r in runs["cpu"]],
          f"{label}: iteration or drop counts differ between card and CPU")
    return err, [r[1] for r in runs["cuda"]]


def _mode_line(label, run, extra, small, smi):
    print(f"{label}: p50 {run['p50']:.2f} ms/frame, iters {run['iters']} "
          f"(sum {sum(run['iters'])}), launches K1 {run['launches']['k1']} / K2 "
          f"{run['launches']['k2']}, drops {run['drops']} (map {run['map_drops']}); {extra}; "
          f"small drive card vs CPU {small[0]:.3e}, iterations {small[1]}; on {smi}",
          flush=True)


def phase_modes(cfg, scans, ds, drive: dict, smi: str) -> dict:
    """6. The drive in the other association modes, on the card. loop27,
    compact and compact_loop give the gather27 drive's poses, iterations and
    launches bit for bit; a compact view too small for the map reports its
    drops and gives the same bits; cached stays within
    tests/test_cached_assoc.py's bounds of the drive. Returns each mode's
    launches."""
    from kiss_icp_tpu_torch.metrics import absolute_trajectory_error
    from kiss_icp_tpu_torch.odometry import KissICP

    gt = ds.gt_poses[:N_FRAMES]
    out = {}
    for name, engine in MODES.items():
        run = drive_engine(KissICP(engine_config(cfg, engine)), scans)
        k = out[name] = run["launches"]
        err = np.linalg.norm(run["poses"][:, :3, 3] - gt[:, :3, 3], axis=1)
        check(k["k1"] > 0, f"modes {name}: K1 was not launched ({k})")
        if name == "cached":
            check_verify_gates(f"modes {name}", run, err)
            check(k["k2"] > 0, f"modes {name}: K2 was not launched ({k})")
            dev_t = np.linalg.norm(run["poses"][:, :3, 3] - drive["poses"][:, :3, 3], axis=1).max()
            dev_r = np.abs(run["poses"][:, :3, :3] - drive["poses"][:, :3, :3]).max()
            ate, _ = absolute_trajectory_error(gt, run["poses"])
            ate_exact, _ = absolute_trajectory_error(gt, drive["poses"])
            mean_it, mean_exact = np.mean(run["iters"]), max(np.mean(drive["iters"]), 1.0)
            check(dev_t < CACHED_MAX_T and dev_r <= CACHED_ROT_ATOL,
                  f"modes cached: {dev_t:.4f} m / {dev_r:.2e} from the drive")
            check(ate <= ate_exact * CACHED_ATE_FACTOR + CACHED_ATE_MARGIN,
                  f"modes cached: ATE {ate:.4f} m against the drive's {ate_exact:.4f}")
            check(mean_it < CACHED_ITER_FACTOR * mean_exact,
                  f"modes cached: {mean_it:.1f} iterations a frame against {mean_exact:.1f}")
            extra = (f"max_err {err.max():.4f} m; from the drive {dev_t:.4f} m (limit "
                     f"{CACHED_MAX_T}) / rotation {dev_r:.2e} (limit {CACHED_ROT_ATOL}); ATE "
                     f"{ate:.6f} m against {ate_exact:.6f} (limit {CACHED_ATE_FACTOR} x + "
                     f"{CACHED_ATE_MARGIN}); mean iterations {mean_it:.2f} against "
                     f"{mean_exact:.2f} (limit {CACHED_ITER_FACTOR} x)")
        else:
            check(np.array_equal(run["poses"], drive["poses"]) and run["iters"] == drive["iters"],
                  f"modes {name}: poses or iterations differ from the gather27 drive "
                  f"(max |diff| {np.abs(run['poses'] - drive['poses']).max():.3e})")
            overflow = name == "compact-overflow"
            check((run["drops"] > 0) == overflow and run["map_drops"] == run["drops"],
                  f"modes {name}: drops {run['drops']} (map {run['map_drops']})")
            # Every mode here runs the drive's query (K2) in each iteration;
            # the compact modes also build the view, for its drop count.
            check(k == drive["launches"], f"modes {name}: launches {k}, drive "
                  f"{drive['launches']}")
            extra = (f"poses and iterations bit-identical to the gather27 drive, max_err "
                     f"{err.max():.4f} m")
        _mode_line(f"modes {name}", run, extra, small_drive(engine), smi)
    return out


def phase_options(cfg, scans, ds, smi: str) -> dict:
    """6. The drive with each frame option (the verify gates), each on the
    small drive card vs CPU; then the CLI with every option on (nn_mode
    cached) over 6 full-width scans in a subprocess, against the same scans
    driven in this process. Returns each run's launches."""
    from kiss_icp_tpu_torch.config.schema import config_to_dict
    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset
    from kiss_icp_tpu_torch.odometry import KissICP

    gt = ds.gt_poses[:N_FRAMES]
    out = {}
    for name, engine in OPTIONS.items():
        run = drive_engine(KissICP(engine_config(cfg, engine)), scans)
        k = out[name] = run["launches"]
        err = np.linalg.norm(run["poses"][:, :3, 3] - gt[:, :3, 3], axis=1)
        check_verify_gates(f"options {name}", run, err)
        check(k["k1"] > 0 and k["k2"] > 0, f"options {name}: a kernel was not launched ({k})")
        _mode_line(f"options {name}", run, f"max_err {err.max():.4f} m final_err "
                   f"{err[-1]:.4f} m", small_drive(engine), smi)

    frames = 6
    every = dict(nn_mode="cached", deskew_refine=1, deskew_refine_map=True, ground_align=0.1)
    ref_cfg = engine_config(cfg, every)
    cli_ds = SyntheticDataset(sequence=0)  # what `--dataloader synthetic` loads
    ref = drive_engine(KissICP(ref_cfg), [cli_ds[i] for i in range(frames)])
    with tempfile.TemporaryDirectory() as tmp:
        config = config_to_dict(ref_cfg)
        config["out_dir"] = str(Path(tmp) / "C")
        run = _cli_runs(Path(tmp), [("C", config, frames, ())])["C"]
        seq = run["sequence"]
        poses = np.load(Path(run["results_dir"]) / f"{seq}_poses.npy")
    k = out["cli C"] = run["launches"]
    diff = float(np.abs(poses - ref["poses"]).max())
    check(run["device"].startswith("cuda") and poses.shape == (frames, 4, 4),
          f"cli C: {poses.shape} on {run['device']}")
    check(diff <= 1e-4 and run["iterations"] == ref["iters"],
          f"cli C: {diff:.3e} from the same drive in this process, iterations "
          f"{run['iterations']} against {ref['iters']}")
    check(not any(run["drops"].values()), f"cli C: drops {run['drops']}")
    check(k["k1"] > 0 and k["k2"] > 0, f"cli C: a kernel was not launched ({k})")
    print(f"options cli C: `python -m kiss_icp_tpu_torch.tools.cmd` with {every}, "
          f"{frames} frames x 64x1024 beams, chunk {run['chunk']}: within {diff:.3e} of the "
          f"same drive in this process, iterations {run['iterations']}, launches {k}, "
          f"engine {run['engine_ms_per_frame']:.3f} ms/frame (one chunk: the process's first "
          f"kernel calls included); on {smi}", flush=True)
    return out


def _bits(t):
    """A tensor's bits on the host (u16 crosses as int16, floats compare as
    int32), so that two tables compare exactly."""
    import torch

    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def phase_rebase(icp, cfg, scans, ds) -> None:
    """9. hash_map.rebase on the card against the CPU: the drive's own 2^19
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


def _cli_runs(tmp: Path, runs) -> dict:
    """CLI runs in subprocesses on the card, all started together (the
    synthetic renderer on the host sets their pace, and the host has cores
    to spare): `runs` is a list of (label, config, frames, extra flags), the
    flags after the data arguments, which are the synthetic drive's unless
    a fifth item gives others. Returns each run's `cli-run` record; a run
    that fails fails the phase, and no process outlives the call."""
    procs = {}
    try:
        for label, config, frames, extra, *data in runs:
            data = data[0] if data else (str(tmp), "--dataloader", "synthetic", "--sequence", "0")
            cfg_file = tmp / f"{label}.yml"
            cfg_file.write_text(json.dumps(config))  # JSON is YAML
            logs = (open(tmp / f"{label}.out", "w"), open(tmp / f"{label}.err", "w"))
            procs[label] = (subprocess.Popen(
                [sys.executable, "-c", CLI_DRIVER, *data, "--config", str(cfg_file),
                 "--n-scans", str(frames), *extra], cwd=REPO, stdout=logs[0],
                stderr=logs[1]), logs)
        records = {}
        for label, (proc, logs) in procs.items():
            rc = proc.wait(timeout=900)
            for f in logs:
                f.close()
            out = (tmp / f"{label}.out").read_text()
            check(rc == 0, f"cli {label}: rc {rc}\n{out[-2000:]}\n"
                  f"{(tmp / f'{label}.err').read_text()[-4000:]}")
            lines = [ln for ln in out.splitlines() if ln.startswith("cli-run ")]
            check(len(lines) == 1, f"cli {label}: no cli-run record in its output")
            records[label] = json.loads(lines[0][len("cli-run "):])
        return records
    finally:
        for proc, logs in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in logs:
                f.close()


def phase_cli(tmp: Path, smi: str) -> dict:
    """10. The CLI over the JAX golden's drive, run A (default trigger) and
    run B (origin rolled every 16 voxels, checkpoint at the end). Returns
    each run's kernel launches."""
    from kiss_icp_tpu_torch.config.schema import config_to_dict
    from kiss_icp_tpu_torch.tools.profile_drive import verify_drive_config

    golden = json.loads((REPO / "kiss_icp_tpu_torch" / "tools"
                         / "golden_cli_drive.json").read_text())
    base = config_to_dict(verify_drive_config())
    check(golden["config"] == base, "cli: the golden was made with another config")
    n = golden["frames"]
    specs = []
    for label, trigger, extra in (("A", base["engine"]["rebase_trigger_voxels"], ()),
                                  ("B", 16, ("--save-checkpoint",))):
        config = json.loads(json.dumps(base))
        config["out_dir"] = str(tmp / label)
        config["engine"]["rebase_trigger_voxels"] = trigger
        specs.append((label, config, n, extra))
    runs, poses = _cli_runs(tmp, specs), {}
    for label, run in runs.items():
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
              f"only; the first chunk's dispatch {run['chunk_s'][0]:.2f} s); ATE {r['Absolute Trajectory Error (ATE)']:.6f} m; "
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
    """11. Resume on the card: drive, save_checkpoint, load into a fresh
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


def phase_aot(cfg, scans, drive: dict, tmp: Path, smi: str) -> dict:
    """12. The AOT artifact (io/aot.py) on the card, at the drive's config.
    Returns each artifact run's launches."""
    import torch

    from kiss_icp_tpu_torch.io import aot
    from kiss_icp_tpu_torch.kernels import linsys, nn27
    from kiss_icp_tpu_torch.odometry import (KissICP, copy_map, init_state,
                                             make_chunked_step, make_step)

    pad = KissICP(cfg)  # pads scans as the drive did, and copies them over

    def padded(frames):
        chunk, _ = pad.build_chunk([f for f, _ in frames], [t for _, t in frames])
        return pad._to_device(chunk)

    def reset():
        linsys.build_linear_system.launches = 0
        nn27.query_nearest.launches = 0

    def counts():
        return {"k1": linsys.build_linear_system.launches, "k2": nn27.query_nearest.launches}

    def made(label, chunk=0, config=cfg):
        path = tmp / f"{label}.kiss_aot.npz"
        export_s = aot.save_step(path, config, chunk=chunk)
        t0 = time.perf_counter()
        step, meta = aot.load_step(path)
        check(meta["device_type"] == "cuda" and meta["aot_chunk"] == chunk,
              f"aot {label}: metadata {meta}")
        return step, (f"export {export_s:.1f} s, {path.stat().st_size} B, "
                      f"load {time.perf_counter() - t0:.1f} s")

    # Per frame: the drive's 12 scans through the artifact, each frame timed
    # on the host clock around its padding, copy, step and pose read.
    step, made_line = made("step")
    state = init_state(cfg)
    poses, iters, frame_ms = [], [], []
    reset()
    for scan in scans:
        t0 = time.perf_counter()
        pts, ts, valid = padded([scan])
        state, res = step(state, pts[0], ts[0], valid[0])
        poses.append(res.pose.double().cpu().numpy())
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        iters.append(int(res.num_iterations))
    out = {"aot step": counts()}
    poses = np.stack(poses)
    check(np.array_equal(poses, drive["poses"]) and iters == drive["iters"],
          f"aot step: poses or iterations differ from the drive (max |diff| "
          f"{np.abs(poses - drive['poses']).max():.3e}; iterations {iters} against "
          f"{drive['iters']})")
    check(out["aot step"] == drive["launches"],
          f"aot step: launches {out['aot step']}, drive {drive['launches']}")
    p50 = float(np.median(frame_ms[1:]))
    print(f"aot step: {made_line}; {N_FRAMES} frames bit-identical to the drive, iterations "
          f"{iters}, launches {out['aot step']} (drive {drive['launches']}); p50 {p50:.2f} "
          f"ms/frame after frame 1 against the drive's {drive['p50']:.2f}; on {smi}",
          flush=True)
    del step, state

    # Chunked: K = 2, frames 0-11 as 6 chunks, against the live chunked step.
    # The export's time grows with K (~14 s a frame): K = 4 would hold a
    # 4-frame unrolled body but cost ~35 s more, which the script's 900 s
    # target cannot spare since phase "bench" joined.
    k = 2
    step, made_line = made("chunked", chunk=k)
    live = make_chunked_step(cfg)
    lstate, astate = init_state(cfg), init_state(cfg)
    lsum, asum = [], []
    reset()
    for i in range(0, N_FRAMES, k):
        views = padded(scans[i:i + k])
        astate, s = step(astate, *views)
        asum.append(s)
    out["aot chunked"] = counts()
    for i in range(0, N_FRAMES, k):
        lstate, s = live(lstate, *padded(scans[i:i + k]))
        lsum.append(s)
    for field in ("poses", "num_iterations", "sigmas", "num_correspondences"):
        a = torch.cat([getattr(s, field) for s in asum])
        b = torch.cat([getattr(s, field) for s in lsum])
        check(torch.equal(a, b), f"aot chunked: {field} differs from the live chunked step")
    for field, a, b in zip(astate.map._fields, astate.map, lstate.map):
        check(torch.equal(_bits(a), _bits(b)), f"aot chunked: map {field} differs")
    print(f"aot chunked: K = {k} (unrolled), {made_line}; {N_FRAMES // k} chunks "
          f"bit-identical to the "
          f"live chunked step in poses, iterations, sigmas, correspondences and the map; "
          f"launches {out['aot chunked']}; on {smi}", flush=True)
    del step, astate

    # donate_state false: one step from the 12-frame state leaves it
    # bit-identical, live and through its artifact; timed against the
    # donating step (which writes a copy of the map made outside the timing).
    keep = engine_config(cfg, dict(donate_state=False))
    snapshot = [t.clone() for t in torch.utils._pytree.tree_leaves(lstate)]

    def intact():
        return all(torch.equal(_bits(a), _bits(b)) for a, b in
                   zip(torch.utils._pytree.tree_leaves(lstate), snapshot))

    frame = [t[0] for t in padded([scans[-1]])]

    def timed(fn, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_ = fn(state, *frame)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out_

    copy_ms, donate_ms, ref = [], [], None
    for order in ("dc", "cd", "cd", "dc"):
        for which in order:
            if which == "c":
                ms, (_, res) = timed(make_step(keep), lstate)
                copy_ms.append(ms)
                ref = res.pose if ref is None else ref
                check(torch.equal(res.pose, ref), "aot donate: two copying steps differ")
                check(intact(), "aot donate: the copying step wrote its input state")
            else:
                ms, (_, res) = timed(make_step(cfg), lstate._replace(map=copy_map(lstate.map)))
                donate_ms.append(ms)
    step, made_line = made("step-keep", config=keep)
    _, res = step(lstate, *frame)
    check(intact(), "aot donate: the artifact wrote its input state")
    check(torch.equal(res.pose, ref), "aot donate: the artifact's pose differs from the live step")
    print(f"aot donate: donate_state false, one step from the 12-frame state: the state "
          f"stays bit-identical, live and through its artifact ({made_line}), same pose; "
          f"step {np.median(copy_ms):.2f} ms copying the map against {np.median(donate_ms):.2f} "
          f"ms donating it (median of {len(copy_ms)} each, host clock with a sync); on {smi}",
          flush=True)
    return out


def engine_stamps(stamps, device="cuda") -> np.ndarray:
    """A scan's stamps as the step normalises them on the card: float32
    (t - min) / (max - min), by the ops of ops/preprocess.py."""
    import torch

    t = torch.from_numpy(np.asarray(stamps).astype(np.float32)).to(device)
    t_min, t_max = torch.min(t), torch.max(t)
    return ((t - t_min) / (t_max - t_min)).cpu().numpy()


def write_helipr(root: Path, scans, gt) -> list:
    """HeLiPR's Velodyne layout ('=ffffHf': x y z intensity ring t) under
    root/LiDAR/Velodyne, one file a scan, and its ground truth. `t` is the
    float32 stamp the step would use, times 1/8 (a 0.125 s sweep): the
    loader's [0, 1] normalisation gives those stamps back exactly. Returns
    the written records."""
    scan_dir, gt_dir = root / "LiDAR" / "Velodyne", root / "LiDAR_GT"
    scan_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    from scipy.spatial.transform import Rotation

    recs, rows = [], []
    for i, (pts, stamps) in enumerate(scans):
        rec = np.zeros(len(pts), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                                        ("intensity", "<f4"), ("ring", "<u2"), ("t", "<f4")])
        rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        rec["t"] = engine_stamps(stamps) * np.float32(0.125)
        stamp = 1_000_000_000 + 100_000_000 * i
        rec.tofile(scan_dir / f"{stamp}.bin")
        recs.append(rec)
        rows.append([stamp, *gt[i][:3, 3], *Rotation.from_matrix(gt[i][:3, :3]).as_quat()])
    np.savetxt(gt_dir / "global_Velodyne_gt.txt", np.array(rows))
    return recs


def write_mulran(root: Path, scans, gt) -> list:
    """MulRan's layout under root/Ouster: float32 (65536, 4) scans in
    64 x 1024 column-major order (each azimuth column's returns, then zero
    rows for the missing ones, which the range crop drops), and
    global_pose.csv, conjugated so that the loader's ground truth is `gt`.
    Returns the written scans."""
    from kiss_icp_tpu_torch.datasets.mulran import _T_LIDAR_TO_BASE as t_l2b

    (root / "Ouster").mkdir(parents=True)
    grids, rows = [], []
    for i, (pts, stamps) in enumerate(scans):
        col = np.rint(np.asarray(stamps) * 1024).astype(np.int64)
        order = np.argsort(col, kind="stable")
        cs = col[order]
        rank = np.arange(len(cs)) - np.searchsorted(cs, cs)
        check(rank.max() < 64, "loaders: more than 64 returns in one azimuth column")
        grid = np.zeros((64 * 1024, 4), np.float32)
        grid[cs * 64 + rank, :3] = pts[order]
        stamp = 1_000_000_000 + 100_000_000 * i
        grid.tofile(root / "Ouster" / f"{stamp}.bin")
        grids.append(grid)
        rows.append([stamp, *(np.linalg.inv(t_l2b) @ gt[i] @ t_l2b)[:3].ravel()])
    np.savetxt(root / "global_pose.csv", np.array(rows), delimiter=",")
    return grids


def phase_loaders(cfg, scans, ds, drive: dict, tmp: Path, smi: str) -> dict:
    """13. The CLI over the drive's 12 scans written as two loaders' files,
    both runs at once in subprocesses on the card. Returns each run's
    launches."""
    from kiss_icp_tpu_torch.config.schema import config_to_dict
    from kiss_icp_tpu_torch.datasets import dataset_factory

    gt = ds.gt_poses[:N_FRAMES]
    t0 = time.perf_counter()
    written = {"helipr": write_helipr(tmp / "helipr", scans, gt),
               "mulran": write_mulran(tmp / "mulran" / "KAIST01", scans, gt)}
    data = {"helipr": (str(tmp / "helipr"), "--dataloader", "helipr", "--sequence", "Velodyne"),
            "mulran": (str(tmp / "mulran" / "KAIST01"), "--dataloader", "mulran")}
    write_s = time.perf_counter() - t0

    # The loader returns what was written: points bit-equal as float32, the
    # stamps helipr normalises (the step's own) and mulran's column stamps.
    for name, args in data.items():
        loader = dataset_factory(name, Path(args[0]), sequence=args[-1] if name == "helipr"
                                 else None)
        check(len(loader) == N_FRAMES, f"loaders {name}: {len(loader)} scans")
        for i, rec in enumerate(written[name]):
            pts, stamps = loader[i]
            if name == "helipr":
                xyz = np.stack([rec["x"], rec["y"], rec["z"]], 1)
                want_t = engine_stamps(scans[i][1]).astype(np.float64)
            else:
                xyz = rec[:, :3]
                want_t = np.floor(np.arange(64 * 1024) / 64) / 1024
            check(pts.dtype == np.float64 and np.array_equal(pts, xyz.astype(np.float64)),
                  f"loaders {name}: scan {i} points differ from what was written")
            check(np.array_equal(stamps, want_t), f"loaders {name}: scan {i} stamps differ")
        check(np.abs(loader.gt_poses - gt).max() < 1e-9,
              f"loaders {name}: ground truth {np.abs(loader.gt_poses - gt).max():.3e} "
              "from what was written")

    base = config_to_dict(cfg)
    base["engine"]["pipeline_chunk"] = 4
    specs = []
    for name in data:
        config = json.loads(json.dumps(base))
        config["out_dir"] = str(tmp / f"results_{name}")
        specs.append((f"loaders-{name}", config, N_FRAMES, (), data[name]))
    runs = _cli_runs(tmp, specs)
    out = {}
    for name in data:
        run = runs[f"loaders-{name}"]
        k = out[f"loaders {name}"] = run["launches"]
        poses = np.load(Path(run["results_dir"]) / f"{run['sequence']}_poses.npy")
        err = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=1)
        check(run["device"].startswith("cuda") and poses.shape == (N_FRAMES, 4, 4),
              f"loaders {name}: {poses.shape} on {run['device']}")
        check_verify_gates(f"loaders {name}", {"poses": poses, "iters": run["iterations"],
                                               "drops": sum(run["drops"].values())}, err)
        check(not any(run["drops"].values()), f"loaders {name}: drops {run['drops']}")
        check(k["k1"] > 0 and k["k2"] > 0, f"loaders {name}: a kernel was not launched ({k})")
        diff = float(np.abs(poses - drive["poses"]).max())
        same = bool(np.array_equal(poses, drive["poses"]))
        extra = f"from the drive's poses {diff:.3e}"
        if name == "helipr":
            check(diff <= 1e-4, f"loaders helipr: {diff:.3e} from the drive's poses")
            if same:
                check(run["iterations"] == drive["iters"] and k == drive["launches"],
                      f"loaders helipr: bit-identical poses but iterations "
                      f"{run['iterations']} / launches {k} against the drive's "
                      f"{drive['iters']} / {drive['launches']}")
            extra = ("bit-identical to the drive's poses, iterations and launches (decoded "
                     "points and stamps bit-equal to the drive's inputs)" if same else
                     f"within {diff:.3e} m of the drive's poses (limit 1e-4)")
        steady = run["chunk_s"][1:]
        ms = sum(steady) * 1e3 / max(N_FRAMES - run["chunk"], 1)
        print(f"loaders {name}: `python -m kiss_icp_tpu_torch.tools.cmd "
              f"{' '.join(data[name][1:])}` over the drive's {N_FRAMES} scans "
              f"(files written in {write_s:.1f} s, read back bit-equal), chunk {run['chunk']}: "
              f"max_err {err.max():.4f} m, iters {run['iterations']}, drops {run['drops']}, "
              f"launches K1 {k['k1']} / K2 {k['k2']}; {extra}; engine {ms:.2f} ms/frame after "
              f"the first chunk ({run['chunk_s'][0]:.2f} s, the process's first kernel "
              f"calls); Average Runtime {run['results']['Average Runtime']:.3f} ms; on {smi}",
              flush=True)
    return out


# The batch phase: B = 4 sequences checked, and B = 1, 4, 8 timed.
BATCH_ROWS = 4
BATCH_TIMED = (1, 4, 8)
# Row b against its single-sequence drive, and row 0 against the drive.
BATCH_ROW_TOL = 1e-5
# z-axis quarter turn: (x, y) -> (-y, x), exact in f32 and f64.
QUARTER = np.array([[0.0, -1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0],
                    [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


def rotated(scans, gt, b: int):
    """The drive turned b quarter turns about z: each scan's points rotated
    (stamps unchanged) and the ground truth R P R^T."""
    r = np.linalg.matrix_power(QUARTER, b)
    out = []
    for pts, stamps in scans:
        p = np.array(pts, copy=True)
        for _ in range(b % 4):
            p = np.stack([-p[:, 1], p[:, 0], p[:, 2]], axis=1)
        out.append((p, stamps))
    return out, np.stack([r @ g @ r.T for g in gt])


def padded_rows(row_scans, cap: int):
    """(K, B, cap, ...) padded arrays of B rows of K scans each, as
    BatchedOdometry pads one frame (stride subsample above cap)."""
    from kiss_icp_tpu_torch.odometry import subsample_to_capacity

    k, b = len(row_scans[0]), len(row_scans)
    pts = np.zeros((k, b, cap, 3), np.float32)
    ts = np.zeros((k, b, cap), np.float32)
    valid = np.zeros((k, b, cap), bool)
    for j, scans in enumerate(row_scans):
        for i, (p, t) in enumerate(scans):
            p, t, _ = subsample_to_capacity(p, t, cap)
            pts[i, j, :len(p)] = p[:, :3]
            ts[i, j, :len(p)] = t
            valid[i, j, :len(p)] = True
    return pts, ts, valid


def lockstep_drive(cfg, row_scans) -> dict:
    """BatchedOdometry over B rows of scans, frame by frame, with the
    kernels' launch counters set to 0 just before and read just after:
    poses (K,B,4,4) f64, iterations (K,B), drops per row, host ms per
    frame (each ends in the poses' read), launches, the peak device memory
    (torch.cuda.max_memory_allocated) and what was allocated before."""
    import torch

    from kiss_icp_tpu_torch.kernels import linsys, nn27
    from kiss_icp_tpu_torch.parallel.batch import BatchedOdometry

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bo = BatchedOdometry(cfg, len(row_scans))
    linsys.build_linear_system.launches = 0
    nn27.query_nearest.launches = 0
    poses, iters, ms = [], [], []
    drops = np.zeros(len(row_scans), np.int64)
    for frame in zip(*row_scans):
        t0 = time.perf_counter()
        pose = bo.register_frames([f for f, _ in frame], [t for _, t in frame])
        ms.append((time.perf_counter() - t0) * 1e3)
        res = bo.last_result
        poses.append(pose.astype(np.float64))
        iters.append(res.num_iterations.cpu().numpy())
        drops += (res.num_dropped_downsample + res.num_dropped_map_voxels).cpu().numpy()
    launches = {"k1": linsys.build_linear_system.launches, "k2": nn27.query_nearest.launches}
    return {"poses": np.stack(poses), "iters": np.stack(iters), "drops": drops,
            "input_drops": bo.total_input_dropped, "ms": ms, "p50": float(np.median(ms[1:])),
            "launches": launches, "max_allocated": torch.cuda.max_memory_allocated(),
            "base_bytes": base, "engine": bo}


def phase_batch(cfg, scans, ds, drive: dict, smi: str):
    """15. The sequence axis (parallel/batch.py) on the card: the drive's
    scans as B = 4 rows turned b quarter turns about z. The batched kernels
    at the lockstep path's shapes against the unbatched kernels row by row
    (bit for bit) and their plain versions; BatchedOdometry over the 12
    frames against the drive and each row's own single-sequence drive, the
    verify gates against each row's turned ground truth, one K1 and one K2
    launch per lockstep iteration; the "map" chunked mode's launches summed
    over rows; ms per lockstep frame and peak memory at B = 1, 4, 8.
    Returns (launch columns, per-kernel entries for the kernels line)."""
    import torch

    from kiss_icp_tpu_torch.kernels import linsys, nn27
    from kiss_icp_tpu_torch.odometry import KissICP, map_config
    from kiss_icp_tpu_torch.ops import hash_map, registration
    from kiss_icp_tpu_torch.parallel.batch import init_batched_state, make_batched_chunked_step

    gt = ds.gt_poses[:N_FRAMES]
    rows = [rotated(scans, gt, b) for b in range(BATCH_ROWS)]
    row_scans = [r[0] for r in rows]
    # Each row's own single-sequence drive (row 0's is the drive phase's).
    singles = [drive] + [drive_engine(KissICP(cfg), r) for r in row_scans[1:]]

    run = lockstep_drive(cfg, row_scans)
    out = {"batch B=4 lockstep": run["launches"]}
    poses, iters = run["poses"], run["iters"]
    report = []
    for b, single in enumerate(singles):
        err = np.linalg.norm(poses[:, b, :3, 3] - rows[b][1][:, :3, 3], axis=1)
        check_verify_gates(f"batch row {b}", {"poses": poses[:, b], "iters": iters[:, b],
                                              "drops": int(run["drops"][b])}, err)
        diff = float(np.abs(poses[:, b] - single["poses"]).max())
        same = bool(np.array_equal(poses[:, b], single["poses"]))
        row_iters = [int(x) for x in iters[:, b]]
        check(row_iters == single["iters"],
              f"batch row {b}: iterations {row_iters}, its single drive {single['iters']}")
        check(diff <= BATCH_ROW_TOL, f"batch row {b}: {diff:.3e} m from its single drive")
        report.append(f"row {b} ({90 * b} deg): max_err {err.max():.4f} m, "
                      + ("bit-identical to" if same else f"{diff:.3e} from")
                      + (" the drive" if b == 0 else " its single drive"))
    check(run["input_drops"] == 0, f"batch: {run['input_drops']} input points dropped")
    lockstep = int(iters.max(axis=1).sum())
    finals = N_FRAMES - 1  # a final count in every frame after the first
    want = {"k1": lockstep, "k2": lockstep + finals}
    check(run["launches"] == want,
          f"batch lockstep: launches {run['launches']}, one per lockstep iteration is {want}")
    summed = int(iters.sum())

    # "map": each row's 12 frames through its own chunked step.
    pts, ts, valid = padded_rows(row_scans, int(cfg.engine.max_points_per_frame))
    chunk = make_batched_chunked_step(cfg, seq_mode="map")
    state = init_batched_state(cfg, BATCH_ROWS)
    linsys.build_linear_system.launches = 0
    nn27.query_nearest.launches = 0
    t0 = time.perf_counter()
    state, map_poses = chunk(state, pts, ts, valid)
    map_poses = map_poses.double().cpu().numpy()
    map_s = time.perf_counter() - t0
    k = out["batch B=4 map"] = {"k1": linsys.build_linear_system.launches,
                                "k2": nn27.query_nearest.launches}
    single_sum = sum(sum(sg["iters"]) for sg in singles)
    check(k == {"k1": single_sum, "k2": single_sum + BATCH_ROWS * finals},
          f"batch map: launches {k}, the rows' sum is {single_sum} / "
          f"{single_sum + BATCH_ROWS * finals}")
    map_diff = max(float(np.abs(map_poses[:, b] - singles[b]["poses"]).max())
                   for b in range(BATCH_ROWS))
    check(map_diff <= BATCH_ROW_TOL, f"batch map: {map_diff:.3e} m from the single drives")
    del state, chunk

    # The batched kernels at the lockstep path's shapes: each row's final map,
    # queried by its last ICP source at its final pose.
    bo = run["engine"]
    mcfg = map_config(cfg)
    m, res = bo.state.map, bo.last_result
    q = registration.transform_rows(bo.state.pose, res.source_points).contiguous()
    v = res.source_valid
    active = torch.ones(BATCH_ROWS, dtype=torch.bool, device=q.device)
    row_maps = [hash_map.VoxelMap(*(t[b] for t in m)) for b in range(BATCH_ROWS)]
    got = nn27.query_nearest_batched(mcfg, m, q, v, active)
    plain = nn27.plain_nn27_batched(q, v, active, *m[:4], float(mcfg.voxel_size),
                                    int(mcfg.probe_length))
    for b in range(BATCH_ROWS):
        one = nn27.query_nearest(mcfg, row_maps[b], q[b], v[b])
        for x, y, z in zip(got, one, plain):
            check(torch.equal(x[b].view(torch.int8), y.view(torch.int8))
                  and torch.equal(x[b].view(torch.int8), z[b].view(torch.int8)),
                  f"batch k2 row {b}: the batched kernel differs from the unbatched "
                  "kernel or the plain version")
    sigma = res.sigma
    corr = got.found & (got.distances < 3.0 * sigma[:, None])
    center = bo.state.pose[:, :3, 3].contiguous()
    k1_args = (q, got.neighbors, corr, sigma, center, active)
    sys_ = linsys.build_linear_systems(*k1_args)
    plain1 = linsys.plain_linsys_batched(*k1_args)
    k1_err = 0.0
    for b in range(BATCH_ROWS):
        one = linsys.build_linear_system(q[b], got.neighbors[b], corr[b], sigma[b], center[b])
        check(torch.equal(sys_.jtj[b], one.jtj) and torch.equal(sys_.jtr[b], one.jtr)
              and int(sys_.num_correspondences[b]) == int(one.num_correspondences),
              f"batch k1 row {b}: the batched kernel differs from the unbatched kernel")
        for a, p_ in ((sys_.jtj[b], plain1[0][b]), (sys_.jtr[b], plain1[1][b])):
            check(torch.allclose(a, p_, rtol=2e-5, atol=1e-3),
                  f"batch k1 row {b}: kernel disagrees with the plain version")
            k1_err = max(k1_err, float((a - p_).abs().max()))
    # An inactive row: no work, the empty answer.
    some = torch.tensor([True, False, True, False], device=q.device)
    off = nn27.query_nearest_batched(mcfg, m, q, v, some)
    off1 = linsys.build_linear_systems(q, got.neighbors, corr, sigma, center, some)
    check(not bool(off.found[1].any()) and bool(torch.isinf(off.distances[1]).all())
          and torch.equal(off.neighbors[0], got.neighbors[0])
          and not bool(off1.jtj[3].any()) and torch.equal(off1.jtj[2], sys_.jtj[2]),
          "batch: an inactive row did not give the empty answer")

    # The plain versions read the flags on the host: a CUDA graph captures
    # no host read.
    on_host = active.cpu()
    k1_ms, k1_plain_ms = paired_times(
        lambda: linsys.build_linear_systems(*k1_args),
        lambda: linsys.plain_linsys_batched(*k1_args[:5], on_host), 200, 20)
    k2_args = (q, v, on_host, *m[:4], float(mcfg.voxel_size), int(mcfg.probe_length))
    k2_ms, k2_plain_ms = paired_times(lambda: nn27.query_nearest_batched(mcfg, m, q, v, active),
                                      lambda: nn27.plain_nn27_batched(*k2_args), 100, 5)
    k1_b = [k1_work(q.shape[1], int(corr[b].sum())) for b in range(BATCH_ROWS)]
    k2_b = [k2_work(mcfg, row_maps[b], q[b]) for b in range(BATCH_ROWS)]

    def total(works):
        flops = {}
        for _, f in works:
            for key, val in f.items():
                flops[key] = flops.get(key, 0) + val
        return sum(w[0] for w in works) + BATCH_ROWS, flops  # + the active flags

    entries = []
    for kname, src, replaces, nl, err_, ms, pms, (nb, fl) in (
            (f"linsys (K1), batched B={BATCH_ROWS}", "kiss_icp_tpu_torch/csrc/linsys.cu",
             "kiss_icp_tpu/ops/pallas_kernels.py:31", run["launches"]["k1"], k1_err, k1_ms,
             k1_plain_ms, total(k1_b)),
            (f"nn27 (K2), batched B={BATCH_ROWS}", "kiss_icp_tpu_torch/csrc/nn27.cu",
             "kiss_icp_tpu/ops/pallas_nn.py:60", run["launches"]["k2"], 0.0, k2_ms,
             k2_plain_ms, total(k2_b))):
        b_ms, b_by = bound(nb, fl)
        entries.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": nl, "max_abs_err": err_, "ms": ms[0], "plain_ms": pms[0],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        "eager_ms": ms[1], "plain_eager_ms": pms[1], "bytes": nb, "flops": fl})
        print(f"batch times: {kname}: {ms[0] * 1e3:.2f} us/call on the device, "
              f"{ms[1] * 1e3:.2f} us issued eagerly (plain {pms[0] * 1e3:.2f} / "
              f"{pms[1] * 1e3:.2f} us); bound {b_ms * 1e3:.4f} us by {b_by} ({nb} B, {fl} "
              f"flop by type); on {smi}", flush=True)
    del bo, run["engine"], m, res, got, sys_, off, off1

    print(f"batch B={BATCH_ROWS}: BatchedOdometry over the drive's {N_FRAMES} scans turned "
          f"b x 90 deg about z; " + "; ".join(report) + f"; iterations equal to each row's "
          f"single drive; launches K1 {want['k1']} / K2 {want['k2']} (one per lockstep "
          f"iteration: the rows' sum would be {summed}); p50 {run['p50']:.2f} ms/frame; "
          f"\"map\" mode launches {k} (sum over rows), within {map_diff:.3e} m of the single "
          f"drives, {map_s:.1f} s for the chunk; the batched kernels bit-equal to the "
          f"unbatched ones row by row and to the plain versions (K2; K1 within rtol 2e-5, "
          f"max |diff| {k1_err:.3e}), an inactive row gives the empty answer; on {smi}",
          flush=True)

    # Timed: ms per lockstep frame, sequence-frames/s, launches, peak memory.
    timed = []
    for nb_ in BATCH_TIMED:
        t = lockstep_drive(cfg, [row_scans[b % BATCH_ROWS] for b in range(nb_)])
        del t["engine"]
        lockstep_b = int(t["iters"].max(axis=1).sum())
        check(t["launches"] == {"k1": lockstep_b, "k2": lockstep_b + finals},
              f"batch B={nb_}: launches {t['launches']}")
        timed.append(f"B={nb_}: p50 {t['p50']:.2f} ms/frame, {nb_ * 1e3 / t['p50']:.2f} "
                     f"sequence-frames/s, launches K1 {t['launches']['k1']} / K2 "
                     f"{t['launches']['k2']}, max_memory_allocated "
                     f"{t['max_allocated'] / 2**30:.3f} GiB ("
                     f"{(t['max_allocated'] - t['base_bytes']) / 2**30:.3f} above the "
                     f"{t['base_bytes'] / 2**30:.3f} allocated before)")
        out[f"batch B={nb_} timed"] = t["launches"]
    print("batch timed (host clock, frames 2-12; each frame ends in the poses' read): "
          + "; ".join(timed) + f"; on {smi}", flush=True)
    return out, entries


SHARD_COUNTS = (2, 4)
# tests/test_sharded_map.py:68, tests/test_sharded_engine.py:52: the sharded
# engine against the single-device one.
SHARD_POSE_TOL = 5e-4
# tests/test_pod.py:64: each pod sequence against its own map-sharded drive;
# tests/test_multihost_2proc.py:73: 2 processes against one.
POD_TOL = MULTIPROC_TOL = 1e-5
# tests/test_sharded_icp.py: the pts axis against the single-device align.
PTS_TOL = 1e-4
# The multi-process runs of tools/scaling_bench.py: B sequences, K frames.
SCALING_BATCH, SCALING_FRAMES, SCALING_TIMEOUT_S = 4, 6, 300


def sharded_drive(cfg, scans, **engine) -> dict:
    """`drive_engine` over an engine made by `create_odometry` with the
    given engine settings on top of `cfg`, with the peak device memory
    (torch.cuda.max_memory_allocated) and what was allocated before."""
    import torch

    from kiss_icp_tpu_torch.odometry import create_odometry

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    icp = create_odometry(engine_config(cfg, engine))
    run = drive_engine(icp, scans)
    run.update(engine=icp, max_allocated=torch.cuda.max_memory_allocated(), base_bytes=base)
    return run


def phase_shards(cfg, scans, ds, drive: dict, icp, tmp: Path, smi: str):
    """16. The rest of parallel/ on the card: (a) the drive through
    create_odometry with map_shards = 2 and 4, against the drive and the
    verify gates, one batched K1 and one batched K2 launch per GN iteration
    for all shards, the batched kernels over the shard rows against the
    unbatched ones and their plain versions, the occupancy, a drive whose
    origin rolls every voxel of travel and a checkpoint round trip, ms per
    frame and peak memory at D = 1, 2, 4; (b) the pod, 2 sequences x 2
    shards, each against its own map-sharded drive; (c) the pts axis, the
    drive's last frame registered over 2 stripes against the single align;
    (d) tools/scaling_bench.py at 1 and 2 processes on this card (gloo for
    the host-side pose exchange) against one BatchedOdometry here.
    Returns (launch columns, per-kernel entries for the kernels line)."""
    import torch

    from kiss_icp_tpu_torch.kernels import linsys, nn27
    from kiss_icp_tpu_torch.odometry import create_odometry, map_config
    from kiss_icp_tpu_torch.ops import hash_map, registration, se3
    from kiss_icp_tpu_torch.parallel import pod, sharded_icp, sharded_map
    from kiss_icp_tpu_torch.parallel.batch import BatchedOdometry
    from kiss_icp_tpu_torch.parallel.grid import DeviceMesh, GridAxis
    from kiss_icp_tpu_torch.parallel.sharded_engine import ShardedKissICP
    from kiss_icp_tpu_torch.tools import scaling_bench

    dev = icp.device
    gt = ds.gt_poses[:N_FRAMES]
    finals = N_FRAMES - 1  # a final count in every frame after the first
    out, entries, report = {}, [], []

    # (a) D = 1 (the single-device engine), 2, 4.
    timed = {1: sharded_drive(cfg, scans)}
    for d in SHARD_COUNTS:
        run = timed[d] = sharded_drive(cfg, scans, map_shards=d)
        eng = run["engine"]
        check(isinstance(eng, ShardedKissICP) and eng.device.type == "cuda"
              and eng.mesh.shape == {"map": d},
              f"shards D={d}: create_odometry gave {type(eng).__name__} on {eng.device}")
        err = np.linalg.norm(run["poses"][:, :3, 3] - gt[:, :3, 3], axis=1)
        check_verify_gates(f"shards D={d}", run, err)
        diff = float(np.abs(run["poses"] - drive["poses"]).max())
        check(diff <= SHARD_POSE_TOL, f"shards D={d}: {diff:.3e} m from the drive")
        want = {"k1": sum(run["iters"]), "k2": sum(run["iters"]) + finals}
        check(run["launches"] == want,
              f"shards D={d}: launches {run['launches']}, one per GN iteration is {want}")
        occ = eng.shard_occupancy()
        check(occ.min() > 0 and occ.max() <= 3 * occ.min(),
              f"shards D={d}: occupancy {occ.tolist()} not balanced within 3x")
        out[f"shards D={d}"] = run["launches"]
        report.append(f"D={d}: max_err {err.max():.4f} m, {diff:.3e} m from the drive, "
                      f"iters {run['iters']} (drive {drive['iters']}), launches K1 "
                      f"{run['launches']['k1']} / K2 {run['launches']['k2']} (one per GN "
                      f"iteration for all {d} shards + {finals} final counts), occupancy "
                      f"{occ.tolist()}")

    # The batched kernels at the map-sharded step's shapes: the D = 4 drive's
    # final shard tables as rows, its last ICP source at its final pose
    # expanded over them (made contiguous), the D stripes.
    d = SHARD_COUNTS[-1]
    eng = timed[d]["engine"]
    mcfg = sharded_map.local_map_config(eng.config, eng.mesh)
    rows = sharded_map.shard_rows(eng.state, d)
    res = eng.last_result
    s = res.source_points.shape[0]
    q = se3.transform(eng.state.pose, res.source_points).expand(d, s, 3).contiguous()
    v = res.source_valid.expand(d, s).contiguous()
    active = torch.ones(d, dtype=torch.bool, device=dev)
    shard_maps = [hash_map.VoxelMap(*(t[i] for t in rows[:4]), None, None, None)
                  for i in range(d)]
    got = nn27.query_nearest_batched(mcfg, rows, q, v, active)
    plain = nn27.plain_nn27_batched(q, v, active, *rows[:4], float(mcfg.voxel_size),
                                    int(mcfg.probe_length))
    for i in range(d):
        one = nn27.query_nearest(mcfg, shard_maps[i], q[i], v[i])
        for x, y, z in zip(got, one, plain):
            check(torch.equal(x[i].view(torch.int8), y.view(torch.int8))
                  and torch.equal(x[i].view(torch.int8), z[i].view(torch.int8)),
                  f"shards k2 shard {i}: the batched kernel differs from the unbatched "
                  "kernel or the plain version")
    stripe = ((torch.arange(s, device=dev) % d)[None, :]
              == torch.arange(d, device=dev)[:, None])
    corr = got.found & (got.distances < 3.0 * res.sigma) & stripe
    center = eng.state.pose[:3, 3].expand(d, 3).contiguous()
    scale = res.sigma.expand(d).contiguous()
    k1_args = (q, got.neighbors, corr, scale, center, active)
    sys_ = linsys.build_linear_systems(*k1_args)
    plain1 = linsys.plain_linsys_batched(*k1_args)
    k1_err = 0.0
    for i in range(d):
        one = linsys.build_linear_system(q[i], got.neighbors[i], corr[i], scale[i], center[i])
        check(torch.equal(sys_.jtj[i], one.jtj) and torch.equal(sys_.jtr[i], one.jtr),
              f"shards k1 stripe {i}: the batched kernel differs from the unbatched kernel")
        for a, p_ in ((sys_.jtj[i], plain1[0][i]), (sys_.jtr[i], plain1[1][i])):
            check(torch.allclose(a, p_, rtol=2e-5, atol=1e-3),
                  f"shards k1 stripe {i}: kernel disagrees with the plain version")
            k1_err = max(k1_err, float((a - p_).abs().max()))
    on_host = active.cpu()
    k1_ms, k1_plain_ms = paired_times(
        lambda: linsys.build_linear_systems(*k1_args),
        lambda: linsys.plain_linsys_batched(*k1_args[:5], on_host), 200, 20)
    k2_ms, k2_plain_ms = paired_times(
        lambda: nn27.query_nearest_batched(mcfg, rows, q, v, active),
        lambda: nn27.plain_nn27_batched(q, v, on_host, *rows[:4], float(mcfg.voxel_size),
                                        int(mcfg.probe_length)), 100, 5)

    def total(works):
        flops = {}
        for _, f in works:
            for key, val in f.items():
                flops[key] = flops.get(key, 0) + val
        return sum(w[0] for w in works) + d, flops  # + the active flags

    for kname, src, replaces, nl, err_, ms, pms, (nb, fl) in (
            (f"linsys (K1), batched over D={d} map-shard stripes",
             "kiss_icp_tpu_torch/csrc/linsys.cu", "kiss_icp_tpu/ops/pallas_kernels.py:31",
             timed[d]["launches"]["k1"], k1_err, k1_ms, k1_plain_ms,
             total([k1_work(s, int(corr[i].sum())) for i in range(d)])),
            (f"nn27 (K2), batched over D={d} map shards", "kiss_icp_tpu_torch/csrc/nn27.cu",
             "kiss_icp_tpu/ops/pallas_nn.py:60", timed[d]["launches"]["k2"], 0.0, k2_ms,
             k2_plain_ms, total([k2_work(mcfg, shard_maps[i], q[i]) for i in range(d)]))):
        b_ms, b_by = bound(nb, fl)
        entries.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": nl, "max_abs_err": err_, "ms": ms[0], "plain_ms": pms[0],
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        "eager_ms": ms[1], "plain_eager_ms": pms[1], "bytes": nb, "flops": fl})
        print(f"shards times: {kname}: {ms[0] * 1e3:.2f} us/call on the device, "
              f"{ms[1] * 1e3:.2f} us issued eagerly (plain {pms[0] * 1e3:.2f} / "
              f"{pms[1] * 1e3:.2f} us); bound {b_ms * 1e3:.4f} us by {b_by} ({nb} B, {fl} "
              f"flop by type); on {smi}", flush=True)
    del got, sys_, plain, plain1, rows, shard_maps

    # The origin rolled every voxel of travel, then a checkpoint round trip.
    roll = sharded_drive(cfg, scans, map_shards=d, rebase_trigger_voxels=1)
    eng_r = roll["engine"]
    check(np.any(eng_r.origin != 0), "shards rebase: the origin never rolled")
    err = np.linalg.norm(roll["poses"][:, :3, 3] - gt[:, :3, 3], axis=1)
    check_verify_gates(f"shards D={d} rebase", roll, err)
    dt = float(np.abs(roll["poses"][:, :3, 3] - timed[d]["poses"][:, :3, 3]).max())
    dr = float(np.abs(roll["poses"][:, :3, :3] - timed[d]["poses"][:, :3, :3]).max())
    check(dt <= REBASE_ATOL_T and dr <= REBASE_ATOL_R,
          f"shards rebase: {dt:.3e} m / {dr:.3e} from the D={d} drive")
    out[f"shards D={d} rebase"] = roll["launches"]
    ckpt = tmp / "sharded.npz"
    eng_r.save_checkpoint(ckpt)
    back = create_odometry(engine_config(cfg, dict(map_shards=d, rebase_trigger_voxels=1)))
    back.load_checkpoint(ckpt)
    check(np.array_equal(back.origin, eng_r.origin), "shards checkpoint: origin lost")
    for e in (eng_r, back):
        e.register_frame(*scans[-1])
    check(np.array_equal(back.last_pose, eng_r.last_pose)
          and np.array_equal(back.shard_occupancy(), eng_r.shard_occupancy()),
          "shards checkpoint: the resumed engine's next frame differs")
    report.append(f"D={d} rolling the origin every voxel: origin {eng_r.origin.tolist()}, "
                  f"{dt:.3e} m / {dr:.3e} from the D={d} drive, max_err {err.max():.4f} m; "
                  "checkpoint -> fresh engine -> next frame bit-identical")
    del eng_r, back, roll

    times = "; ".join(
        f"D={k}: p50 {r['p50']:.2f} ms/frame, max_memory_allocated "
        f"{r['max_allocated'] / 2**30:.3f} GiB ({(r['max_allocated'] - r['base_bytes']) / 2**30:.3f}"
        f" above the {r['base_bytes'] / 2**30:.3f} allocated before)" for k, r in timed.items())
    print(f"shards: the drive's {N_FRAMES} scans through create_odometry with map_shards = "
          + ", ".join(map(str, SHARD_COUNTS)) + f" (2^{cfg.engine.map_capacity_log2} slots "
          f"split into 2^{cfg.engine.map_capacity_log2 - 1} / "
          f"2^{cfg.engine.map_capacity_log2 - 2} a shard); " + "; ".join(report)
          + f"; batched K2 over the D={d} shard rows bit-equal to the unbatched kernel and "
          f"the plain version, batched K1 over the stripes bit-equal to the unbatched "
          f"kernel, within rtol 2e-5 of the plain version (max |diff| {k1_err:.3e}); on {smi}",
          flush=True)
    print(f"shards timed (host clock, frames 2-12; one card holds every shard, so sharding "
          f"saves no device memory here): {times}; on {smi}", flush=True)
    for r in timed.values():
        del r["engine"]

    # (b) The pod: the drive and the drive turned 90 deg, 2 shards each.
    pcfg = engine_config(cfg, dict(map_shards=2))
    turned, gt1 = rotated(scans, gt, 1)
    single1 = sharded_drive(cfg, turned, map_shards=2)
    del single1["engine"]
    po = pod.PodOdometry(pcfg, batch=2)
    check(po.mesh.shape == {"seq": 1, "map": 2} and po.state.pose.device.type == "cuda",
          f"pod: grid {po.mesh.shape} on {po.state.pose.device}")
    linsys.build_linear_system.launches = 0
    nn27.query_nearest.launches = 0
    t0 = time.perf_counter()
    poses = po.register_chunks([[p for p, _ in scans], [p for p, _ in turned]],
                               [[t for _, t in scans], [t for _, t in turned]])
    pod_s = time.perf_counter() - t0
    launches = {"k1": linsys.build_linear_system.launches, "k2": nn27.query_nearest.launches}
    iters = po.last_results.num_iterations.cpu().numpy()
    check(launches == {"k1": int(iters.sum()), "k2": int(iters.sum()) + 2 * finals},
          f"pod: launches {launches} for iterations {iters.tolist()}")
    pod_diff = []
    for b, ref in enumerate((timed[2], single1)):
        diff = float(np.abs(poses[b].astype(np.float64) - ref["poses"]).max())
        check(diff <= POD_TOL, f"pod: sequence {b} {diff:.3e} m from its map-sharded drive")
        check([int(x) for x in iters[b]] == ref["iters"],
              f"pod: sequence {b} iterations {iters[b].tolist()}, its drive {ref['iters']}")
        err = np.linalg.norm(poses[b][:, :3, 3] - (gt, gt1)[b][:, :3, 3], axis=1)
        check(err.max() < 0.7, f"pod: sequence {b} max_err {err.max():.4f} m")
        pod_diff.append(diff)
    out["pod B=2 D=2"] = launches
    print(f"pod: 2 sequences (the drive, and turned 90 deg) x 2 map shards through "
          f"PodOdometry.register_chunks, {N_FRAMES} frames each in {pod_s:.1f} s; each within "
          f"{max(pod_diff):.3e} m of its own map-sharded drive (tol {POD_TOL}), iterations "
          f"equal, launches K1 {launches['k1']} / K2 {launches['k2']} (sequence by sequence); "
          f"on {smi}", flush=True)
    del po

    # (c) The pts axis: the drive's last frame registered again from its
    # final pose moved 0.3 m, over 2 stripes of its source, against the
    # single-device align.
    mcfg1 = map_config(cfg)
    m, last = icp.state.map, icp.last_result
    guess = icp.state.pose.clone()
    guess[0, 3] += 0.3
    args = (last.source_points, last.source_valid, guess, 3.0 * last.sigma, last.sigma)
    kw = dict(max_iterations=int(cfg.registration.max_num_iterations),
              convergence=float(cfg.registration.convergence_criterion))
    single = registration.align_points_to_map(mcfg1, m, *args, **kw)
    mesh = DeviceMesh(dev, ((sharded_icp.PTS_AXIS, GridAxis(2)),))
    linsys.build_linear_system.launches = 0
    nn27.query_nearest.launches = 0
    striped = sharded_icp.make_sharded_align(mcfg1, mesh, **kw)(m, *args)
    launches = {"k1": linsys.build_linear_system.launches, "k2": nn27.query_nearest.launches}
    pdiff = float((striped.pose - single.pose).abs().max())
    check(pdiff <= PTS_TOL and int(striped.num_correspondences)
          == int(single.num_correspondences),
          f"pts: {pdiff:.3e} from the single align, correspondences "
          f"{int(striped.num_correspondences)} / {int(single.num_correspondences)}")
    n_it = int(striped.num_iterations)
    check(launches == {"k1": n_it, "k2": n_it + 1}, f"pts: launches {launches}, {n_it} iterations")
    out["pts 2 stripes"] = launches
    print(f"pts: make_sharded_align over 2 stripes of the drive's last source "
          f"({int(last.source_valid.sum())} points) from its final pose + 0.3 m: {pdiff:.3e} "
          f"from align_points_to_map (tol {PTS_TOL}), correspondences "
          f"{int(striped.num_correspondences)} equal, iterations {n_it} (single "
          f"{int(single.num_iterations)}), launches K1 {launches['k1']} (2 stripes a launch) "
          f"/ K2 {launches['k2']}; on {smi}", flush=True)

    # (d) Multi-process: scaling_bench at 1 and 2 processes on this card.
    t0 = time.perf_counter()
    summary_path = tmp / "scaling.json"
    proc = subprocess.run(
        [sys.executable, "-m", "kiss_icp_tpu_torch.tools.scaling_bench", "--devices", "1,2",
         "--batch", str(SCALING_BATCH), "--frames", str(SCALING_FRAMES),
         "--timeout", str(SCALING_TIMEOUT_S), "--out", str(summary_path)],
        cwd=REPO, capture_output=True, text=True, timeout=SCALING_TIMEOUT_S + 60)
    for ln in proc.stderr.splitlines():
        if ln.startswith("rank ") or "FAILED" in ln:
            print(f"multihost {ln}", flush=True)
    check(proc.returncode == 0,
          f"multihost: scaling_bench rc={proc.returncode}\n{proc.stderr[-3000:]}")
    summary = json.loads(summary_path.read_text())
    rows_ = {r["devices"]: r for r in summary["rows"]}
    check(set(rows_) == {1, 2} and all("error" not in r for r in rows_.values()),
          f"multihost: rows {summary['rows']}")
    ccfg = scaling_bench._child_config()
    frames = scaling_bench._frames(SCALING_BATCH, SCALING_FRAMES,
                                   ccfg.engine.max_points_per_frame)
    bo = BatchedOdometry(ccfg, SCALING_BATCH)
    for j in range(SCALING_FRAMES):
        ref = bo.register_frames(list(frames[j]))
    mp_diff = {}
    for n, r in rows_.items():
        check(r["device"].startswith("cuda"), f"multihost: {n} process(es) ran on {r['device']}")
        mp_diff[n] = float(np.abs(np.asarray(r["final_translations"]) - ref[:, :3, 3]).max())
        check(mp_diff[n] <= MULTIPROC_TOL,
              f"multihost: {n} process(es) {mp_diff[n]:.3e} m from one BatchedOdometry")
    out["multihost 2 proc, rank 0"] = rows_[2]["launches_rank0"]
    print(f"multihost: tools/scaling_bench.py, {SCALING_BATCH} sequences x {SCALING_FRAMES} "
          f"frames at 1 and 2 processes on this one card (gloo for the pose exchange; the "
          f"processes share the card, so this is no scaling measurement): sequence-frames/s "
          + ", ".join(f"{n} proc {r['seq_frames_per_s']:.2f}" for n, r in rows_.items())
          + f"; final translations within {max(mp_diff.values()):.3e} m of one "
          f"BatchedOdometry here (tol {MULTIPROC_TOL}); rank 0's launches "
          f"{rows_[2]['launches_rank0']}; {time.perf_counter() - t0:.1f} s; on {smi}",
          flush=True)
    return out, entries


def phase_tools(cfg, scans, ds, smi: str) -> None:
    """17. The host tools on the card: tools/op_breakdown over the drive's
    first 6 scans (the last 3 profiled), its per-stage table and the two
    kernels as the profiler saw them; tools/capacity_plan over the drive's
    12 scans and ground truth, beside the drive's configured capacities."""
    from kiss_icp_tpu_torch.tools import capacity_plan, op_breakdown

    res = op_breakdown.run_breakdown(cfg, scans[:6], profile=3, config="verify drive")
    calls = res["operator_calls_per_frame"]
    check(calls["nn27"] == calls["linsys"] + 1 and calls["linsys"] == res["mean_gn_iters_steady"],
          f"tools op_breakdown: operator calls {calls} for {res['mean_gn_iters_steady']} "
          "iterations a frame")
    seen = {k["name"]: k for k in res["kernels"] or []}
    for kname in ("linsys_kernel", "nn27_kernel"):
        check(any(kname in n and k["calls_per_frame"] > 0 for n, k in seen.items()),
              f"tools op_breakdown: the profiler saw no {kname} ({sorted(seen)})")
    print(f"tools op_breakdown: 6 frames of the drive, the last 3 under torch.profiler; "
          f"frame {res['frame_fused_ms']:.3f} ms (profiled), idle share {res['idle_share']}, "
          f"{res['mean_gn_iters_steady']} GN iterations a frame; on {smi}", flush=True)
    for line in op_breakdown.render_table(res).splitlines():
        print(f"tools op_breakdown {line}", flush=True)
    print("tools op_breakdown json " + json.dumps(res), flush=True)

    v, e = float(cfg.mapping.voxel_size), cfg.engine
    frames = [s[0] for s in scans]
    stats = capacity_plan.measure_frames(frames, v, float(cfg.data.min_range),
                                         float(cfg.data.max_range))
    map_voxels = capacity_plan.estimate_map_voxels(
        frames, list(ds.gt_poses[:len(frames)]), v, float(cfg.data.min_range),
        float(cfg.data.max_range))
    plan = capacity_plan.plan(stats, map_voxels=map_voxels,
                              max_points_per_voxel=int(cfg.mapping.max_points_per_voxel),
                              probe_length=int(e.probe_length), map_storage=str(e.map_storage))
    for name, need in (("max_points_per_frame", plan.stats["raw_max"]),
                       ("frame_capacity", plan.stats["frame_ds_max"]),
                       ("source_capacity", plan.stats["source_ds_max"])):
        cap = getattr(plan, name)
        check(cap >= need and cap & (cap - 1) == 0, f"tools capacity_plan: {name} {cap} "
              f"for a measured {need}")
    configured = {name: getattr(e, name) for name in ("max_points_per_frame", "frame_capacity",
                                                       "source_capacity", "map_capacity_log2")}
    print(f"tools capacity_plan: the drive's {len(frames)} scans with ground truth -> "
          f"{json.dumps(plan.as_dict())}; the drive runs with {configured}", flush=True)


# The bench phase: the parent's budget (its soak needs 500 s left after the
# headline child), the soak's length, and the chunked artifact's K (its
# export grows with K).
BENCH_ENV = {"KISS_BENCH_BUDGET_S": "640", "KISS_BENCH_SOAK_FRAMES": "48"}
BENCH_ARGV = ("--aot-chunk", "2")
BENCH_TIMEOUT_S = 700
# The robust child's drive on a cold 240-frame cache (this phase renders
# none): 24 frames of the 30-frame drive.
BENCH_ROBUST_FRAMES = 24
# The verify drive's gate on the headline child's 14 frames.
BENCH_MAX_ERR_M = 0.7
BENCH_POSITIVE = ("value", "median_fps", "steady_state_fps", "batched_seq_fps",
                  "streaming_p50_ms", "aot_fps", "aot_chunked_fps")


def phase_bench(tmp: Path, smi: str) -> dict:
    """18. The port's bench on the card, as a user runs it: the parent as a
    subprocess (each child its own process) over the bench's own drive. Its
    scan caches (14, 30 and 48 frames: frame i of the drive depends on the
    drive's length, so no length can reuse another's frames) are rendered
    here first, across the host's cores, so that the parent's soak gate
    sees them warm. Returns the children's K1/K2 launches."""
    from kiss_icp_tpu_torch.tools import bench

    t0 = time.perf_counter()
    cache = tmp / "bench_cache"
    cache.mkdir()
    env = dict(os.environ, KISS_BENCH_CACHE_DIR=str(cache),
               KISS_BENCH_LOG_DIR=str(tmp / "bench_logs"), **BENCH_ENV)
    before = os.environ.get("KISS_BENCH_CACHE_DIR")
    os.environ["KISS_BENCH_CACHE_DIR"] = str(cache)
    try:
        for n in (bench.N_FRAMES, 30, int(BENCH_ENV["KISS_BENCH_SOAK_FRAMES"])):
            bench._scans(bench._config(), n)
    finally:
        if before is None:
            del os.environ["KISS_BENCH_CACHE_DIR"]
        else:
            os.environ["KISS_BENCH_CACHE_DIR"] = before
    render_s = time.perf_counter() - t0
    proc = subprocess.run([sys.executable, "-m", "kiss_icp_tpu_torch.tools.bench", *BENCH_ARGV],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    for ln in proc.stderr.splitlines():
        if ln.startswith(("card:", "round ", "soak fps", "streaming:", "aot ", "robust:",
                          "bench done", "[")):
            print(f"bench | {ln}", flush=True)
    check(proc.returncode == 0, f"bench: rc={proc.returncode}\n{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in BENCH_POSITIVE:
        check(isinstance(line.get(key), (int, float)) and line[key] > 0,
              f"bench: {key} = {line.get(key)} in the last line {line}")
    check(line.get("resume_equal") is True and line.get("rebase_ok") is True,
          f"bench: resume_equal / rebase_ok not true in {line}")
    summary = json.loads((tmp / "bench_logs" / "summary.json").read_text())
    check(summary["card"] == smi, f"bench: summary card {summary['card']!r}, not {smi!r}")
    # Every child the parent spawned finished with its own result: none
    # failed, none was cut at its timeout.
    check(summary["failed"] == {}, f"bench: children failed: {summary['failed']}")
    for mode in summary["child_wall_s"]:
        got = summary["headline" if mode == "chunked" else mode]
        check(isinstance(got, dict) and got.get("mode") == mode and not got.get("timed_out"),
              f"bench: child {mode} gave {got}")
    ab = summary["ab"]
    check(all(isinstance(ab.get(v), (int, float)) and ab[v] > 0 for v in bench.AB_VARIANTS),
          f"bench ab: not every variant of {list(bench.AB_VARIANTS)} above 0: {ab}")
    robust = summary["robust"]
    check(robust["n_frames"] == BENCH_ROBUST_FRAMES and robust["rebase_parity_m"] == 0.0,
          f"bench robust: {robust['n_frames']} frames (expected {BENCH_ROBUST_FRAMES}), the "
          f"re-based trajectory {robust['rebase_parity_m']} m from the straight one shifted")
    head, soak, aot = summary["headline"], summary["soak"], summary["aot"]
    n = bench.N_FRAMES
    # One K1 launch a GN iteration; K2 the same plus one final count a frame
    # but the first (its map is empty).
    for label, child, frames, iters in (("chunked", head, n, head["gn_iterations"]),
                                        ("soak", soak, soak["n_frames"],
                                         soak["total_gn_iterations"])):
        check(child["launches"] == {"k1": iters, "k2": iters + frames - 1},
              f"bench {label}: launches {child['launches']} for {iters} GN iterations "
              f"over {frames} frames")
    check(head["dropped"] == 0 and head["max_err_m"] < BENCH_MAX_ERR_M,
          f"bench chunked: drops {head['dropped']}, max error {head['max_err_m']} m")
    check(soak["dropped"] == 0 and soak["oob"] == 0,
          f"bench soak: drops {soak['dropped']}, out-of-envelope points {soak['oob']}")
    if bench.peak_hbm_bytes_per_s(summary["card"].split(",")[0]) is not None:
        check(line.get("hbm_utilization_pct", 0) > 0,
              f"bench: no hbm_utilization_pct for a card of known peak in {line}")
    check(aot["chunked_identical"] and aot["step_identical"],
          f"bench aot: artifacts not bit-identical to the live step: {aot}")
    print(f"bench: `python -m kiss_icp_tpu_torch.tools.bench {' '.join(BENCH_ARGV)}` with "
          f"{BENCH_ENV}: last line "
          f"{json.dumps(line)}; chunked {head['rounds']} rounds (best {head['fps']}, median "
          f"{head['median_fps']}, spread {head['spread_pct']} %), max_err {head['max_err_m']} m, "
          f"launches {head['launches']} = {head['gn_iterations']} GN iterations (+{n - 1} final "
          f"counts); soak {soak['n_frames']} frames, map {soak['map_points']} points, drops "
          f"{soak['dropped']}, oob {soak['oob']}, launches {soak['launches']}; ab {ab}; robust "
          f"{robust['n_frames']} frames, re-base parity {robust['rebase_parity_m']} m; caches "
          f"rendered "
          f"in {render_s:.1f} s; child wall s {summary['child_wall_s']}; on {smi}", flush=True)
    batched = summary["batched"]
    return {"bench chunked": head["launches"], "bench soak": soak["launches"],
            "bench batched vmap": batched["launches_vmap"],
            "bench batched map": batched["launches_map"]}


def fake_ros_modules(overrides: dict, on_spin):
    """A minimal fake of rclpy, geometry_msgs, nav_msgs, sensor_msgs and
    tf2_ros (there is no ROS on the card's machine): what
    ros/odometry_server.py touches. Messages are attribute bags; a Node
    takes its parameters from `overrides`; rclpy.spin(node) calls
    `on_spin(node)`."""
    import types

    class Bag:
        def __init__(self, **kw):
            self.__dict__.update(kw)

        def __getattr__(self, name):
            if name.startswith("__"):
                raise AttributeError(name)
            value = Bag()
            setattr(self, name, value)
            return value

    class PointField(Bag):
        FLOAT32 = 7

    class Publisher:
        def __init__(self):
            self.msgs = []

        def publish(self, msg):
            self.msgs.append(msg)

    class Logger:
        def __init__(self):
            self.lines = []

        def info(self, m):
            self.lines.append(m)

        warning = info

    class Node:
        def __init__(self, name):
            self.params, self.pubs, self.subs, self.logger = {}, {}, [], Logger()

        def declare_parameter(self, name, default):
            self.params[name] = overrides.get(name, default)

        def get_parameter(self, name):
            return Bag(value=self.params[name])

        def create_publisher(self, msg_type, topic, qos):
            return self.pubs.setdefault(topic, Publisher())

        def create_subscription(self, msg_type, topic, callback, qos):
            self.subs.append((topic, callback))

        def get_logger(self):
            return self.logger

        def destroy_node(self):
            self.destroyed = True

    class Buffer:
        def lookup_transform(self, target, source, when):
            raise LookupError(f"no transform {target} <- {source}")

    class Broadcaster:
        def __init__(self, node):
            self.sent = []

        def sendTransform(self, tfm):
            self.sent.append(tfm)

    def module(name, **attrs):
        m = types.ModuleType(name)
        m.__dict__.update(attrs)
        return m

    qos = dict(QoSProfile=Bag, QoSReliabilityPolicy=Bag(RELIABLE=1),
               QoSDurabilityPolicy=Bag(VOLATILE=1))
    rclpy = module("rclpy", init=lambda args=None: None, shutdown=lambda: None, spin=on_spin,
                   time=module("rclpy.time", Time=Bag))
    return {"rclpy": rclpy, "rclpy.node": module("rclpy.node", Node=Node),
            "rclpy.qos": module("rclpy.qos", **qos), "rclpy.time": rclpy.time,
            "geometry_msgs": module("geometry_msgs"),
            "geometry_msgs.msg": module("geometry_msgs.msg", TransformStamped=Bag),
            "nav_msgs": module("nav_msgs"), "nav_msgs.msg": module("nav_msgs.msg", Odometry=Bag),
            "sensor_msgs": module("sensor_msgs"),
            "sensor_msgs.msg": module("sensor_msgs.msg", PointCloud2=Bag, PointField=PointField),
            "tf2_ros": module("tf2_ros", TransformBroadcaster=Broadcaster),
            "tf2_ros.buffer": module("tf2_ros.buffer", Buffer=Buffer),
            "tf2_ros.transform_listener": module("tf2_ros.transform_listener",
                                                 TransformListener=lambda buf, node: None)}, Bag


def phase_ros(cfg, scans, drive: dict, tmp: Path, smi: str) -> dict:
    """14. The ROS 2 node on the card: main() spins a node whose device is
    left at its default; the fake spin publishes the drive's 12 scans as
    PointCloud2 records (float32 x y z t, t the stamps the step uses) and
    returns; main() then writes the shutdown checkpoint. Returns the
    node's launches."""
    import copy

    from kiss_icp_tpu_torch.config.schema import config_to_dict
    from kiss_icp_tpu_torch.kernels import linsys, nn27
    from kiss_icp_tpu_torch.odometry import KissICP
    from kiss_icp_tpu_torch.ros import core, odometry_server
    from kiss_icp_tpu_torch.tools.point_cloud2 import read_point_cloud

    ckpt = tmp / "ros_node.npz"
    seen = {"poses": [], "ms": [], "node": None}

    def spin(node):
        seen["node"] = node
        (topic, callback), = node.subs
        check(topic == "/points", f"ros: subscribed to {topic}")
        for msg in msgs:
            t0 = time.perf_counter()
            callback(msg)
            seen["ms"].append((time.perf_counter() - t0) * 1e3)
            seen["poses"].append(node.odometry.last_pose)

    overrides = {"pointcloud_topic": "/points", "min_range": float(cfg.data.min_range),
                 "save_checkpoint_path": str(ckpt)}
    fakes, Bag = fake_ros_modules(overrides, spin)
    PointField = fakes["sensor_msgs.msg"].PointField

    def cloud(pts, stamps, i):
        msg = Bag()
        msg.header.frame_id, msg.header.stamp = "lidar", Bag(sec=i, nanosec=0)
        msg.height, msg.width = 1, len(pts)
        msg.fields = [PointField(name=n, offset=4 * j, datatype=PointField.FLOAT32, count=1)
                      for j, n in enumerate("xyzt")]
        msg.is_bigendian, msg.point_step, msg.is_dense = False, 16, True
        rec = np.concatenate([pts.astype(np.float32), engine_stamps(stamps)[:, None]], 1)
        msg.data = rec.tobytes()
        msg.row_step = len(msg.data)
        return msg

    msgs = [cloud(p, t, i) for i, (p, t) in enumerate(scans)]
    # The decoded arrays against the drive's inputs as the step sees them.
    decoded_equal = all(
        np.array_equal(read_point_cloud(m)[0].astype(np.float32), p.astype(np.float32))
        and np.array_equal(read_point_cloud(m)[1].astype(np.float32), engine_stamps(t))
        for m, (p, t) in zip(msgs, scans))
    saved = {name: sys.modules.get(name) for name in fakes}
    orig = core.config_from_params
    # The drive's engine capacities (the node's parameters set the rest).
    core.config_from_params = lambda params: dataclasses.replace(
        orig(params), engine=copy.deepcopy(cfg.engine))
    sys.modules.update(fakes)
    try:
        odometry_server._NODE_CLASS = None
        linsys.build_linear_system.launches = 0
        nn27.query_nearest.launches = 0
        odometry_server.main(args=None)
        launches = {"k1": linsys.build_linear_system.launches,
                    "k2": nn27.query_nearest.launches}
    finally:
        core.config_from_params = orig
        odometry_server._NODE_CLASS = None
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
    node = seen["node"]
    check(node is not None and getattr(node, "destroyed", False),
          "ros: main() did not spin and destroy the node")
    check(node.odometry.device.type == "cuda", f"ros: the node runs on {node.odometry.device}")
    check(config_to_dict(node.odometry.config) == config_to_dict(cfg),
          "ros: the node's config is not the drive's")
    odom, sent = node.pubs["kiss/odometry"].msgs, node.tf_broadcaster.sent
    check(len(odom) == N_FRAMES and len(sent) == N_FRAMES,
          f"ros: {len(odom)} odometry and {len(sent)} TF messages for {N_FRAMES} scans")
    poses = np.stack(seen["poses"])
    published = np.array([[m.pose.pose.position.x, m.pose.pose.position.y,
                           m.pose.pose.position.z] for m in odom])
    check(np.array_equal(published, poses[:, :3, 3]), "ros: published positions are not the poses")
    check(odom[-1].header.frame_id == "odom_lidar" and odom[-1].child_frame_id == "lidar"
          and sent[-1].child_frame_id == "lidar", "ros: frames of the published messages")
    diff = float(np.abs(poses - drive["poses"]).max())
    same = bool(np.array_equal(poses, drive["poses"]))
    check(diff <= 1e-4, f"ros: {diff:.3e} from the drive's poses")
    if decoded_equal:
        check(same and launches == drive["launches"],
              f"ros: decoded inputs bit-equal to the drive's, but poses {diff:.3e} from it, "
              f"launches {launches} against {drive['launches']}")
    check(launches["k1"] > 0 and launches["k2"] > 0, f"ros: a kernel was not launched ({launches})")
    check(ckpt.is_file(), "ros: main() wrote no checkpoint on shutdown")
    fresh = KissICP(cfg)
    fresh.load_checkpoint(ckpt)
    check(np.array_equal(fresh.last_pose, poses[-1]), "ros: the checkpoint's pose is not the node's")
    p50 = float(np.median(seen["ms"][1:]))
    print(f"ros: ros/odometry_server.main() on the card (device left at its default), "
          f"{N_FRAMES} PointCloud2 records (float32 x y z t, {msgs[0].point_step} B a point): "
          f"{len(odom)} odometry and {len(sent)} TF messages; decoded points and stamps "
          f"{'bit-equal' if decoded_equal else 'NOT bit-equal'} to the drive's inputs, poses "
          f"{'bit-identical to' if same else f'within {diff:.3e} m of'} the drive's; launches "
          f"K1 {launches['k1']} / K2 {launches['k2']} (drive {drive['launches']}); "
          f"callback p50 {p50:.2f} ms/message after the first ({seen['ms'][0]:.1f} ms); "
          f"shutdown checkpoint {ckpt.stat().st_size} B loads, same pose; on {smi}", flush=True)
    return {"ros": launches}


if __name__ == "__main__":
    sys.exit(main())
