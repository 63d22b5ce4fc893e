"""Where a kernel's time goes: variants of K1 and K2 timed on the card.

    python -m kiss_icp_tpu_torch.tools.kernel_anatomy

K1 (`csrc/linsys.cu`) at the main path's 8192 points: the kernel as built,
then copies of it with phases cut out (the per-point arithmetic, the
exchange across the cluster, the tile loads), an empty kernel launched as
the same cluster, and the whole kernel as one cluster of 16 blocks of 256
threads (a size only some cards schedule, launched with
cudaLaunchKernelEx). K2 (`csrc/nn27.cu`) at the main path's shape (8192
queries from a 1.5 m downsampled synthetic scan against a 2^19-slot map of
four frames): the kernel with other numbers of candidates a lane loads per
batch (kU) and of warps per block, and with other ways to keep the plain
version's NaN rule (or none, to time what it costs); each variant is
checked bit-equal to the plain version. A launch floor (a one-element
`add_`) is timed beside.

Each variant is the committed source with constants or lines substituted
(every substitution is asserted to apply), built with the package's nvcc
flags into `_build/anatomy/`, and timed by `tools/timing.time_ms` (CUDA-graph
replay), twice in turn. Variants with phases cut out compute nothing
useful: they are timings only. The last line is the same numbers as JSON.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from kiss_icp_tpu_torch.kernels import _build, nn27
from kiss_icp_tpu_torch.ops import hash_map, se3, voxel
from kiss_icp_tpu_torch.tools.timing import time_ms

# K1 variants: bit 1 per-point arithmetic, bit 2 cluster exchange, bit 4 loads.
K1_MODES = {7: "full kernel", 5: "loads + arithmetic, no cluster exchange",
            6: "loads + cluster exchange, no arithmetic", 4: "loads only"}


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"anatomy: the source no longer contains {old!r}")
    return text.replace(old, new, 1)


def _k1_source() -> str:
    s = (_build.CSRC_DIR / "linsys.cu").read_text()
    s = _sub(s, "__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)\n"
             "linsys_kernel(", "template <int MODE>\n__global__ void __cluster_dims__("
             "kCluster, 1, 1) __launch_bounds__(kThreads)\nlinsys_kernel(")
    s = _sub(s, "    stage_tile(src + 3 * tile0,", "    if (MODE & 4) stage_tile(src + 3 * tile0,")
    s = _sub(s, "      if (i >= m || !s_mask[i]) continue;",
             "      if (!(MODE & 1) || i >= m || !s_mask[i]) continue;")
    s = _sub(s, "  cluster_arrive_relaxed();\n", "  if (MODE & 2) cluster_arrive_relaxed();\n")
    s = _sub(s, "  cluster_wait();  // phase 1: block 0 is running",
             "  if (!(MODE & 2)) {\n    if (threadIdx.x < kSums) out_jtj[threadIdx.x] = "
             "static_cast<float>(bsum);\n    return;\n  }\n  cluster_wait();")
    s = s[:s.index("// One launch: a single cluster")]
    launches = "\n".join(f"    case {m}: launch(linsys_kernel<{m}>); break;" for m in K1_MODES)
    return s + f"""
__global__ void __cluster_dims__(kCluster, 1, 1) empty_kernel(float* o) {{
  if (threadIdx.x == 0 && blockIdx.x == 0) o[0] = 1.f;
}}

extern "C" int anatomy_linsys(int mode, const void* src, const void* tgt, const void* mask,
                              int n, const void* ks, const void* c, void* jtj, void* jtr,
                              void* cnt, void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel) {{
    kernel<<<kCluster, kThreads, 0, s>>>(
        static_cast<const float*>(src), static_cast<const float*>(tgt),
        static_cast<const unsigned char*>(mask), n, static_cast<const float*>(ks),
        static_cast<const float*>(c), 1, static_cast<float*>(jtj), static_cast<float*>(jtr),
        static_cast<int*>(cnt));
  }};
  switch (mode) {{
{launches}
    default: empty_kernel<<<kCluster, kThreads, 0, s>>>(static_cast<float*>(jtj));
  }}
  return static_cast<int>(cudaGetLastError());
}}
"""


def _k1_cluster16_source() -> str:
    """The kernel as one non-portable cluster of 16 blocks, 512 points each."""
    s = (_build.CSRC_DIR / "linsys.cu").read_text()
    s = _sub(s, "constexpr int kThreads = 512;", "constexpr int kThreads = 256;")
    s = _sub(s, "constexpr int kCluster = 8;", "constexpr int kCluster = 16;")
    s = _sub(s, "constexpr int kTile = 1024;", "constexpr int kTile = 512;")
    s = _sub(s, "__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)",
             "__global__ void __launch_bounds__(kThreads)")
    start = s.index("  linsys_kernel<<<kCluster")
    end = s.index("  return static_cast<int>(cudaGetLastError());", start)
    return s[:start] + """  static const cudaError_t allowed = cudaFuncSetAttribute(
      linsys_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, linsys_kernel, static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const unsigned char*>(mask), n, static_cast<const float*>(kernel_scale),
      static_cast<const float*>(center), vec, static_cast<float*>(jtj),
      static_cast<float*>(jtr), static_cast<int*>(count));
  if (e != cudaSuccess) return static_cast<int>(e);
""" + s[end:]


# (kU, warps per block, NaN handling); the first as built. NaN handling:
# "key" as built (a NaN d2 enters the min as the key -1, below every real
# d2), "vote" (a per-lane flag and one warp vote), "none" (a NaN d2 is
# skipped: wrong where a NaN meets the query; a timing of what the rule
# costs).
K2_VARIANTS = [(2, 8, "key"), (1, 8, "key"), (4, 8, "key"), (2, 4, "key"),
               (2, 16, "key"), (2, 8, "vote"), (2, 8, "none")]

_NAN_KEY = ("      const float key = isnan(d2) ? -1.f : d2;\n"
            "      if (t < total && key < best) {\n        best = key;",
            "  if (wbest < 0.f) wbest = __int_as_float(0x7fffffff);")
_NAN_SUBS = {
    "vote": ("      nan |= t < total && isnan(d2);\n      if (t < total && d2 < best) {\n"
             "        best = d2;",
             "  if (__any_sync(kFull, nan)) wbest = __int_as_float(0x7fffffff);"),
    "none": ("      if (t < total && d2 < best) {\n        best = d2;", ""),
}


def _k2_name(ku: int, warps: int, nan: str) -> str:
    return f"k2_{ku}_{warps}_{nan}"


def _k2_source(ku: int, warps: int, nan: str) -> str:
    s = (_build.CSRC_DIR / "nn27.cu").read_text()
    s = _sub(s, "constexpr int kU = 2;", f"constexpr int kU = {ku};")
    s = _sub(s, "constexpr int kWarpsPerBlock = 8;", f"constexpr int kWarpsPerBlock = {warps};")
    if nan != "key":
        for old, new in zip(_NAN_KEY, _NAN_SUBS[nan]):
            s = _sub(s, old, new)
        if nan == "vote":
            s = _sub(s, "  int bt = 0x7fffffff;\n", "  int bt = 0x7fffffff;\n  bool nan = false;\n")
    return s


def build(sources: dict) -> dict:
    """{name: source text} -> {name: (loaded library, ptxas registers)},
    built into `anatomy/` under the kernels' build root."""
    out = _build.build_root() / "anatomy"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.nvcc_path(), {}
    for name, text in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"anatomy: nvcc failed on {name}:\n{log}")
        libs[name] = (ctypes.CDLL(str(out / f"{name}.so")),
                      re.findall(r"Used (\d+) registers", log))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_anatomy: no CUDA device is available")
    from kiss_icp_tpu_torch.datasets.synthetic import SyntheticDataset

    dev = torch.device("cuda", torch.cuda.current_device())
    libs = build({"k1": _k1_source(), "k1_cluster16": _k1_cluster16_source(),
                  **{_k2_name(*v): _k2_source(*v) for v in K2_VARIANTS}})
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = _build.stream_getter()  # read at each call: graph capture runs on its own

    # K1 inputs: chip_smoke.py's first k1 case (8192 points, seed 0).
    rng = np.random.default_rng(0)
    src_np = rng.uniform(-50, 50, (8192, 3)).astype(np.float32)
    tgt_np = (src_np + rng.normal(0, 0.3, (8192, 3))).astype(np.float32)
    src, tgt = torch.from_numpy(src_np).to(dev), torch.from_numpy(tgt_np).to(dev)
    mask = torch.from_numpy(rng.random(8192) > 0.3).to(dev)
    ks, c = torch.tensor(0.7, device=dev), torch.tensor([3.0, -2.0, 1.0], device=dev)
    jtj, jtr = torch.empty(36, device=dev), torch.empty(6, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    k1 = libs["k1"][0].anatomy_linsys
    k1.argtypes = [i, p, p, p, i, p, p, p, p, p, p]

    k1_16 = libs["k1_cluster16"][0].kiss_linsys
    k1_16.argtypes = [p, p, p, i, p, p, i, p, p, p, p]
    jtj16, jtr16 = torch.empty(36, device=dev), torch.empty(6, device=dev)

    def k1_16_call():
        err = k1_16(src.data_ptr(), tgt.data_ptr(), mask.data_ptr(), 8192, ks.data_ptr(),
                    c.data_ptr(), 1, jtj16.data_ptr(), jtr16.data_ptr(), cnt.data_ptr(),
                    stream(dev.index))
        if err:
            raise RuntimeError(f"anatomy: the 16-block cluster did not launch (CUDA error {err})")

    def k1_call(mode):
        return lambda: k1(mode, src.data_ptr(), tgt.data_ptr(), mask.data_ptr(), 8192,
                          ks.data_ptr(), c.data_ptr(), jtj.data_ptr(), jtr.data_ptr(),
                          cnt.data_ptr(), stream(dev.index))

    # K2 inputs: 8192 queries of a 1.5 m downsampled scan at its true pose,
    # against a 2^19-slot map of four frames at 0.5 m.
    ds = SyntheticDataset(sequence=0, n_scans=5, speed=1.0, accel_frames=30)
    cfg = hash_map.MapConfig(voxel_size=1.0, max_distance=100.0, max_points_per_voxel=20,
                             capacity_log2=19, probe_length=16)
    m = hash_map.create_map(cfg, device=dev)

    def world(frame, size, capacity):
        pts = torch.from_numpy(ds[frame][0].astype(np.float32)).to(dev)
        d = voxel.voxel_downsample(pts, torch.ones(len(pts), dtype=torch.bool, device=dev),
                                   voxel_size=size, capacity=capacity)
        pose = torch.from_numpy(ds.gt_poses[frame].astype(np.float32)).to(dev)
        return se3.transform(pose, d.points).contiguous(), d.valid

    for frame in range(4):
        m, _ = hash_map.insert(cfg, m, *world(frame, 0.5, 16384))
    q, valid = world(4, 1.5, 8192)
    ref = hash_map.query_nearest(cfg, m, q, valid)
    _, margs = nn27._map_args(cfg)
    nn, dist = torch.empty_like(ref.neighbors), torch.empty_like(ref.distances)
    found = torch.empty_like(ref.found)

    def k2_call(name, queries=q):
        fn = libs[name][0].kiss_nn27
        fn.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, f, f, i, p, p, p, p]
        return lambda: fn(queries.data_ptr(), valid.data_ptr(), q.shape[0], m.vkeys.data_ptr(),
                          m.fprints.data_ptr(), m.counts.data_ptr(), m.points.data_ptr(),
                          *margs, 1, nn.data_ptr(), dist.data_ptr(), found.data_ptr(),
                          stream(dev.index))

    # The 16-block variant sums in another order: held to the built kernel
    # at the plain version's tolerance.
    k1_call(7)()
    k1_16_call()
    torch.cuda.synchronize()
    if not torch.allclose(jtj16, jtj, rtol=2e-5, atol=1e-3):
        raise RuntimeError("anatomy: the 16-block K1 variant disagrees with the built kernel")
    # Every K2 variant bit-equal to the plain version; those that keep the
    # NaN rule also on queries with NaN coordinates.
    q_nan = q.clone()
    q_nan[::7, 0] = float("nan")
    ref_nan = hash_map.query_nearest(cfg, m, q_nan, valid)
    for v in K2_VARIANTS:
        for queries, r in ((q, ref), (q_nan, ref_nan))[:1 if v[2] == "none" else 2]:
            k2_call(_k2_name(*v), queries)()
            torch.cuda.synchronize()
            if not (torch.equal(nn, r.neighbors) and torch.equal(found, r.found)
                    and torch.equal(dist.view(torch.int32), r.distances.view(torch.int32))):
                raise RuntimeError(f"anatomy: K2 variant {_k2_name(*v)} differs from plain")

    one = torch.zeros(1, device=dev)
    rows = [("launch floor: one-element add_", lambda: one.add_(1.0), "")]
    rows += [(f"K1 {label}", k1_call(mode), "") for mode, label in K1_MODES.items()]
    rows += [("K1 empty kernel, same cluster", k1_call(0), ""),
             ("K1 full kernel, 16 blocks x 256 threads", k1_16_call,
              "/".join(libs["k1_cluster16"][1]) + " registers")]
    rows += [(f"K2 kU={ku}, {w} warps/block, NaN {nan}" + (" (as built)" if n == 0 else ""),
              k2_call(_k2_name(ku, w, nan)),
              "/".join(libs[_k2_name(ku, w, nan)][1]) + " registers")
             for n, (ku, w, nan) in enumerate(K2_VARIANTS)]
    times = {label: [] for label, _, _ in rows}
    for _ in range(2):
        for label, fn, _ in rows:
            times[label].append(time_ms(fn, 200)[0] * 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.splitlines()[0]
    print(f"kernel_anatomy on {smi}: device us/call (CUDA-graph replay), two rounds")
    for label, _, note in rows:
        print(f"  {label:48s} {times[label][0]:7.2f} {times[label][1]:7.2f} {note}")
    print(f"  K1 registers {'/'.join(libs['k1'][1])}; K2 queries {q.shape[0]}, "
          f"{int(valid.sum())} valid")
    print(json.dumps({"card": smi, "us": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
