// K2: the whole 27-voxel nearest-neighbour query against the voxel hash map.
//
// Replaces the Pallas kernel kiss_icp_tpu/ops/pallas_nn.py::_candidate_kernel
// (called by evaluate_candidates / query_nearest_fused) together with the
// XLA fingerprint probe and point-row gather the TPU had to run around it
// (Mosaic has no vector gather). Plain PyTorch version:
// kiss_icp_tpu_torch/ops/hash_map.py::query_nearest, which this kernel
// matches bit for bit.
//
// What bounds it on the H100: the latency of dependent, data-driven reads,
// not bandwidth. An 8192-query launch on the main path reads ~1.3 MB of
// distinct data, and the 2 MB fingerprint and 6 MB key tables of a 2^19-slot
// map sit in the 50 MB L2, so the launch lasts as long as its longest chain
// of dependent L2 round trips. Probing a window slot by slot and walking a
// row point by point would make that a few dozen round trips per query.
//
// This design cuts the chain to four round trips (query -> probe window ->
// key and count -> candidate points), with one warp per query:
//   1. Probe. Lane j < 27 takes neighbour voxel j (hash_map._NEIGHBOR_SHIFTS
//      order: {0, 1, -1} per axis, x slowest), computes its voxel, hash,
//      fingerprint and window row, and loads its whole aligned window of
//      `probe_len` fingerprints at once: 16 B loads, all issued before any
//      is used (a scalar loop where the window is not 16 B aligned). The
//      FIRST fingerprint match wins; if that slot's key differs, the voxel
//      is absent (no scan onward), as in the plain version.
//   2. Key and count. The three key words and the count are loaded together;
//      the count is clipped to [0, P].
//   3. Rows. A warp prefix sum of the counts lays the present voxels' points
//      out as one flat candidate list, in (j, lane) order. All 32 lanes
//      stride over it, kU candidates a lane at a time, so every point load of
//      a batch is in flight at once and neighbouring lanes read neighbouring
//      points of a row. A lane finds its candidate's voxel by a binary search
//      over the lanes' inclusive prefix sums (five shuffles).
//   4. Min. Each lane keeps the lexicographic minimum of (d2, flat index);
//      the warp reduces the same pair. The flat index orders candidates as the
//      plain version's argmin over the (27, P) slab does: lowest j, then
//      lowest lane, win a tie.
// Row loads are scalar: a point is 12 B (6 B in u16) and starts 4 B (2 B)
// aligned, and consecutive lanes read consecutive words of a row, so each
// warp load is already a few whole cache lines.
//
// Bit-equality with the plain version: every float step is an explicit
// round-to-nearest intrinsic (no FMA contraction), in the plain version's
// order: floor(q / v) with __fdiv_rn and the int32 wraparound add; the u16
// decode stored * (v/65535) + voxel * v; d2 = (dx^2 + dy^2) + dz^2; the
// distance __fsqrt_rn(best), also for invalid queries (only `found` is
// masked by `valid`); a NaN d2 among the candidates (a NaN query or stored
// point) wins, as in the plain version's argmin: distance NaN, not found.
//
// Occupancy: 8 warps a block, 32 registers a thread and no spills (ptxas,
// printed on chip_smoke.py's `build` line), so 8 blocks (64 warps) fit on an
// SM and the main path's 8192 queries (1024 blocks) run as one wave of the
// card's 132 x 8 block slots. kU = 2 and 8 warps a block time within 0.2 us
// of the best of kU in {1, 2, 4} and 4, 8 or 16 warps a block
// (tools/kernel_anatomy.py; numbers in PERF.md).
// What is left once the chain is short: every warp issues its query's
// division, 27 hashes, window compares, prefix sum, owner search and
// reduction, 8192 times per launch, so instruction issue, not memory,
// is the next limit (an estimate from the instruction mix; the card's
// machine offers no profiler counters).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kU = 2;  // candidates a lane loads per batch
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_coords(int x, int y, int z) {
  uint32_t h = mix32(static_cast<uint32_t>(x) * 0x9E3779B1u);
  h = mix32(h ^ (static_cast<uint32_t>(y) * 0x85EBCA77u));
  h = mix32(h ^ (static_cast<uint32_t>(z) * 0xC2B2AE3Du));
  return h;
}

// Base-3 digit d of the neighbour index -> shift {0, 1, -1}.
__device__ __forceinline__ int shift_of(int digit) { return digit == 2 ? -1 : digit; }

__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// Bit s of the result is set where window slot s holds `fp`.
__device__ __forceinline__ uint32_t match_bits(const int4 w, int fp, int at) {
  return (static_cast<uint32_t>(w.x == fp) | static_cast<uint32_t>(w.y == fp) << 1 |
          static_cast<uint32_t>(w.z == fp) << 2 | static_cast<uint32_t>(w.w == fp) << 3)
         << at;
}

// Slot of the first fingerprint match in the aligned window at `base`, or -1.
__device__ __forceinline__ int probe_window(const int* __restrict__ fprints, int base,
                                            int probe_len, int fp, bool vec) {
  if (vec) {  // probe_len % 4 == 0 and fprints 16 B aligned: 16 B loads
    for (int c = 0; c < probe_len; c += 16) {
      const int4* w = reinterpret_cast<const int4*>(fprints + base + c);
      int4 part[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        part[k] = c + 4 * k < probe_len ? w[k] : make_int4(0, 0, 0, 0);  // 0 never matches
      uint32_t bits = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) bits |= match_bits(part[k], fp, 4 * k);
      if (bits) return base + c + __ffs(bits) - 1;
    }
    return -1;
  }
  for (int s = 0; s < probe_len; ++s)
    if (fprints[base + s] == fp) return base + s;
  return -1;
}

template <bool kU16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
nn27_kernel(const float* __restrict__ queries, const bool* __restrict__ valid, int n,
            const int* __restrict__ vkeys, const int* __restrict__ fprints,
            const int* __restrict__ counts, const void* __restrict__ points_raw,
            int p, int probe_len, int probe_shift, int row_bits, float v, float dec,
            int vec_probe, float* __restrict__ out_nn, float* __restrict__ out_dist,
            bool* __restrict__ out_found) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= n) return;  // whole warp exits together

  const float* qp = queries + 3 * static_cast<int64_t>(q);
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const bool qvalid = valid[q];
  const int vx = static_cast<int>(floorf(__fdiv_rn(qx, v)));
  const int vy = static_cast<int>(floorf(__fdiv_rn(qy, v)));
  const int vz = static_cast<int>(floorf(__fdiv_rn(qz, v)));

  // 1-2. Probe, key and count of neighbour voxel j = lane.
  int slot = 0, cnt = 0;
  if (lane < 27) {
    const int cx = add_wrap(vx, shift_of(lane / 9));
    const int cy = add_wrap(vy, shift_of((lane / 3) % 3));
    const int cz = add_wrap(vz, shift_of(lane % 3));
    const uint32_t h = hash_coords(cx, cy, cz);
    uint32_t f = mix32(h ^ 0x9E3779B9u);
    if (f == 0u) f = 1u;
    const int row = row_bits > 0 ? static_cast<int>(h >> (32 - row_bits)) : 0;
    const int s = probe_window(fprints, row << probe_shift, probe_len,
                               static_cast<int>(f), vec_probe != 0);
    if (s >= 0) {
      const int* key = vkeys + 3 * static_cast<int64_t>(s);
      const int kx = key[0], ky = key[1], kz = key[2];
      const int c = counts[s];
      if (kx == cx && ky == cy && kz == cz) {
        slot = s;
        cnt = min(max(c, 0), p);
      }
    }
  }

  // 3. Flat candidate list: inclusive prefix sum of the counts over lanes.
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += x;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int excl = incl - cnt;

  float best = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
  int bt = 0x7fffffff;
  for (int t0 = 0; t0 < total; t0 += 32 * kU) {
    float px[kU], py[kU], pz[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + 32 * u + lane;
      // Owner voxel j of candidate t: the number of lanes whose inclusive
      // prefix is <= t (lanes 27-31 hold `total`, so j <= 26 when t < total).
      int j = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kFull, incl, j + step - 1) <= t) j += step;
      const int os = __shfl_sync(kFull, slot, j);
      const int oe = __shfl_sync(kFull, excl, j);
      px[u] = py[u] = pz[u] = 0.f;
      if (t < total) {
        const int64_t e = (static_cast<int64_t>(os) * p + (t - oe)) * 3;
        if (kU16) {
          const uint16_t* pts = static_cast<const uint16_t*>(points_raw);
          const float cornx = __fmul_rn(static_cast<float>(add_wrap(vx, shift_of(j / 9))), v);
          const float corny =
              __fmul_rn(static_cast<float>(add_wrap(vy, shift_of((j / 3) % 3))), v);
          const float cornz = __fmul_rn(static_cast<float>(add_wrap(vz, shift_of(j % 3))), v);
          px[u] = __fadd_rn(__fmul_rn(static_cast<float>(pts[e]), dec), cornx);
          py[u] = __fadd_rn(__fmul_rn(static_cast<float>(pts[e + 1]), dec), corny);
          pz[u] = __fadd_rn(__fmul_rn(static_cast<float>(pts[e + 2]), dec), cornz);
        } else {
          const float* pts = static_cast<const float*>(points_raw);
          px[u] = pts[e];
          py[u] = pts[e + 1];
          pz[u] = pts[e + 2];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + 32 * u + lane;
      const float dx = __fsub_rn(qx, px[u]), dy = __fsub_rn(qy, py[u]),
                  dz = __fsub_rn(qz, pz[u]);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      // The plain version's argmin takes a NaN d2 (a NaN query or stored
      // point) as the minimum: it enters the min as the key -1, below every
      // real d2. A lane's candidates come in increasing t: strict < keeps
      // the lowest.
      const float key = isnan(d2) ? -1.f : d2;
      if (t < total && key < best) {
        best = key;
        bt = t;
        bx = px[u];
        by = py[u];
        bz = pz[u];
      }
    }
  }

  // 4. Lexicographic (key, t) min over the warp: the lowest t wins a tie.
  // Only the pair travels; every lane ends with the winner, and the one lane
  // that holds candidate t (t values are distinct) writes its point.
  float wbest = best;
  int wt = bt;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, wbest, off);
    const int ot = __shfl_xor_sync(kFull, wt, off);
    if (od < wbest || (od == wbest && ot < wt)) {
      wbest = od;
      wt = ot;
    }
  }
  // A NaN won: the distance is NaN and nothing is found.
  if (wbest < 0.f) wbest = __int_as_float(0x7fffffff);
  const bool has = wbest < INFINITY;
  if (has ? bt == wt : lane == 0) {
    float* o = out_nn + 3 * static_cast<int64_t>(q);
    o[0] = has ? bx : 0.f;
    o[1] = has ? by : 0.f;
    o[2] = has ? bz : 0.f;
    out_dist[q] = __fsqrt_rn(wbest);
    out_found[q] = has && qvalid;
  }
}

}  // namespace

extern "C" int kiss_nn27(const void* queries, const void* valid, int n, const void* vkeys,
                         const void* fprints, const void* counts, const void* points,
                         int quantized, int p, int probe_len, int probe_shift,
                         int row_bits, float v, float dec, int vec_probe, void* out_nn,
                         void* out_dist, void* out_found, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 threads(kWarpsPerBlock * 32);
  const float* q = static_cast<const float*>(queries);
  const bool* va = static_cast<const bool*>(valid);
  const int* vk = static_cast<const int*>(vkeys);
  const int* fpr = static_cast<const int*>(fprints);
  const int* cn = static_cast<const int*>(counts);
  float* nn = static_cast<float*>(out_nn);
  float* dist = static_cast<float*>(out_dist);
  bool* fo = static_cast<bool*>(out_found);
  if (quantized) {
    nn27_kernel<true><<<blocks, threads, 0, s>>>(q, va, n, vk, fpr, cn, points, p,
                                                 probe_len, probe_shift, row_bits, v,
                                                 dec, vec_probe, nn, dist, fo);
  } else {
    nn27_kernel<false><<<blocks, threads, 0, s>>>(q, va, n, vk, fpr, cn, points, p,
                                                  probe_len, probe_shift, row_bits, v,
                                                  dec, vec_probe, nn, dist, fo);
  }
  return static_cast<int>(cudaGetLastError());
}
