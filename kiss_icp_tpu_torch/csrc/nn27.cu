// K2: the whole 27-voxel nearest-neighbour query against the voxel hash map.
//
// Replaces the Pallas kernel kiss_icp_tpu/ops/pallas_nn.py::_candidate_kernel
// (called by evaluate_candidates / query_nearest_fused) together with the
// XLA fingerprint probe and point-row gather the TPU had to run around it
// (Mosaic has no vector gather). Plain PyTorch version:
// kiss_icp_tpu_torch/ops/hash_map.py::query_nearest, which this kernel
// matches bit for bit.
//
// One warp per query; lane j < 27 takes neighbour voxel j, in the order of
// hash_map._NEIGHBOR_SHIFTS ({0, 1, -1} per axis, x slowest):
//   voxel = floor(q / v) + SHIFT[j]; fingerprint and probe-window row from
//   the same uint32 hash as hash_map.py; scan the aligned window of
//   `probe_len` slots, first fingerprint match wins; check the exact key;
//   read the count, then only that many points of the row (an absent
//   neighbour reads no row at all); decode (u16: stored * (v/65535) +
//   voxel * v); d2 = (dx^2 + dy^2) + dz^2; running min with strict <, so
//   the lowest lane wins within the voxel.
// The warp then reduces (d2, j) lexicographically, so the lowest j wins a
// tie, as the plain version's flat argmin does.
//
// Bit-equality with the plain version: every float step is an explicit
// round-to-nearest intrinsic (no FMA contraction), in the plain version's
// order; the division is __fdiv_rn, never a reciprocal multiply.
//
// What bounds it on the H100: memory latency of dependent, data-driven
// reads, not bandwidth. Per query it touches 27 probe windows (64 B of
// fingerprints each), 27 keys and counts, and one row of count * 12 B per
// present neighbour: ~2-3 MB per 8192-query launch, while the fingerprint
// and key tables (2 MB + 6 MB at 2^19 slots) sit in the 50 MB L2. The
// design spreads the 27 independent probes of a query over the lanes of a
// warp, so 27x more loads are in flight than with one thread per query.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

template <bool kU16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
nn27_kernel(const float* __restrict__ queries, const bool* __restrict__ valid, int n,
            const int* __restrict__ vkeys, const int* __restrict__ fprints,
            const int* __restrict__ counts, const void* __restrict__ points_raw,
            int p, int probe_len, int probe_shift, int row_bits, float v, float dec,
            float* __restrict__ out_nn, float* __restrict__ out_dist,
            bool* __restrict__ out_found) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= n) return;  // whole warp exits together

  const float qx = queries[3 * q], qy = queries[3 * q + 1], qz = queries[3 * q + 2];
  float best = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
  const int j = lane;
  if (j < 27) {
    const int cx = add_wrap(static_cast<int>(floorf(__fdiv_rn(qx, v))), shift_of(j / 9));
    const int cy = add_wrap(static_cast<int>(floorf(__fdiv_rn(qy, v))), shift_of((j / 3) % 3));
    const int cz = add_wrap(static_cast<int>(floorf(__fdiv_rn(qz, v))), shift_of(j % 3));
    const uint32_t h = hash_coords(cx, cy, cz);
    uint32_t f = mix32(h ^ 0x9E3779B9u);
    if (f == 0u) f = 1u;
    const int fp = static_cast<int>(f);
    const int64_t row = row_bits > 0 ? static_cast<int64_t>(h >> (32 - row_bits)) : 0;
    const int64_t base = row << probe_shift;
    int64_t slot = -1;
    for (int s = 0; s < probe_len; ++s) {
      if (fprints[base + s] == fp) {
        slot = base + s;
        break;
      }
    }
    if (slot >= 0 && vkeys[3 * slot] == cx && vkeys[3 * slot + 1] == cy &&
        vkeys[3 * slot + 2] == cz) {
      const int cnt = min(counts[slot], p);
      const float cornx = __fmul_rn(static_cast<float>(cx), v);
      const float corny = __fmul_rn(static_cast<float>(cy), v);
      const float cornz = __fmul_rn(static_cast<float>(cz), v);
      for (int l = 0; l < cnt; ++l) {
        const int64_t e = (slot * p + l) * 3;
        float px, py, pz;
        if (kU16) {
          const uint16_t* pts = static_cast<const uint16_t*>(points_raw);
          px = __fadd_rn(__fmul_rn(static_cast<float>(pts[e]), dec), cornx);
          py = __fadd_rn(__fmul_rn(static_cast<float>(pts[e + 1]), dec), corny);
          pz = __fadd_rn(__fmul_rn(static_cast<float>(pts[e + 2]), dec), cornz);
        } else {
          const float* pts = static_cast<const float*>(points_raw);
          px = pts[e];
          py = pts[e + 1];
          pz = pts[e + 2];
        }
        const float dx = __fsub_rn(qx, px), dy = __fsub_rn(qy, py), dz = __fsub_rn(qz, pz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (d2 < best) {
          best = d2;
          bx = px;
          by = py;
          bz = pz;
        }
      }
    }
  }

  // Lexicographic (d2, j) min over the warp: the lowest j wins a tie.
  int bj = j;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_down_sync(0xffffffffu, best, off);
    const int oj = __shfl_down_sync(0xffffffffu, bj, off);
    const float ox = __shfl_down_sync(0xffffffffu, bx, off);
    const float oy = __shfl_down_sync(0xffffffffu, by, off);
    const float oz = __shfl_down_sync(0xffffffffu, bz, off);
    if (lane + off < 32 && (od < best || (od == best && oj < bj))) {
      best = od;
      bj = oj;
      bx = ox;
      by = oy;
      bz = oz;
    }
  }
  if (lane == 0) {
    const bool has = best < INFINITY;
    out_nn[3 * q] = has ? bx : 0.f;
    out_nn[3 * q + 1] = has ? by : 0.f;
    out_nn[3 * q + 2] = has ? bz : 0.f;
    out_dist[q] = __fsqrt_rn(best);
    out_found[q] = has && valid[q];
  }
}

}  // namespace

extern "C" int kiss_nn27(const void* queries, const void* valid, int n, const void* vkeys,
                         const void* fprints, const void* counts, const void* points,
                         int quantized, int p, int probe_len, int probe_shift,
                         int row_bits, float v, float dec, void* out_nn,
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
  bool* found = static_cast<bool*>(out_found);
  if (quantized) {
    nn27_kernel<true><<<blocks, threads, 0, s>>>(q, va, n, vk, fpr, cn, points, p,
                                                 probe_len, probe_shift, row_bits, v,
                                                 dec, nn, dist, found);
  } else {
    nn27_kernel<false><<<blocks, threads, 0, s>>>(q, va, n, vk, fpr, cn, points, p,
                                                  probe_len, probe_shift, row_bits, v,
                                                  dec, nn, dist, found);
  }
  return static_cast<int>(cudaGetLastError());
}
