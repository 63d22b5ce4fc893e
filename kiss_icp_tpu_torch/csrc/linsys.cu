// K1: robust point-to-point normal equations (J^T W J, J^T W r, count).
//
// Replaces the Pallas kernel kiss_icp_tpu/ops/pallas_kernels.py::
// _linsys_kernel (called by build_linear_system_pallas). Plain PyTorch
// version: kiss_icp_tpu_torch/ops/registration.py::build_linear_system.
//
// Per correspondence i with mask[i] set:
//   r = s - t, w = k^2 / (k + |r|^2)^2 (Geman-McClure), lever arm l = s - c,
//   J = [I3 | -hat(l)], and the products of w J^T with J and with r.
// The count comes from the mask, not from w > 0; masked points are skipped,
// so an all-masked input (or n = 0) gives exactly 0 and count 0.
//
// Accuracy: the off-diagonal lever-arm sums (w lx ly and the like) cancel
// heavily, so the order of an f32 sum moves them by more than the rtol
// 2e-5 the kernel is held to. The kernel therefore forms each point's
// factors as the plain version does, each rounded to f32 in its order
// (r, |r|^2, w, l, and wJ = w * J), and adds the products wJ * J and wJ * r,
// exact in f64, into f64 sums: 22 distinct ones (J^T W J is not exactly
// symmetric in f32, because w*l is rounded before it meets the other arm).
// The kernel thus sums the plain version's own products all but exactly,
// and differs from the plain version by little more than that version's
// own f32 rounding.
//
// What bounds it on the H100: nothing the card is short of. A call reads
// about 25 B per point (two float3 and a bool: 0.2 MB at the main path's
// 8192 points, ~60 ns at the H100 SXM's published 3.35 TB/s) and does ~17
// f32 and ~46 f64 operations per point, so its time is launch latency plus
// the chain of steps inside.
// A second launch to combine per-block partials would add a whole launch
// latency; this is a single launch of one thread-block cluster of 8 blocks
// of 512 threads:
//   * each block stages a tile of 1024 points (2 a thread) of src, tgt and
//     mask in shared memory with 16 B loads (neighbouring threads,
//     neighbouring words), so a tile costs one round trip to memory; blocks
//     grid-stride over the tiles (at 8192 points each block takes one);
//   * per warp, a butterfly reduce-scatter of the 22 sums (padded to 32:
//     16+8+4+2+1 exchanges, instead of 22 x 5) leaves lane L holding sum L;
//     the count uses __reduce_add_sync;
//   * per block, the warps' sums are added in shared memory;
//   * across the cluster, each block writes its sums into block 0's shared
//     memory (distributed shared memory); one cluster barrier later block 0
//     adds them and writes the 6x6, the 6-vector and the count. The barrier
//     that makes block 0's memory safe to write is arrived at on entry and
//     waited for only before the write, so its latency hides behind the
//     loads.
// Warps and ranks are summed as fixed pairwise trees (4 and 3 dependent
// adds instead of 16 and 8), and k and the centre reach the threads through
// shared memory, so their loads issue with the tile's.
// Where the time goes (tools/kernel_anatomy.py, numbers in PERF.md): the
// f64 arithmetic and the warp reduction, done by 8 SMs only, take the
// largest share, then the exchange across the cluster, then the launch.
// Every sum is taken in a fixed order and there are no atomics: two launches
// on the same input give identical bits. No scratch memory, so the call is
// safe to capture in a CUDA graph.
//
// Batched entry (kiss_linsys_batched): B independent systems of n points
// each, rows stacked on a leading axis, in ONE launch of B clusters: cluster
// b is row b (blockIdx.x / kCluster) and runs exactly the single-row
// program on that row's slice, so row b's bits equal an unbatched launch on
// row b. A per-row `active` flag (B,) lets a lockstep Gauss-Newton loop
// skip its converged rows: an inactive row's cluster stages nothing and
// writes zeros (J^T W J = 0, J^T W r = 0, count 0). The unbatched entry is
// the kBatched = false instantiation: the single-row program exactly as it
// was, whose registers the row arithmetic does not touch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // blocks: the portable maximum cluster size
constexpr int kTile = 1024;  // points a block stages at once
constexpr int kSums = 22;    // distinct f64 sums (listed below)
constexpr unsigned kFull = 0xffffffffu;

// The 22 sums S of a point's products, with A, B, C = f32(w*lx), f32(w*ly),
// f32(w*lz) (the plain version's w*J entries):
//   S0 w, S1-3 w*l (x,y,z), S4-6 A B C, S7 A*lx, S8 B*ly, S9 C*lz,
//   S10 B*lx, S11 A*ly, S12 C*lx, S13 A*lz, S14 C*ly, S15 B*lz,
//   S16-18 w*r, S19 B*r2 - C*r1, S20 C*r0 - A*r2, S21 A*r1 - B*r0.
// write_outputs assembles J^T W J and J^T W r from them.

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One step of the butterfly reduce-scatter over lane bit S and the steps
// below it: after butterfly<16>, lane L holds sum L of v over the warp.
// Templated so that every index into v is a constant and v stays in
// registers.
template <int S>
__device__ __forceinline__ void butterfly(double (&v)[32], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const double send = upper ? v[i] : v[i + S];
    const double keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, S);
  }
  if constexpr (S > 1) butterfly<S / 2>(v, lane);
}

// J^T W J (row-major) and J^T W r from the sums S (see above), each
// rounded once to f32. J^T W J is not exactly symmetric: the plain version
// rounds w*l before it meets the other arm, and so do S10-S15.
__device__ __forceinline__ void write_outputs(const double* S, float* jtj, float* jtr) {
  jtj[0] = float(S[0]); jtj[1] = 0.f; jtj[2] = 0.f;
  jtj[3] = 0.f; jtj[4] = float(S[3]); jtj[5] = float(-S[2]);
  jtj[6] = 0.f; jtj[7] = float(S[0]); jtj[8] = 0.f;
  jtj[9] = float(-S[3]); jtj[10] = 0.f; jtj[11] = float(S[1]);
  jtj[12] = 0.f; jtj[13] = 0.f; jtj[14] = float(S[0]);
  jtj[15] = float(S[2]); jtj[16] = float(-S[1]); jtj[17] = 0.f;
  jtj[18] = 0.f; jtj[19] = float(-S[6]); jtj[20] = float(S[5]);
  jtj[21] = float(S[9] + S[8]); jtj[22] = float(-S[10]); jtj[23] = float(-S[12]);
  jtj[24] = float(S[6]); jtj[25] = 0.f; jtj[26] = float(-S[4]);
  jtj[27] = float(-S[11]); jtj[28] = float(S[9] + S[7]); jtj[29] = float(-S[14]);
  jtj[30] = float(-S[5]); jtj[31] = float(S[4]); jtj[32] = 0.f;
  jtj[33] = float(-S[13]); jtj[34] = float(-S[15]); jtj[35] = float(S[8] + S[7]);
#pragma unroll
  for (int t = 0; t < 6; ++t) jtr[t] = float(S[16 + t]);
}

// Sum of v[0], v[stride], ..., v[(N - 1) * stride] as a fixed pairwise tree.
template <int N>
__device__ __forceinline__ double tree_sum(const double* v, int stride) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    return tree_sum<N / 2>(v, stride) + tree_sum<N - N / 2>(v + (N / 2) * stride, stride);
  }
}

// Stage `m` points (3m floats) of src, tgt and their mask into shared memory.
__device__ __forceinline__ void stage_tile(const float* __restrict__ src,
                                           const float* __restrict__ tgt,
                                           const unsigned char* __restrict__ mask,
                                           int m, bool vec, float* s_src, float* s_tgt,
                                           unsigned char* s_mask) {
  const int words = 3 * m;
  if (vec) {  // src, tgt 16 B aligned, mask 4 B aligned (tile offsets keep it)
    constexpr int kWords = 3 * kTile / 4;  // float4 words of a tile
#pragma unroll
    for (int u = 0; u < (kWords + kThreads - 1) / kThreads; ++u) {  // all in flight at once
      const int w = threadIdx.x + u * kThreads;
      if (w >= kWords) break;
      if (4 * w + 4 <= words) {
        reinterpret_cast<float4*>(s_src)[w] = reinterpret_cast<const float4*>(src)[w];
        reinterpret_cast<float4*>(s_tgt)[w] = reinterpret_cast<const float4*>(tgt)[w];
      } else {
        for (int e = 4 * w; e < words; ++e) {
          s_src[e] = src[e];
          s_tgt[e] = tgt[e];
        }
      }
    }
    const int w = threadIdx.x;  // kTile / 4 mask words
    if (w < kTile / 4) {
      if (4 * w + 4 <= m) {
        reinterpret_cast<uchar4*>(s_mask)[w] = reinterpret_cast<const uchar4*>(mask)[w];
      } else {
        for (int e = 4 * w; e < m; ++e) s_mask[e] = mask[e];
      }
    }
  } else {
    for (int e = threadIdx.x; e < words; e += kThreads) {
      s_src[e] = src[e];
      s_tgt[e] = tgt[e];
    }
    for (int e = threadIdx.x; e < m; e += kThreads) s_mask[e] = mask[e];
  }
}

template <bool kBatched>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
linsys_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
              const unsigned char* __restrict__ mask, int n,  // n points a row
              const float* __restrict__ kernel_scale,  // [B]
              const float* __restrict__ center,        // [B][3]
              const unsigned char* __restrict__ active,  // [B] (batched only)
              int vec,
              float* __restrict__ out_jtj,             // [B][36] J^T W J, row-major
              float* __restrict__ out_jtr,             // [B][6] J^T W r
              int* __restrict__ out_count) {           // [B]
  // Blocks grid-stride over the tiles: unbatched, the whole grid is one
  // cluster; batched, cluster `row` (blockIdx.x / kCluster) serves row
  // `row` and its blocks stride over that row's tiles.
  int my_rank = blockIdx.x, ranks = gridDim.x;
  if constexpr (kBatched) {
    const int row = blockIdx.x / kCluster;
    my_rank = blockIdx.x % kCluster;
    ranks = kCluster;
    out_jtj += 36 * row;
    out_jtr += 6 * row;
    out_count += row;
    if (!active[row]) {
      // The whole cluster leaves before any cluster barrier; rank 0 writes
      // the zero system.
      if (my_rank == 0) {
        if (threadIdx.x < 36) out_jtj[threadIdx.x] = 0.f;
        if (threadIdx.x < 6) out_jtr[threadIdx.x] = 0.f;
        if (threadIdx.x == 0) *out_count = 0;
      }
      return;
    }
    const int64_t first = static_cast<int64_t>(row) * n;
    src += 3 * first;
    tgt += 3 * first;
    mask += first;
    kernel_scale += row;
    center += 3 * row;
  }
  __shared__ __align__(16) float s_src[3 * kTile];
  __shared__ __align__(16) float s_tgt[3 * kTile];
  __shared__ __align__(16) unsigned char s_mask[kTile];
  __shared__ double s_warp[kWarps][kSums];
  __shared__ int s_warp_count[kWarps];
  __shared__ double s_gather[kCluster][kSums];  // block 0's: every block's sums
  __shared__ int s_gather_count[kCluster];

  // Phase 1 of the cluster barrier: every block has started (so block 0's
  // shared memory exists) once all have arrived. Waited for before the
  // distributed-shared-memory writes below.
  cluster_arrive_relaxed();

  // The scalars go through shared memory, so that their loads issue with
  // the tile's and are not sunk past the barrier to their first use.
  __shared__ float s_scalars[4];  // k, center
  if (threadIdx.x < 4) s_scalars[threadIdx.x] = threadIdx.x ? center[threadIdx.x - 1] : kernel_scale[0];
  double acc[32];  // kSums sums, padded to a warp for the butterfly
#pragma unroll
  for (int t = 0; t < 32; ++t) acc[t] = 0.0;
  int count = 0;

  for (int64_t tile0 = static_cast<int64_t>(my_rank) * kTile; tile0 < n;
       tile0 += static_cast<int64_t>(ranks) * kTile) {
    const int64_t left = n - tile0;
    const int m = left < kTile ? static_cast<int>(left) : kTile;
    stage_tile(src + 3 * tile0, tgt + 3 * tile0, mask + tile0, m, vec != 0, s_src, s_tgt,
               s_mask);
    __syncthreads();
    const float k = s_scalars[0], cx = s_scalars[1], cy = s_scalars[2], cz = s_scalars[3];
    const float kk = __fmul_rn(k, k);
#pragma unroll
    for (int u = 0; u < kTile / kThreads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i >= m || !s_mask[i]) continue;
      ++count;
      // f32 factors, each rounded as the plain version rounds it.
      const float sx = s_src[3 * i], sy = s_src[3 * i + 1], sz = s_src[3 * i + 2];
      const float r0 = __fsub_rn(sx, s_tgt[3 * i]), r1 = __fsub_rn(sy, s_tgt[3 * i + 1]),
                  r2 = __fsub_rn(sz, s_tgt[3 * i + 2]);
      const float rr = __fadd_rn(__fadd_rn(__fmul_rn(r0, r0), __fmul_rn(r1, r1)),
                                 __fmul_rn(r2, r2));
      const float d = __fadd_rn(k, rr);
      const float w = __fdiv_rn(kk, __fmul_rn(d, d));
      // Lever arms about the sensor centre keep J^T J well conditioned.
      const float lx = __fsub_rn(sx, cx), ly = __fsub_rn(sy, cy), lz = __fsub_rn(sz, cz);
      const float fa = __fmul_rn(w, lx), fb = __fmul_rn(w, ly), fc = __fmul_rn(w, lz);
      // f64 products of two f32 values are exact.
      const double W = w, X = lx, Y = ly, Z = lz, A = fa, B = fb, C = fc;
      const double R0 = r0, R1 = r1, R2 = r2;
      acc[0] += W;
      acc[1] += W * X;
      acc[2] += W * Y;
      acc[3] += W * Z;
      acc[4] += A;
      acc[5] += B;
      acc[6] += C;
      acc[7] += A * X;
      acc[8] += B * Y;
      acc[9] += C * Z;
      acc[10] += B * X;
      acc[11] += A * Y;
      acc[12] += C * X;
      acc[13] += A * Z;
      acc[14] += C * Y;
      acc[15] += B * Z;
      acc[16] += W * R0;
      acc[17] += W * R1;
      acc[18] += W * R2;
      acc[19] += B * R2 - C * R1;
      acc[20] += C * R0 - A * R2;
      acc[21] += A * R1 - B * R0;
    }
    __syncthreads();  // the next tile overwrites the staged one
  }

  // Warp: butterfly reduce-scatter over the lane bits, so lane L ends with
  // sum L over all 32 lanes.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  butterfly<16>(acc, lane);
  count = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(count)));
  if (lane < kSums) s_warp[warp][lane] = acc[0];
  if (lane == 0) s_warp_count[warp] = count;
  __syncthreads();

  // Block: warps in index order, written into block 0's shared memory.
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  double bsum = 0.0;
  int bcount = 0;
  if (threadIdx.x < kSums) {
    bsum = tree_sum<kWarps>(&s_warp[0][threadIdx.x], kSums);
  } else if (threadIdx.x == kSums) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) bcount += s_warp_count[w];
  }
  cluster_wait();  // phase 1: block 0 is running
  if (threadIdx.x < kSums) {
    cluster.map_shared_rank(&s_gather[0][0], 0)[rank * kSums + threadIdx.x] = bsum;
  } else if (threadIdx.x == kSums) {
    cluster.map_shared_rank(s_gather_count, 0)[rank] = bcount;
  }
  cluster.sync();  // phase 2: every block's sums are in block 0
  if (rank != 0) return;

  // Block 0: the cluster's sums in rank order, then the outputs.
  __shared__ double s_total[kSums];
  if (threadIdx.x < kSums) {
    s_total[threadIdx.x] = tree_sum<kCluster>(&s_gather[0][threadIdx.x], kSums);
  } else if (threadIdx.x == kSums) {
    int c = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) c += s_gather_count[r];
    *out_count = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) write_outputs(s_total, out_jtj, out_jtr);
}

}  // namespace

// One launch: a single cluster of kCluster blocks.
extern "C" int kiss_linsys(const void* src, const void* tgt, const void* mask, int n,
                           const void* kernel_scale, const void* center, int vec,
                           void* jtj, void* jtr, void* count, void* stream) {
  linsys_kernel<false><<<kCluster, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const unsigned char*>(mask), n, static_cast<const float*>(kernel_scale),
      static_cast<const float*>(center), nullptr, vec, static_cast<float*>(jtj),
      static_cast<float*>(jtr), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// One launch for `rows` rows of n points: one cluster a row.
extern "C" int kiss_linsys_batched(const void* src, const void* tgt, const void* mask,
                                   int rows, int n, const void* kernel_scale,
                                   const void* center, const void* active, int vec,
                                   void* jtj, void* jtr, void* count, void* stream) {
  if (rows <= 0) return 0;
  linsys_kernel<true><<<kCluster * rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const unsigned char*>(mask), n, static_cast<const float*>(kernel_scale),
      static_cast<const float*>(center), static_cast<const unsigned char*>(active), vec,
      static_cast<float*>(jtj), static_cast<float*>(jtr), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
