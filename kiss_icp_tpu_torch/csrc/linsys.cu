// K1: robust point-to-point normal equations (J^T W J, J^T W r, count).
//
// Replaces the Pallas kernel kiss_icp_tpu/ops/pallas_kernels.py::
// _linsys_kernel (called by build_linear_system_pallas). Plain PyTorch
// version: kiss_icp_tpu_torch/ops/registration.py::build_linear_system.
//
// Per correspondence i with mask[i] set:
//   r = s - t, w = k^2 / (k + |r|^2)^2 (Geman-McClure), lever arm l = s - c,
//   J = [I3 | -hat(l)], and the 21 upper-triangle terms of w J^T J plus the
//   6 terms of w J^T r.
//
// What bounds it on the H100: nothing the card is short of. One launch reads
// about 25 B per point (two float3 and a bool: 0.2 MB at 8192 points, ~60 ns
// of HBM time) and does ~100 flops per point, so its time is the launch
// latency of two small kernels. The design therefore keeps the work in one
// pass over the points and spends no effort on bandwidth:
//   * pass 1: one thread per point (grid-stride) accumulates 27 f32 sums in
//     registers; each block reduces them with warp shuffles, then across
//     warps in shared memory, and writes one row of 27 partials + a count;
//   * pass 2: one block sums the partial rows in a fixed order and writes
//     the assembled 6x6 J^T W J, the 6-vector J^T W r and the count.
// No float atomics: two launches on the same input give identical bits.
// The count comes from the mask, not from w > 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTerms = 27;     // 21 upper-triangle J^T W J + 6 J^T W r
constexpr int kThreads = 256;  // threads per block of pass 1
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
linsys_partial_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                      const bool* __restrict__ mask, int n,
                      const float* __restrict__ kernel_scale,  // [1]
                      const float* __restrict__ center,        // [3]
                      float* __restrict__ partial,             // [gridDim.x][kTerms]
                      int* __restrict__ partial_count) {       // [gridDim.x]
  const float k = kernel_scale[0];
  const float cx = center[0], cy = center[1], cz = center[2];
  float acc[kTerms];
#pragma unroll
  for (int t = 0; t < kTerms; ++t) acc[t] = 0.f;
  int count = 0;

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (!mask[i]) continue;
    ++count;
    const float sx = src[3 * i], sy = src[3 * i + 1], sz = src[3 * i + 2];
    const float r[3] = {sx - tgt[3 * i], sy - tgt[3 * i + 1], sz - tgt[3 * i + 2]};
    const float r2 = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2];
    const float d = k + r2;
    const float w = (k * k) / (d * d);
    // Lever arms about the sensor centre keep J^T J well conditioned in f32.
    const float lx = sx - cx, ly = sy - cy, lz = sz - cz;
    // Rows of J = [I3 | -hat(l)], one per residual channel.
    const float J[3][6] = {{1.f, 0.f, 0.f, 0.f, lz, -ly},
                           {0.f, 1.f, 0.f, -lz, 0.f, lx},
                           {0.f, 0.f, 1.f, ly, -lx, 0.f}};
    int t = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) {
        const float jj = (J[0][a] * J[0][b] + J[1][a] * J[1][b]) + J[2][a] * J[2][b];
        acc[t++] += w * jj;
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float jr = (J[0][a] * r[0] + J[1][a] * r[1]) + J[2][a] * r[2];
      acc[21 + a] += w * jr;
    }
  }

  // Block reduction in a fixed order: shuffles within each warp, then warps
  // in index order.
  __shared__ float warp_sums[kWarps][kTerms];
  __shared__ int warp_counts[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
    float v = acc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][t] = v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    partial[blockIdx.x * kTerms + threadIdx.x] = s;
  }
  if (threadIdx.x == 0) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += warp_counts[w];
    partial_count[blockIdx.x] = c;
  }
}

// Upper-triangle index of (a, b), a <= b, in the order pass 1 writes them.
__device__ __forceinline__ int tri_index(int a, int b) {
  return a * 6 - (a * (a - 1)) / 2 + (b - a);
}

__global__ void linsys_final_kernel(const float* __restrict__ partial,
                                    const int* __restrict__ partial_count,
                                    int blocks,
                                    float* __restrict__ jtj,   // [36]
                                    float* __restrict__ jtr,   // [6]
                                    int* __restrict__ count) { // [1]
  __shared__ float sums[kTerms];
  const int t = threadIdx.x;
  if (t < kTerms) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[b * kTerms + t];
    sums[t] = s;
  }
  if (t == kTerms) {
    int c = 0;
    for (int b = 0; b < blocks; ++b) c += partial_count[b];
    *count = c;
  }
  __syncthreads();
  if (t < 36) {
    const int a = t / 6, b = t % 6;
    jtj[t] = sums[a <= b ? tri_index(a, b) : tri_index(b, a)];
  }
  if (t < 6) jtr[t] = sums[21 + t];
}

}  // namespace

extern "C" int kiss_linsys(const void* src, const void* tgt, const void* mask, int n,
                           const void* kernel_scale, const void* center, void* partial,
                           void* partial_count, int blocks, void* jtj, void* jtr,
                           void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  linsys_partial_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt),
      static_cast<const bool*>(mask), n, static_cast<const float*>(kernel_scale),
      static_cast<const float*>(center), static_cast<float*>(partial),
      static_cast<int*>(partial_count));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  linsys_final_kernel<<<1, 64, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const int*>(partial_count),
      blocks, static_cast<float*>(jtj), static_cast<float*>(jtr),
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
