// Chain-summed autocovariance over a window of lags, for summary()'s ESS.
//
// Replaces no Pallas kernel: the JAX package computes ESS with plain jnp
// (advancedmh_tpu/diagnostics/ess.py, an FFT autocovariance of every chain
// over all N lags). Geyer's initial monotone sequence reads the
// chain-averaged autocorrelation only up to its first non-positive pair, so
// diagnostics/ess.py asks this kernel for the first K lags alone and takes
// the FFT only where the sequence runs past them. The plain PyTorch version
// is ops/autocov.py::autocov_window_reference; the C entry points at the end
// are bound there with ctypes.
//
// For draws x (N, C) (any row stride, chains contiguous) and chain means m
// (C,), the two kernels give for each lag k < K
//     S_k = sum_c sum_{t < N - k} (x[t, c] - m_c) (x[t + k, c] - m_c)
// in float64.
//
// What bounds it on this card: 2 N C K float32 operations (1.68e10 at
// 4000 x 16384 and K = 128: 0.25 ms at 67 TFLOP/s) against one read of the
// N C floats (262 MB: 0.08 ms at 3.35 TB/s), so operations. Design: a block
// takes 64 neighbouring chains (256 B of a row, coalesced) and a slab of
// kAcSlab rows, and stages the slab with a halo of the next K rows, centred,
// in shared memory, by asynchronous copies that hold no register (zeros past
// N and past C, so the sums need no masks). Warp w owns lags 16 w .. 16 w +
// 15; each thread owns two neighbouring chains, read together by one 8-byte
// shared-memory load, and keeps their 2 x 16 running sums and a sliding
// window of 16 lagged pairs in registers, so a row costs two loads for 32
// fused multiply-adds (fmaf: the build's --fmad=false contracts nothing by
// itself). On an H100 this ran at 2.0x its bound, against 2.7x with one
// chain a thread and the slab loaded through registers, 2.3x with one chain
// a thread and the copies asynchronous, and 2.1-2.6x for larger or smaller
// slabs, 8 or 32 lags a warp, four chains a thread, double-buffered slabs
// or chain-major staging (PERF.md §6). Sums within a slab are float32; a
// block's partial of each lag, summed over its chains in a fixed butterfly
// order, is written in float64, and autocov_combine_kernel adds the blocks'
// partials of each lag in a fixed order in float64. No atomics: two
// launches give the same bits.

#include "common.cuh"

namespace amh {

constexpr int kAcPair = 2;               // chains a thread
constexpr int kAcChains = 32 * kAcPair;  // chains a block
constexpr int kAcLags = 16;              // lags a warp
constexpr int kAcSlab = 256;             // rows a block sums over
constexpr int kAcMaxLags = 256;          // 16 warps a block
constexpr int kAcCombine = 256;          // threads of a combining block

// A 4-byte asynchronous copy to shared memory (no register holds it on the
// way); src_bytes 0 writes a zero and reads nothing.
__device__ __forceinline__ void copy_async4(float* dst, const float* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kAcMaxLags / kAcLags * 32)
autocov_window_kernel(const float* __restrict__ x, int64_t row_stride,
                      const float* __restrict__ means, int64_t N, int64_t C,
                      int K, double* __restrict__ partials) {
  extern __shared__ float y[];  // (kAcSlab + 16 warps) rows x 64 chains
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int rows = kAcSlab + n_warps * kAcLags;
  const int64_t c0 = (int64_t)blockIdx.x * kAcChains;
  const int64_t t0 = (int64_t)blockIdx.y * kAcSlab;
  const int in_rows = (int)min((int64_t)rows, N - t0);  // rows of the slab before N

  // Thread (warp, lane) copies chains lane and lane + 32 of rows warp,
  // warp + n_warps, ...; then centres what it copied (past N it stays 0).
  for (int r = warp; r < rows; r += n_warps) {
#pragma unroll
    for (int v = 0; v < kAcPair; ++v) {
      const int64_t c = c0 + lane + 32 * v;
      const bool ok = c < C && r < in_rows;
      copy_async4(&y[r * kAcChains + lane + 32 * v], ok ? x + (t0 + r) * row_stride + c : x,
                  ok ? 4 : 0);
    }
  }
  float m[kAcPair];
#pragma unroll
  for (int v = 0; v < kAcPair; ++v) {
    const int64_t c = c0 + lane + 32 * v;
    m[v] = c < C ? means[c] : 0.0f;
  }
  copy_async_wait_all();
  for (int r = warp; r < in_rows; r += n_warps) {
#pragma unroll
    for (int v = 0; v < kAcPair; ++v) y[r * kAcChains + lane + 32 * v] -= m[v];
  }
  __syncthreads();

  // The sums read chains 2 lane and 2 lane + 1 of a row as one float2.
  const float2* col = reinterpret_cast<const float2*>(y) + lane;  // row r at col[32 r]
  const int k0 = warp * kAcLags;
  float acc[kAcPair][kAcLags];
  float2 w[kAcLags];
#pragma unroll
  for (int l = 0; l < kAcLags; ++l) {
    acc[0][l] = acc[1][l] = 0.0f;
    w[l] = col[(k0 + l) * 32];
  }
  // At row t + u, w[(u + l) % 16] holds the row t + u + k0 + l; the load
  // after the sums brings the row t + u + k0 + 16 into the slot just freed.
  const float2* b_col = col + (k0 + kAcLags) * 32;
  for (int t = 0; t < kAcSlab; t += kAcLags) {
#pragma unroll
    for (int u = 0; u < kAcLags; ++u) {
      const float2 a = col[(t + u) * 32];
#pragma unroll
      for (int l = 0; l < kAcLags; ++l) {
        const float2 b = w[(u + l) % kAcLags];
        acc[0][l] = fmaf(a.x, b.x, acc[0][l]);
        acc[1][l] = fmaf(a.y, b.y, acc[1][l]);
      }
      w[u] = b_col[(t + u) * 32];
    }
  }

  const int64_t n_blocks = (int64_t)gridDim.x * gridDim.y;
  const int64_t block = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
  for (int l = 0; l < kAcLags; ++l) {
    double s = (double)acc[0][l] + (double)acc[1][l];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == l && k0 + l < K) partials[(int64_t)(k0 + l) * n_blocks + block] = s;
  }
}

// One block a lag: thread i adds partials i, i + 256, ... in order, then the
// block adds the 256 sums as a fixed tree.
__global__ void __launch_bounds__(kAcCombine)
autocov_combine_kernel(const double* __restrict__ partials, int64_t n_blocks,
                       double* __restrict__ out) {
  __shared__ double buf[kAcCombine];
  const double* p = partials + (int64_t)blockIdx.x * n_blocks;
  double s = 0.0;
  for (int64_t b = threadIdx.x; b < n_blocks; b += kAcCombine) s += p[b];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int h = kAcCombine / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) buf[threadIdx.x] += buf[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}

inline int64_t autocov_grid_x(int64_t C) { return (C + kAcChains - 1) / kAcChains; }
inline int64_t autocov_grid_y(int64_t N) { return (N + kAcSlab - 1) / kAcSlab; }

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------

extern "C" {

// Blocks of a launch over N rows and C chains: the partials' second axis.
int64_t amh_autocov_blocks(int64_t N, int64_t C) {
  return amh::autocov_grid_x(C) * amh::autocov_grid_y(N);
}

// S_0 .. S_{K-1} into out (K float64); partials is (K, amh_autocov_blocks)
// float64 scratch.
int amh_autocov_window(const void* x, int64_t row_stride, const void* means,
                       int64_t N, int64_t C, int32_t K, void* partials, void* out,
                       void* stream) {
  if (N < 1 || C < 1 || K < 1 || K > amh::kAcMaxLags) return (int)cudaErrorInvalidValue;
  const int64_t gx = amh::autocov_grid_x(C), gy = amh::autocov_grid_y(N);
  if (gy > 65535 || gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int warps = (K + amh::kAcLags - 1) / amh::kAcLags;
  const size_t smem =
      (size_t)(amh::kAcSlab + warps * amh::kAcLags) * amh::kAcChains * sizeof(float);
  cudaError_t err = amh::allow_shared(amh::autocov_window_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  amh::autocov_window_kernel<<<dim3((unsigned)gx, (unsigned)gy), warps * 32, smem, s>>>(
      (const float*)x, row_stride, (const float*)means, N, C, K, (double*)partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  amh::autocov_combine_kernel<<<K, amh::kAcCombine, 0, s>>>((const double*)partials,
                                                            gx * gy, (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
