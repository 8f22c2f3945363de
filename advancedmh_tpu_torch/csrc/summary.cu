// Every statistic of Chains.summary() from one pass over the draws.
//
// Replaces no Pallas kernel: the JAX package computes its summary with plain
// jnp (advancedmh_tpu/output/chains.py), one reduction a statistic. On the
// card that was five reduction passes and a split copy per parameter, each
// read back to the host. Here two kernels do it, and the host reads their
// (P, 7) table once. The plain PyTorch versions are
// ops/summary.py::chain_moments_reference and summary_finish_reference; the C
// entry points at the end are bound there with ctypes.
//
// chain_moments_kernel reads the draws x (N, P, C) where they lie (any row
// and parameter stride, chains contiguous) and writes, for each parameter p
// and chain c, the sum and the centred second moment of three row ranges,
// [0, h), [h, 2h) and the odd last row [2h, N) (h = N / 2, R-hat's split),
// as moments[p][range][sum, M2][c] in float64, and the chain's float32 mean
// over all N rows, which autocov.cu centres the lag window with. Each
// half's deviations are taken, exactly in float64, from the half's first
// row, so a constant half gives M2 = 0 and its mean exactly.
//
// What bounds it on this card: one read of the P N C floats (524 MB at 4000 x
// 2 x 16384: 0.156 ms at 3.35 TB/s); its 4 float64 operations a draw come to
// 0.03 ms at the card's float64 rate. Design: a block takes 64 neighbouring
// chains (256 B of a row, two coalesced warp loads) of one parameter (past
// 65535 parameters, the grid's y, of every 65535-th in turn) and
// splits each half into 4 row parts, one warp pair a part, 512 threads;
// each thread keeps 8 loads in flight (2 blocks an SM: 32 KB in flight an
// SM). The 4 parts of a half are added in a fixed order in shared memory: no
// atomics, two launches give the same bits.
//
// summary_finish_kernel takes the moments, the means and each parameter's
// lag-window sums S_k (autocov.cu) and writes the (P, 7) float64 table
// mean, std, naive_se, ess, mcse, rhat, decided: one block a parameter,
// fixed-order float64 trees over the C chains (512 threads: 1024 held a
// thread to 64 registers and spilled 28 bytes). ESS is diagnostics/ess.py's
// window (Geyer's sequence, a NaN pair sum counting as 0, tau floored at
// 1e-6, the ESS rounded to float32 as there; `decided` false where the
// sequence runs past the window), mcse = std / sqrt(ess), R-hat split-chain.

#include "common.cuh"

namespace amh {

constexpr int kSmChains = 64;                          // chains a block
constexpr int kSmParts = 4;                            // row parts of each half
constexpr int kSmThreads = kSmChains * 2 * kSmParts;   // 512
constexpr int kSmUnroll = 8;                           // loads in flight a thread
constexpr int kSfThreads = 512;                        // a finishing block
constexpr int kSfMaxLags = 256;
constexpr int kColumns = 7;

__global__ void __launch_bounds__(kSmThreads, 2)
chain_moments_kernel(const float* __restrict__ x, int64_t row_stride, int64_t param_stride,
                     int64_t N, int64_t P, int64_t C, double* __restrict__ moments,
                     float* __restrict__ means) {
  __shared__ double part_s1[2 * kSmParts][kSmChains];
  __shared__ double part_s2[2 * kSmParts][kSmChains];
  __shared__ double half_sum[2][kSmChains];
  const int lane = threadIdx.x % kSmChains;
  const int g = threadIdx.x / kSmChains;  // half g / kSmParts, part g % kSmParts
  const int half = g / kSmParts;
  const int64_t c = (int64_t)blockIdx.x * kSmChains + lane;
  const int64_t h = N / 2;
  const int64_t len = (h + kSmParts - 1) / kSmParts;
  const int64_t first = half * h;  // the half's first row, its shift
  const int64_t r0 = first + min((int64_t)(g % kSmParts) * len, h);
  const int64_t r1 = first + min((int64_t)(g % kSmParts + 1) * len, h);

  // The grid's y covers at most 65535 parameters: a block takes every
  // gridDim.y-th. The loop is the same for every thread of the block.
  for (int64_t p = blockIdx.y; p < P; p += gridDim.y) {
    const float* col = x + p * param_stride + c;

    // Deviations from the half's first row, exact in float64.
    double s1 = 0.0, s2 = 0.0, k = 0.0;
    if (c < C && h > 0) {
      k = (double)col[first * row_stride];
      const float* q = col + r0 * row_stride;
      int64_t n = r1 - r0;
      for (; n >= kSmUnroll; n -= kSmUnroll) {
        float v[kSmUnroll];
#pragma unroll
        for (int u = 0; u < kSmUnroll; ++u) v[u] = __ldcs(q + u * row_stride);
        q += kSmUnroll * row_stride;
#pragma unroll
        for (int u = 0; u < kSmUnroll; ++u) {
          const double d = (double)v[u] - k;
          s1 += d;
          s2 = fma(d, d, s2);
        }
      }
      for (; n > 0; --n, q += row_stride) {
        const double d = (double)*q - k;
        s1 += d;
        s2 = fma(d, d, s2);
      }
    }
    part_s1[g][lane] = s1;
    part_s2[g][lane] = s2;
    __syncthreads();

    // The first part's thread of each half adds the half's parts in order.
    if (g % kSmParts == 0 && c < C) {
      double a = 0.0, b = 0.0;
#pragma unroll
      for (int q = 0; q < kSmParts; ++q) {
        a += part_s1[g + q][lane];
        b += part_s2[g + q][lane];
      }
      const double sum = h > 0 ? (double)h * k + a : 0.0;
      const double m2 = h > 0 ? b - a * a / (double)h : 0.0;
      double* out = moments + (p * 3 + half) * 2 * C + c;
      out[0] = sum;
      out[C] = m2;
      half_sum[half][lane] = sum;
    }
    __syncthreads();

    // The odd last row, and the chain's mean over all N rows. The next
    // parameter's first __syncthreads orders these reads of half_sum
    // before its writes.
    if (g == 0 && c < C) {
      const double last = (N & 1) ? (double)col[(N - 1) * row_stride] : 0.0;
      double* out = moments + (p * 3 + 2) * 2 * C + c;
      out[0] = last;
      out[C] = 0.0;
      means[p * C + c] = (float)((half_sum[0][lane] + half_sum[1][lane] + last) / (double)N);
    }
  }
}

// The sums over a block of v[j] of every thread, for each j < kVals, as a
// fixed tree: the same order at every launch.
template <int kVals>
__device__ __forceinline__ void block_sums(double (&v)[kVals], double (*buf)[kSfThreads]) {
#pragma unroll
  for (int j = 0; j < kVals; ++j) buf[j][threadIdx.x] = v[j];
  __syncthreads();
  for (int s = kSfThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int j = 0; j < kVals; ++j) buf[j][threadIdx.x] += buf[j][threadIdx.x + s];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kVals; ++j) v[j] = buf[j][0];
  __syncthreads();
}

__global__ void __launch_bounds__(kSfThreads)
summary_finish_kernel(const double* __restrict__ moments, const float* __restrict__ means,
                      const double* __restrict__ acov, int64_t N, int64_t C, int K,
                      double* __restrict__ out) {
  __shared__ double buf[4][kSfThreads];
  __shared__ double rho[kSfMaxLags];
  const int64_t p = blockIdx.x;
  const double* sum0 = moments + p * 6 * C;  // [range][sum, M2][c]
  const double* m2_0 = sum0 + C;
  const double* sum1 = sum0 + 2 * C;
  const double* m2_1 = sum0 + 3 * C;
  const double* sum2 = sum0 + 4 * C;
  const double* m2_2 = sum0 + 5 * C;
  const float* m = means + p * C;
  const double h = (double)(N / 2), n2 = (double)(N - 2 * (N / 2));
  const double n = (double)N, nc = (double)N * (double)C, c2 = 2.0 * (double)C;
  // The loops multiply by reciprocals: a float64 division costs tens of
  // instructions, and these blocks are one a parameter.
  const double inv_h = 1.0 / h, inv_h1 = 1.0 / (h - 1.0);

  // Pass 1: the grand total, the half-chains' means and variances, the
  // float32 chain means.
  double a[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t c = threadIdx.x; c < C; c += kSfThreads) {
    a[0] += sum0[c] + sum1[c] + sum2[c];
    a[1] += sum0[c] * inv_h + sum1[c] * inv_h;
    a[2] += m2_0[c] * inv_h1 + m2_1[c] * inv_h1;
    a[3] += (double)m[c];
  }
  block_sums<4>(a, buf);
  const double grand = a[0] / nc, half_mean = a[1] / c2, within = a[2] / c2;
  const double mean_of_means = a[3] / (double)C;

  // Pass 2: the second moment about the grand mean, the half means' and the
  // chain means' spread.
  double b[3] = {0.0, 0.0, 0.0};
  for (int64_t c = threadIdx.x; c < C; c += kSfThreads) {
    const double hm0 = sum0[c] * inv_h, hm1 = sum1[c] * inv_h;
    if (h > 0.0) {
      const double d0 = hm0 - grand, d1 = hm1 - grand;
      b[0] += m2_0[c] + m2_1[c] + h * d0 * d0 + h * d1 * d1;
    }
    if (n2 > 0.0) {
      const double d2 = sum2[c] - grand;
      b[0] += m2_2[c] + d2 * d2;
    }
    const double e0 = hm0 - half_mean, e1 = hm1 - half_mean;
    b[1] += e0 * e0 + e1 * e1;
    const double e = (double)m[c] - mean_of_means;
    b[2] += e * e;
  }
  block_sums<3>(b, buf);

  // The window's autocorrelations, one lag a thread, as diagnostics/ess.py
  // forms them.
  const double mean_var = acov[p * K] / nc * n / (n - 1.0);
  double var_plus = mean_var * (n - 1.0) / n;
  if (C > 1) var_plus += b[2] / ((double)C - 1.0);
  if (threadIdx.x < K) {
    rho[threadIdx.x] = 1.0 - (mean_var - acov[p * K + threadIdx.x] / nc) / var_plus;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // Geyer's paired sums, their running min (NaN stays NaN, as torch.cummin
    // keeps it), a NaN or non-positive pair adding 0.
    const int64_t n_pairs = N / 2 < K / 2 ? N / 2 : K / 2;
    double run = 0.0, total = 0.0;
    for (int64_t i = 0; i < n_pairs; ++i) {
      const double s = rho[2 * i] + rho[2 * i + 1];
      run = i == 0 ? s : (isnan(run) || isnan(s) ? s + run : fmin(run, s));
      total += run > 0.0 ? run : 0.0;
    }
    double tau = 2.0 * total - 1.0;
    tau = tau < 1e-6 ? 1e-6 : tau;
    const double ess = (double)(float)(nc / tau);
    const bool decided = 2 * (N / 2) <= K || !(run > 0.0);
    const double std = sqrt(b[0] / nc);
    const double between = h * (b[1] / (c2 - 1.0));
    const double rhat_plus = (h - 1.0) / h * within + between / h;
    double* row = out + p * kColumns;
    row[0] = grand;
    row[1] = std;
    row[2] = std / sqrt(nc);
    row[3] = ess;
    row[4] = std / sqrt(ess);
    row[5] = sqrt(rhat_plus / within);
    row[6] = decided ? 1.0 : 0.0;
  }
}

inline int64_t moments_grid_x(int64_t C) { return (C + kSmChains - 1) / kSmChains; }

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------

extern "C" {

// moments (P, 3, 2, C) float64 and means (P, C) float32 of draws x (N, P, C)
// with rows row_stride and parameters param_stride floats apart.
int amh_chain_moments(const void* x, int64_t row_stride, int64_t param_stride, int64_t N,
                      int64_t P, int64_t C, void* moments, void* means, void* stream) {
  if (N < 1 || P < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t gx = amh::moments_grid_x(C);
  if (gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const unsigned gy = (unsigned)(P < 65535 ? P : 65535);
  amh::chain_moments_kernel<<<dim3((unsigned)gx, gy), amh::kSmThreads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)x, row_stride, param_stride, N, P, C, (double*)moments, (float*)means);
  return (int)cudaGetLastError();
}

// out (P, 7) float64 from the moments, the means and acov (P, K) float64,
// the lag-window sums of each parameter.
int amh_summary_finish(const void* moments, const void* means, const void* acov, int64_t N,
                       int64_t P, int64_t C, int32_t K, void* out, void* stream) {
  if (N < 1 || P < 1 || C < 1 || K < 1 || K > amh::kSfMaxLags || K > N || P > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  amh::summary_finish_kernel<<<(unsigned)P, amh::kSfThreads, 0, (cudaStream_t)stream>>>(
      (const double*)moments, (const float*)means, (const double*)acov, N, C, K,
      (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
