// Replica-exchange (parallel tempering) kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_tempering.py::_tempering_kernel: burn-in,
// then n_samples thinned draws of a ladder of K tempered random-walk replicas
// per chain plus the even-odd swap sweep; the cold replica (beta_0 = 1) is
// emitted. The plain PyTorch version is
// ops/tempering.py::tempering_sample_reference; the C entry point at the end
// is bound there with ctypes.
//
// The kernel carries the raw log density ell_k of every replica (not the
// tempered beta_k ell_k) and tempers where it is used. A step of a chain:
//   1. for k = 0..K-1: y = x_k + s_k * z (s_k the replica's per-dimension
//      scale), accept iff log u_k < beta_k (ell(y) - ell_k);
//   2. the swap sweep, pairs (k, k+1) with k even, then k odd:
//      log alpha = (beta_k - beta_{k+1}) (ell_{k+1} - ell_k), swap the two
//      replicas' positions and ell iff log u < log alpha, count the accept.
// A swap is a select, not the Pallas kernel's blend m b + (1 - m) a: with a
// replica at ell = -inf (a chain started outside the support) the blend's
// 0 * (-inf) is NaN. beta_k - beta_{k+1} is taken in float64 and rounded
// once, as the Pallas kernel's Python constants are. Proposal counts are one
// per pair and step, so only accepts are counted here.
//
// Noise of absolute step j of chain c (common.cuh::StepWords, P = ceil(d/2)):
// replica k reads its normals from words k (2P + 1) .. k (2P + 1) + 2P - 1
// and its accept uniform from word k (2P + 1) + 2P; the swap of pair
// (k, k+1) reads word K (2P + 1) + k.
//
// Layout: chains on the last axis. Replica k's position is rows k d ..
// k d + d - 1 of x (K d, C), its ell row k of (K, C); emitted (N, d, C) and
// (N, 1, C) (lp = ell_0, the cold replica's untempered density; accepted =
// the cold replica's move of the last step before the draw, before the
// swaps); the final ladder x (K d, C), ell (K, C) and this launch's swap
// accepts (K - 1, C). One thread runs one chain; its ladder (K d <= 64
// floats, as the Pallas kernel's limit) is indexed by the runtime K and so
// lives in thread-local memory, cached in L1. Shared memory holds the
// density's constants, beta (K), beta_k - beta_{k+1} (K - 1) and the
// per-replica scales (K d).
//
// What bounds it on this card: K densities, K Box-Muller sets and K logf a
// chain-step plus K - 1 swap tests -- a dependent chain per thread,
// latency-bound at 16384 chains; the emission's bytes set a bound far below.
//
// Numerics: --fmad=false, no --use_fast_math, as the other kernels.

#include "common.cuh"

namespace amh {

constexpr int kTemperBlock = 64;

template <class Density>
struct Ladder {
  static constexpr int D = Density::kDim;
  static constexpr int kMaxK = 64 / D;
  float x[kMaxK * D];
  float ell[kMaxK];
  float sw[kMaxK];
};

// One step of the ladder; returns the cold replica's move decision.
template <class Density>
__device__ __forceinline__ bool tempering_step(Ladder<Density>& L, int K, const float* betas,
                                               const float* dbetas, const float* scales,
                                               const float* consts, int n_consts, uint64_t j,
                                               uint32_t c, uint32_t k0, uint32_t k1) {
  constexpr int D = Density::kDim;
  constexpr int P = (D + 1) / 2;
  StepWords w(j, c, k0, k1);
  bool cold = false;
  for (int k = 0; k < K; ++k) {
    const int w0 = k * (2 * P + 1);
    float z[D], y[D];
    step_normals<D>(w, z, w0);
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] = L.x[k * D + i] + scales[k * D + i] * z[i];
    const float ell_y = Density::logp(y, consts, n_consts);
    const bool accept = logf(w.uniform(w0 + 2 * P)) < betas[k] * (ell_y - L.ell[k]);
    if (accept) {
#pragma unroll
      for (int i = 0; i < D; ++i) L.x[k * D + i] = y[i];
      L.ell[k] = ell_y;
    }
    if (k == 0) cold = accept;
  }
  const int s0 = K * (2 * P + 1);
  for (int parity = 0; parity < 2; ++parity) {
    for (int k = parity; k < K - 1; k += 2) {
      const float logalpha = dbetas[k] * (L.ell[k + 1] - L.ell[k]);
      if (logf(w.uniform(s0 + k)) < logalpha) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float a = L.x[k * D + i];
          L.x[k * D + i] = L.x[(k + 1) * D + i];
          L.x[(k + 1) * D + i] = a;
        }
        const float e = L.ell[k];
        L.ell[k] = L.ell[k + 1];
        L.ell[k + 1] = e;
        L.sw[k] = L.sw[k] + 1.0f;
      }
    }
  }
  return cold;
}

// Sample e is the cold replica after burn + (e+1)*thin steps; step t of the
// launch is absolute iteration offset + t (t = 1, 2, ...).
template <class Density>
__global__ void __launch_bounds__(kTemperBlock)
    tempering_sample_kernel(const float* __restrict__ x_in, const float* __restrict__ ell_in,
                            const float* __restrict__ betas_in,
                            const float* __restrict__ dbetas_in,
                            const float* __restrict__ scales_in,
                            const float* __restrict__ consts, int n_consts, int K, uint32_t k0,
                            uint32_t k1, int64_t burn, int64_t thin, int64_t n_samples,
                            uint64_t offset, int64_t C, float* __restrict__ samples,
                            float* __restrict__ lps, float* __restrict__ accs,
                            float* __restrict__ x_out, float* __restrict__ ell_out,
                            float* __restrict__ sw_out) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh[];
  float* betas = sh + n_consts;
  float* dbetas = betas + K;
  float* scales = dbetas + K;  // K - 1 used, one spare keeps the count simple
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x) sh[i] = consts[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    betas[i] = betas_in[i];
    if (i < K - 1) dbetas[i] = dbetas_in[i];
  }
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) scales[i] = scales_in[i];
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Ladder<Density> L;
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < D; ++i) L.x[k * D + i] = x_in[(k * D + i) * C + c];
    L.ell[k] = ell_in[k * C + c];
    L.sw[k] = 0.0f;
  }
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    tempering_step<Density>(L, K, betas, dbetas, scales, sh, n_consts, ++j, (uint32_t)c, k0,
                            k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool cold = false;
    for (int64_t t = 0; t < thin; ++t)
      cold = tempering_step<Density>(L, K, betas, dbetas, scales, sh, n_consts, ++j,
                                     (uint32_t)c, k0, k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = L.x[i];
    lps[e * C + c] = L.ell[0];
    accs[e * C + c] = cold ? 1.0f : 0.0f;
  }
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < D; ++i) x_out[(k * D + i) * C + c] = L.x[k * D + i];
    ell_out[k * C + c] = L.ell[k];
    if (k < K - 1) sw_out[k * C + c] = L.sw[k];
  }
}

template <class Density>
int launch_tempering(const float* x, const float* ell, const float* betas, const float* dbetas,
                     const float* scales, const float* consts, int n_consts, int K,
                     uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                     uint64_t offset, int64_t C, float* samples, float* lps, float* accs,
                     float* x_out, float* ell_out, float* sw_out, cudaStream_t stream) {
  if (K < 2 || K > Ladder<Density>::kMaxK) return (int)cudaErrorInvalidValue;
  const size_t smem = (n_consts + 2 * K + K * Density::kDim) * sizeof(float);
  const cudaError_t err = allow_shared(tempering_sample_kernel<Density>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kTemperBlock - 1) / kTemperBlock));
  tempering_sample_kernel<Density><<<grid, kTemperBlock, smem, stream>>>(
      x, ell, betas, dbetas, scales, consts, n_consts, K, (uint32_t)seed,
      (uint32_t)(seed >> 32), burn, thin, n_samples, offset, C, samples, lps, accs, x_out,
      ell_out, sw_out);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities the kernel is instantiated for: the one list of the pairs
// (see csrc/common.cuh).
#define AMH_TEMPERING_DENSITIES(X) \
  X(amh::GaussianMeanScale)        \
  X(amh::BimodalMixture)           \
  X(amh::CorrelatedGaussian<2>)

extern "C" {

int amh_tempering_sample(const char* density, int32_t d, const void* x, const void* ell,
                         const void* betas, const void* dbetas, const void* scales,
                         const void* consts, int32_t n_consts, int32_t K, uint64_t seed,
                         int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
                         int64_t C, void* samples, void* lps, void* accs, void* x_out,
                         void* ell_out, void* sw_out, void* stream) {
#define X(T)                                                                                 \
  if (amh::matches<T>(density, d))                                                           \
    return amh::launch_tempering<T>(                                                         \
        (const float*)x, (const float*)ell, (const float*)betas, (const float*)dbetas,       \
        (const float*)scales, (const float*)consts, n_consts, K, seed, burn, thin,           \
        n_samples, offset, C, (float*)samples, (float*)lps, (float*)accs, (float*)x_out,     \
        (float*)ell_out, (float*)sw_out, (cudaStream_t)stream);
  AMH_TEMPERING_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_tempering() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_TEMPERING_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
