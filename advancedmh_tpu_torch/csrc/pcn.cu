// Preconditioned Crank-Nicolson kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_pcn.py::_pcn_kernel: burn-in, then
// n_samples thinned draws of pCN for a target likelihood x N(m, Sigma) whose
// density (the functor) is the log-likelihood only:
//   x' = (m + rho (x - m)) + beta (L z)   (L z in IEEE float32, or sigma z),
//   accepted iff log u < lp(x') - lp(x),
// with rho = sqrt(1 - beta^2) rounded once from float64 by the caller. This
// is csrc/rwmh.cu's sampling kernel plus the contraction toward m; the noise
// of a step is RWMH's (d normals and the accept uniform, word 2P), each step
// from its own counter (the TPU kernel pairs two steps' normals from one
// Box-Muller draw, a layout choice not carried over). The plain PyTorch
// version is ops/pcn.py::pcn_sample_reference; the C entry point at the end
// is bound there with ctypes.
//
// Layout and design as csrc/rwmh.cu: chains on the last axis, one thread per
// chain with x and lp in registers, the last block masked. The density's
// constants, m and the prior's scale (the d x d factor: 16.4 KB at d = 64)
// sit in shared memory, read by every thread of a warp at one address. L z
// is formed in place of the normals (common.cuh::tril_matvec_inplace), so a
// step holds two d-vectors.
//
// What bounds it on this card: at d = 64 a step is the 2080 products and
// sums of L z, the d normals and one likelihood (64 points), a dependent
// chain per thread; latency-bound at 8192 chains (one 64-thread block per
// SM). The emission's bytes set a bound below.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py). The accept
// test is log u < lp' - lp, so a NaN candidate rejects.

#include "common.cuh"

namespace amh {

// 64 threads a block: 8192 chains make 128 blocks, one on each of 128 of the
// 132 SMs; 128-thread blocks would fill only 64 SMs (on an H100 the ESS
// kernel then ran 17-25% slower; the others within 5%).
constexpr int kPcnBlock = 64;

struct PcnConstants {
  float rho;   // sqrt(1 - beta^2)
  float beta;
};

// One pCN step; returns whether the proposal was accepted.
template <class Density, bool kTril>
__device__ __forceinline__ bool pcn_step(float (&x)[Density::kDim], float& lp,
                                         const float* mean, const float* scale,
                                         const PcnConstants& k, const float* consts,
                                         int n_consts, uint64_t j, uint32_t c,
                                         uint32_t k0, uint32_t k1) {
  constexpr int D = Density::kDim;
  constexpr int P = (D + 1) / 2;
  StepWords s(j, c, k0, k1);
  float y[D];  // the normals, then L z, then the proposal
  step_normals<D>(s, y);
  if (kTril) {
    tril_matvec_inplace<D>(scale, y);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] = scale[i] * y[i];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) y[i] = (mean[i] + k.rho * (x[i] - mean[i])) + k.beta * y[i];
  const float logu = logf(s.uniform(2 * P));
  const float lp_y = Density::logp(y, consts, n_consts);
  const bool accept = logu < lp_y - lp;
  if (accept) {
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = y[i];
    lp = lp_y;
  }
  return accept;
}

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...). Shared memory: the
// density's constants, then m (d), then the scale (d or d*d).
template <class Density, bool kTril>
__global__ void __launch_bounds__(kPcnBlock)
    pcn_sample_kernel(const float* __restrict__ params_t,
                      const float* __restrict__ lp_in, const float* __restrict__ mean,
                      const float* __restrict__ scale, const float* __restrict__ consts,
                      int n_consts, PcnConstants k, uint32_t k0, uint32_t k1,
                      int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
                      int64_t C, float* __restrict__ samples, float* __restrict__ lps,
                      float* __restrict__ accs) {
  constexpr int D = Density::kDim;
  constexpr int kScale = kTril ? D * D : D;
  extern __shared__ float sh[];
  float* sh_mean = sh + n_consts;
  float* sh_scale = sh_mean + D;
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x) sh[i] = consts[i];
  for (int i = threadIdx.x; i < D; i += blockDim.x) sh_mean[i] = mean[i];
  for (int i = threadIdx.x; i < kScale; i += blockDim.x) sh_scale[i] = scale[i];
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = params_t[i * C + c];
  float lp = lp_in[c];
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    pcn_step<Density, kTril>(x, lp, sh_mean, sh_scale, k, sh, n_consts, ++j, (uint32_t)c,
                             k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = pcn_step<Density, kTril>(x, lp, sh_mean, sh_scale, k, sh, n_consts, ++j,
                                          (uint32_t)c, k0, k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = x[i];
    lps[e * C + c] = lp;
    accs[e * C + c] = accepted ? 1.0f : 0.0f;
  }
}

template <class Density, bool kTril>
int launch_pcn(const float* params_t, const float* lp, const float* mean,
               const float* scale, const float* consts, int n_consts, PcnConstants k,
               uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
               uint64_t offset, int64_t C, float* samples, float* lps, float* accs,
               cudaStream_t stream) {
  constexpr int D = Density::kDim;
  const size_t smem = (n_consts + D + (kTril ? D * D : D)) * sizeof(float);
  const cudaError_t err = allow_shared(pcn_sample_kernel<Density, kTril>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kPcnBlock - 1) / kPcnBlock));
  pcn_sample_kernel<Density, kTril><<<grid, kPcnBlock, smem, stream>>>(
      params_t, lp, mean, scale, consts, n_consts, k, (uint32_t)seed,
      (uint32_t)(seed >> 32), burn, thin, n_samples, offset, C, samples, lps, accs);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The likelihoods the kernel is instantiated for (each with a diagonal and a
// lower-triangular prior scale): the one list of the pairs (see
// csrc/common.cuh).
#define AMH_PCN_DENSITIES(X)     \
  X(amh::GPRegression<16>)       \
  X(amh::GPRegression<64>)       \
  X(amh::GPClassification<16>)   \
  X(amh::GPClassification<64>)

extern "C" {

int amh_pcn_sample(const char* density, int32_t d, int32_t tril, const void* params_t,
                   const void* lp, const void* mean, const void* scale,
                   const void* consts, int32_t n_consts, float rho, float beta,
                   uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                   uint64_t offset, int64_t C, void* samples, void* lps, void* accs,
                   void* stream) {
  const amh::PcnConstants k{rho, beta};
#define X(T)                                                                       \
  if (amh::matches<T>(density, d))                                                 \
    return (tril ? amh::launch_pcn<T, true> : amh::launch_pcn<T, false>)(          \
        (const float*)params_t, (const float*)lp, (const float*)mean,              \
        (const float*)scale, (const float*)consts, n_consts, k, seed, burn, thin,  \
        n_samples, offset, C, (float*)samples, (float*)lps, (float*)accs,          \
        (cudaStream_t)stream);
  AMH_PCN_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_pcn() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_PCN_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
