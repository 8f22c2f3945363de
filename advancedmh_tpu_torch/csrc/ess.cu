// Elliptical slice sampling kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_ess.py::_ess_kernel: burn-in, then
// n_samples thinned draws of Murray, Adams & MacKay's elliptical slice
// sampler for a target likelihood x N(mu, Sigma) whose density (the
// functor) is the log-likelihood only:
//   nu - mu = L z (lower Cholesky L, IEEE float32) or sigma * z,
//   log y = lp + log U,  theta0 = 2 pi U_theta,  bracket [theta0 - 2 pi, theta0],
//   trip k: x' = (mu + (x - mu) cos theta) + (nu - mu) sin theta, accepted iff
//   lp(x') > log y (strict: false for NaN), else the rejected theta becomes
//   the bracket end on its own side of 0 and theta = tmin + U_k (tmax - tmin),
// for at most max_shrink trips; a chain that exhausts them keeps its state
// and reports accepted = 0. The plain PyTorch version is
// ops/ess.py::ess_sample_reference; the C entry point at the end is bound
// there with ctypes.
//
// Layout and design as csrc/rwmh.cu: chains on the last axis, one thread per
// chain, the last block masked. The density's constants, mu and the prior's
// scale (the d x d factor: 16.4 KB at d = 64) sit in shared memory. At
// d = 64 a step holds x, nu - mu and a candidate: 192 floats, more than a
// thread's 255 registers leave once the functor's needs are added. So the
// kernel carries no copy of the accepted point: it keeps the accepted theta
// and rebuilds (mu + (x - mu) cos theta) + (nu - mu) sin theta once after the
// loop, the same operations on the same inputs, hence the same bits; nu - mu
// is formed in place of the normals (common.cuh::tril_matvec_inplace). The
// trip loop ends at the first point in the slice (the TPU kernel runs all
// max_shrink trips because Mosaic runs data-dependent trip counts poorly);
// trip k's uniform is word 2P+2+k of the step's Philox stream
// (common.cuh::StepWords), so the trips a chain skips change nothing.
//
// What bounds it on this card: at d = 64 a step is the d(d+1)/2 products of
// L z, the trips' evaluations of the likelihood (4.2 a chain-step on the GP
// classification, 7.0 on the regression, 64 points each) and one cosf/sinf
// pair a trip, a dependent chain per thread: latency-bound at 8192 chains
// (one 64-thread block per SM), and a warp runs as many trips as its slowest
// chain. The emission's bytes (d + 2 floats a chain and draw) set a bound far
// below.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py); cosf and
// sinf are the accurate ones, as torch.cos and torch.sin.

#include "common.cuh"

namespace amh {

// 64 threads a block: 8192 chains make 128 blocks, one on each of 128 of the
// 132 SMs; 128-thread blocks would fill only 64 SMs (on an H100 the ESS
// kernel then ran 17-25% slower; the others within 5%).
constexpr int kEssBlock = 64;

// One elliptical slice step; returns whether the chain found a point in the
// slice. `loc` and `scale` are the prior's mean and scale in shared memory.
template <class Density, bool kTril>
__device__ __forceinline__ bool ess_step(float (&x)[Density::kDim], float& lp,
                                         const float* loc, const float* scale,
                                         int max_shrink, const float* consts,
                                         int n_consts, uint64_t j, uint32_t c,
                                         uint32_t k0, uint32_t k1) {
  constexpr int D = Density::kDim;
  constexpr int P = (D + 1) / 2;
  StepWords s(j, c, k0, k1);
  float nu[D];  // the normals, then nu - mu
  step_normals<D>(s, nu);
  if (kTril) {
    tril_matvec_inplace<D>(scale, nu);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) nu[i] = scale[i] * nu[i];
  }
  const float logy = lp + logf(s.uniform(2 * P));
  const float theta0 = kTwoPi * s.uniform(2 * P + 1);
  float theta = theta0, tmin = theta0 - kTwoPi, tmax = theta0;
  float cand[D];
  for (int trip = 0; trip < max_shrink; ++trip) {
    const float cs = cosf(theta), sn = sinf(theta);
#pragma unroll
    for (int i = 0; i < D; ++i) cand[i] = (loc[i] + (x[i] - loc[i]) * cs) + nu[i] * sn;
    const float lp_c = Density::logp(cand, consts, n_consts);
    if (lp_c > logy) {
      const float ca = cosf(theta), sa = sinf(theta);
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = (loc[i] + (x[i] - loc[i]) * ca) + nu[i] * sa;
      lp = lp_c;
      return true;
    }
    if (theta < 0.0f)
      tmin = theta;
    else
      tmax = theta;
    theta = tmin + s.uniform(2 * P + 2 + trip) * (tmax - tmin);
  }
  return false;
}

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...). Shared memory: the
// density's constants, then mu (d), then the scale (d or d*d).
template <class Density, bool kTril>
__global__ void __launch_bounds__(kEssBlock)
    ess_sample_kernel(const float* __restrict__ params_t,
                      const float* __restrict__ lp_in, const float* __restrict__ loc,
                      const float* __restrict__ scale, const float* __restrict__ consts,
                      int n_consts, int max_shrink, uint32_t k0, uint32_t k1,
                      int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
                      int64_t C, float* __restrict__ samples, float* __restrict__ lps,
                      float* __restrict__ accs) {
  constexpr int D = Density::kDim;
  constexpr int kScale = kTril ? D * D : D;
  extern __shared__ float sh[];
  float* sh_loc = sh + n_consts;
  float* sh_scale = sh_loc + D;
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x) sh[i] = consts[i];
  for (int i = threadIdx.x; i < D; i += blockDim.x) sh_loc[i] = loc[i];
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
    ess_step<Density, kTril>(x, lp, sh_loc, sh_scale, max_shrink, sh, n_consts, ++j,
                             (uint32_t)c, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool done = false;
    for (int64_t t = 0; t < thin; ++t)
      done = ess_step<Density, kTril>(x, lp, sh_loc, sh_scale, max_shrink, sh, n_consts,
                                      ++j, (uint32_t)c, k0, k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = x[i];
    lps[e * C + c] = lp;
    accs[e * C + c] = done ? 1.0f : 0.0f;
  }
}

template <class Density, bool kTril>
int launch_ess(const float* params_t, const float* lp, const float* loc,
               const float* scale, const float* consts, int n_consts, int max_shrink,
               uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
               uint64_t offset, int64_t C, float* samples, float* lps, float* accs,
               cudaStream_t stream) {
  constexpr int D = Density::kDim;
  const size_t smem = (n_consts + D + (kTril ? D * D : D)) * sizeof(float);
  const cudaError_t err = allow_shared(ess_sample_kernel<Density, kTril>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kEssBlock - 1) / kEssBlock));
  ess_sample_kernel<Density, kTril><<<grid, kEssBlock, smem, stream>>>(
      params_t, lp, loc, scale, consts, n_consts, max_shrink, (uint32_t)seed,
      (uint32_t)(seed >> 32), burn, thin, n_samples, offset, C, samples, lps, accs);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The likelihoods the kernel is instantiated for (each with a diagonal and a
// lower-triangular prior scale): the one list of the pairs (see
// csrc/common.cuh).
#define AMH_ESS_DENSITIES(X)     \
  X(amh::GPRegression<16>)       \
  X(amh::GPRegression<64>)       \
  X(amh::GPClassification<16>)   \
  X(amh::GPClassification<64>)

extern "C" {

int amh_ess_sample(const char* density, int32_t d, int32_t tril, const void* params_t,
                   const void* lp, const void* loc, const void* scale,
                   const void* consts, int32_t n_consts, int32_t max_shrink,
                   uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                   uint64_t offset, int64_t C, void* samples, void* lps, void* accs,
                   void* stream) {
#define X(T)                                                                       \
  if (amh::matches<T>(density, d))                                                 \
    return (tril ? amh::launch_ess<T, true> : amh::launch_ess<T, false>)(          \
        (const float*)params_t, (const float*)lp, (const float*)loc,               \
        (const float*)scale, (const float*)consts, n_consts, max_shrink, seed,     \
        burn, thin, n_samples, offset, C, (float*)samples, (float*)lps,            \
        (float*)accs, (cudaStream_t)stream);
  AMH_ESS_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_ess() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_ESS_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
