// Power-posterior RWMH kernel for Hopper (sm_90a): the evidence estimators'
// ladder batch.
//
// Replaces advancedmh_tpu/ops/pallas_evidence.py::_power_kernel: isotropic
// random-walk Metropolis on pi_beta(x) ~ p(x) L(x)^beta for a flat batch of
// chains, each with its own beta and initial step size eps0. The kernel
// carries log p and log L apart; the prior is an elementwise Gaussian
// evaluated here from its (loc, scale) columns,
//   log p(x) = sum_i (-0.5 z_i) z_i - log s_i - log(2 pi)/2,  z_i = (x_i - loc_i)/s_i,
// and a step accepts iff log u < (lp_c + beta ll_c) - (lp + beta ll), so a
// NaN (beta = 0 beside ll = -inf) rejects. `burn` steps run at
// eps = exp(log eps) with per-chain HG14 dual averaging (kAdapt; mu =
// log eps0 + log 10 per chain, in float32, as the Pallas kernel forms it) or
// at eps0 exactly, then n_samples thinned draws at the frozen eps_bar =
// exp(log eps_bar) (or eps0). Only the log-likelihood and the accept flag of
// each emitted draw are written, and eps_bar at the end. The plain PyTorch
// version is ops/evidence.py::power_rwmh_reference; the C entry point at the
// end is bound there with ctypes.
//
// Layout and design as csrc/adapt.cu: chains on the last axis, one thread
// per chain with x, ll, lp, log eps, log eps_bar and h_bar in registers,
// 128-thread blocks with the last one masked (any chain count runs; nothing
// is edge-padded). Dynamic shared memory holds the likelihood's constants,
// then the prior's loc and scale columns, then log scale (computed once per
// block). Step j of the launch takes its normals and accept uniform from
// step_noise of its absolute index offset + j, through burn-in and emission
// alike; the Pallas kernel's pairing of two steps' Box-Muller halves (a
// Mosaic layout choice) is not carried over.
//
// What bounds it on this card: the likelihood. On the d = 32 logistic
// regression with 256 observations a step is ~18k float operations a chain
// (the prior ~4d, the noise and the accept a few hundred), so the launch is
// operations-bound; one thread per chain runs it as a dependent chain of
// arithmetic, latency-bound below 4 warps per SM at 8192 chains. The
// emitted (ll, accepted) pairs set a bytes bound far below.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py). The prior
// divides by the scale (not a product with its reciprocal), as the plain
// version does.

#include "common.cuh"

namespace amh {

constexpr int kPowerBlock = 128;
constexpr float kLog10 = (float)2.302585092994045684;  // log 10, rounded once

// log p(x) of the elementwise Gaussian prior, rows summed in order.
template <int D>
__device__ __forceinline__ float gaussian_prior_lp(const float (&x)[D], const float* loc,
                                                   const float* scale,
                                                   const float* log_scale) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float z = (x[i] - loc[i]) / scale[i];
    const float t = -0.5f * z * z - log_scale[i] - (float)kHalfLog2Pi;
    s = i == 0 ? t : s + t;
  }
  return s;
}

// One power-posterior RWMH step y = x + eps z; returns whether it accepted.
template <class Density>
__device__ __forceinline__ bool power_step(float (&x)[Density::kDim], float& ll,
                                           float& plp, float beta, float eps,
                                           const float* consts, int n_consts,
                                           const float* loc, const float* scale,
                                           const float* log_scale, uint64_t j,
                                           uint32_t c, uint32_t k0, uint32_t k1) {
  constexpr int D = Density::kDim;
  float y[D];
  float logu;
  step_noise<D>(j, c, k0, k1, y, logu);
#pragma unroll
  for (int i = 0; i < D; ++i) y[i] = x[i] + eps * y[i];
  const float ll_c = Density::logp(y, consts, n_consts);
  const float plp_c = gaussian_prior_lp<D>(y, loc, scale, log_scale);
  const float logalpha = (plp_c + beta * ll_c) - (plp + beta * ll);
  const bool accept = logu < logalpha;
  if (accept) {
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = y[i];
    ll = ll_c;
    plp = plp_c;
  }
  return accept;
}

// Draw e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...).
template <class Density, bool kAdapt>
__global__ void __launch_bounds__(kPowerBlock)
    power_rwmh_kernel(const float* __restrict__ x_t, const float* __restrict__ ll_in,
                      const float* __restrict__ plp_in, const float* __restrict__ beta_in,
                      const float* __restrict__ eps0_in, const float* __restrict__ consts,
                      int n_consts, DualAveraging da, uint32_t k0, uint32_t k1,
                      int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
                      int64_t C, float* __restrict__ lls, float* __restrict__ accs,
                      float* __restrict__ eps_out) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh[];
  // consts, then loc (D), scale (D) as the wrapper laid them out; log scale
  // (D) after them
  const int n_in = n_consts + 2 * D;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x) sh[i] = consts[i];
  __syncthreads();
  const float* loc = sh + n_consts;
  const float* scale = loc + D;
  float* log_scale = sh + n_in;
  for (int i = threadIdx.x; i < D; i += blockDim.x) log_scale[i] = logf(scale[i]);
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = x_t[i * C + c];
  float ll = ll_in[c];
  float plp = plp_in[c];
  const float beta = beta_in[c];
  const float eps0 = eps0_in[c];
  uint64_t j = offset;
  float eps = eps0;
  if (kAdapt) {
    const float le0 = logf(eps0);
    DualAveraging dc = da;
    dc.mu = le0 + kLog10;
    float log_eps = le0, leb = le0, h_bar = 0.0f;
    for (int64_t t = 1; t <= burn; ++t) {
      const bool acc = power_step<Density>(x, ll, plp, beta, expf(log_eps), sh, n_consts,
                                           loc, scale, log_scale, ++j, (uint32_t)c, k0, k1);
      dual_average(dc, (float)t, acc ? 1.0f : 0.0f, log_eps, leb, h_bar);
    }
    eps = expf(leb);
  } else {
    for (int64_t t = 1; t <= burn; ++t)
      power_step<Density>(x, ll, plp, beta, eps, sh, n_consts, loc, scale, log_scale, ++j,
                          (uint32_t)c, k0, k1);
  }
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = power_step<Density>(x, ll, plp, beta, eps, sh, n_consts, loc, scale,
                                     log_scale, ++j, (uint32_t)c, k0, k1);
    lls[e * C + c] = ll;
    accs[e * C + c] = accepted ? 1.0f : 0.0f;
  }
  eps_out[c] = eps;
}

template <class Density, bool kAdapt>
int launch_power(const float* x_t, const float* ll, const float* plp, const float* beta,
                 const float* eps0, const float* consts, int n_consts, DualAveraging da,
                 uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                 uint64_t offset, int64_t C, float* lls, float* accs, float* eps_out,
                 cudaStream_t stream) {
  constexpr int D = Density::kDim;
  const size_t smem = (n_consts + 3 * D) * sizeof(float);
  const cudaError_t err = allow_shared(power_rwmh_kernel<Density, kAdapt>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kPowerBlock - 1) / kPowerBlock));
  power_rwmh_kernel<Density, kAdapt><<<grid, kPowerBlock, smem, stream>>>(
      x_t, ll, plp, beta, eps0, consts, n_consts, da, (uint32_t)seed,
      (uint32_t)(seed >> 32), burn, thin, n_samples, offset, C, lls, accs, eps_out);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The likelihoods the kernel is instantiated for (each with and without
// adaptation): the one list of the pairs (see csrc/common.cuh).
#define AMH_EVIDENCE_DENSITIES(X) \
  X(amh::NormalMean)              \
  X(amh::Flat<2>)                 \
  X(amh::LogisticRegression<32>)

extern "C" {

int amh_power_rwmh_sample(const char* density, int32_t d, int32_t adapt, const void* x_t,
                          const void* ll, const void* plp, const void* beta,
                          const void* eps0, const void* consts, int32_t n_consts,
                          float target, float t0, float kappa, float gamma, uint64_t seed,
                          int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
                          int64_t C, void* lls, void* accs, void* eps_out, void* stream) {
  const amh::DualAveraging da{target, t0, kappa, gamma, 0.0f, 0.0f};
#define X(T)                                                                           \
  if (amh::matches<T>(density, d))                                                     \
    return (adapt ? amh::launch_power<T, true> : amh::launch_power<T, false>)(         \
        (const float*)x_t, (const float*)ll, (const float*)plp, (const float*)beta,    \
        (const float*)eps0, (const float*)consts, n_consts, da, seed, burn, thin,      \
        n_samples, offset, C, (float*)lls, (float*)accs, (float*)eps_out,              \
        (cudaStream_t)stream);
  AMH_EVIDENCE_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_evidence() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_EVIDENCE_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
