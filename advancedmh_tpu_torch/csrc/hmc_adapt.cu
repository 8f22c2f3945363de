// Adaptive HMC kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_hmc_adapt.py::_adaptive_hmc_kernel:
// `warmup` HMC steps that adapt each chain's step size (HG14 dual averaging
// on the accept indicator) and diagonal inverse mass (Welford moments of the
// positions, Stan-regularised: reg(M2, t - 1) before warmup step t, the
// Welford update after it), then n_samples thinned draws at the frozen
// eps_bar = exp(log eps_bar) and reg(M2, warmup). The resume variant
// (kResume) runs no warmup: it starts frozen at a given per-chain
// log eps_bar (1, C) and M^-1 (d, C). Both form eps_bar as expf of the same
// stored log eps_bar, so a run split after its warmup and resumed is
// bit-exact. The plain PyTorch version is
// ops/hmc_adapt.py::adaptive_hmc_reference; the C entry point at the end is
// bound there with ctypes.
//
// Layout and design: csrc/hmc.cuh. Each chain's M^-1 is a register row of
// the thread (recomputed from M2 before each warmup step); the Welford
// moments (mean, M2), read and written once a warmup step, live in device
// memory (d, C) next to the fall-back state, so that the registers hold the
// trajectory only. What bounds it: as csrc/hmc.cu (the same step, plus
// O(d) per warmup step for the adaptation).
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py).

#include "hmc.cuh"

namespace amh {

struct MassAdaptation {
  float reg;         // Stan's pseudo-count (mass_regularization)
  float warm_start;  // observations before the estimate is used
};

// Stan's shrunk variance estimate from (M2, count n): the identity until
// warm_start observations (ops/hmc_adapt.py::regularized_inverse_mass).
__device__ __forceinline__ float reg_minv(float m2, float n,
                                          const MassAdaptation& m) {
  const float nn = fmaxf(n, 1.0f);
  const float var = m2 / fmaxf(nn - 1.0f, 1.0f);
  const float est = (nn / (nn + m.reg)) * var + 1e-3f * (m.reg / (nn + m.reg));
  return n >= m.warm_start ? est : 1.0f;
}

// Sample e is the state after warmup + (e+1)*thin steps; step t of the
// launch is absolute iteration offset + t (t = 1, 2, ...).
template <class Density, bool kResume>
__global__ void __launch_bounds__(kHmcBlock) adaptive_hmc_kernel(
    const float* __restrict__ params_t, const float* __restrict__ lp_in,
    const float* __restrict__ grad_in, const float* __restrict__ leb_in,
    const float* __restrict__ minv_in, const float* __restrict__ consts,
    int n_consts, DualAveraging da, MassAdaptation ma, int n_leapfrog,
    uint32_t k0, uint32_t k1, int64_t warmup, int64_t thin, int64_t n_samples,
    uint64_t offset, int64_t C, float* __restrict__ samples,
    float* __restrict__ lps, float* __restrict__ accs,
    float* __restrict__ leb_out, float* __restrict__ minv_out,
    float* __restrict__ x_state, float* __restrict__ g_state,
    float* __restrict__ mean_s, float* __restrict__ m2_s) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh_consts[];
  load_consts(sh_consts, consts, n_consts);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[D], g[D], minv[D];
  hmc_load<D>(params_t, grad_in, x, g, x_state, g_state, c, C);
  float lp = lp_in[c];
  float leb;
  uint64_t j = offset;
  if (kResume) {
    leb = leb_in[c];
#pragma unroll
    for (int i = 0; i < D; ++i) minv[i] = minv_in[i * C + c];
  } else {
    float log_eps = da.log_eps0, h_bar = 0.0f;
    leb = da.log_eps0;
    if (warmup > 0) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        mean_s[i * C + c] = x[i];
        m2_s[i * C + c] = 0.0f;
      }
    }
    for (int64_t t = 1; t <= warmup; ++t) {
      const float tf = (float)t;
#pragma unroll
      for (int i = 0; i < D; ++i) minv[i] = reg_minv(m2_s[i * C + c], tf - 1.0f, ma);
      const bool acc = hmc_step<Density>(x, lp, g, minv, expf(log_eps), n_leapfrog,
                                         sh_consts, n_consts, x_state, g_state,
                                         c, C, ++j, k0, k1);
      dual_average(da, tf, acc ? 1.0f : 0.0f, log_eps, leb, h_bar);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float mean = mean_s[i * C + c];
        const float delta = x[i] - mean;
        const float mean_new = mean + delta / tf;
        mean_s[i * C + c] = mean_new;
        m2_s[i * C + c] = m2_s[i * C + c] + delta * (x[i] - mean_new);
      }
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
      minv[i] = warmup > 0 ? reg_minv(m2_s[i * C + c], (float)warmup, ma)
                           : reg_minv(0.0f, 0.0f, ma);
  }
  const float eps = expf(leb);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = hmc_step<Density>(x, lp, g, minv, eps, n_leapfrog, sh_consts,
                                   n_consts, x_state, g_state, c, C, ++j, k0, k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = x[i];
    lps[e * C + c] = lp;
    accs[e * C + c] = accepted ? 1.0f : 0.0f;
  }
  leb_out[c] = leb;
#pragma unroll
  for (int i = 0; i < D; ++i) minv_out[i * C + c] = minv[i];
}

template <class Density, bool kResume>
int launch_adaptive_hmc(const float* params_t, const float* lp,
                        const float* grad, const float* leb_in,
                        const float* minv_in, const float* consts, int n_consts,
                        DualAveraging da, MassAdaptation ma, int n_leapfrog,
                        uint64_t seed, int64_t warmup, int64_t thin,
                        int64_t n_samples, uint64_t offset, int64_t C,
                        float* samples, float* lps, float* accs, float* leb_out,
                        float* minv_out, float* x_state, float* g_state,
                        float* mean_s, float* m2_s, cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(adaptive_hmc_kernel<Density, kResume>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kHmcBlock - 1) / kHmcBlock));
  adaptive_hmc_kernel<Density, kResume><<<grid, kHmcBlock, smem, stream>>>(
      params_t, lp, grad, leb_in, minv_in, consts, n_consts, da, ma, n_leapfrog,
      (uint32_t)seed, (uint32_t)(seed >> 32), warmup, thin, n_samples, offset, C,
      samples, lps, accs, leb_out, minv_out, x_state, g_state, mean_s, m2_s);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities with a value_and_grad that the kernel is instantiated for
// (each fresh and resumed): the one list of the pairs (see csrc/common.cuh).
#define AMH_HMC_ADAPT_DENSITIES(X) \
  X(amh::GaussianMeanScale)        \
  X(amh::CorrelatedGaussian<2>)    \
  X(amh::LogisticRegression<32>)

extern "C" {

int amh_adaptive_hmc_sample(
    const char* density, int32_t d, int32_t resume, const void* params_t,
    const void* lp, const void* grad, const void* leb_in, const void* minv_in,
    const void* consts, int32_t n_consts, float target, float t0, float kappa,
    float gamma, float mu, float log_eps0, float mass_reg, float warm_start,
    int32_t n_leapfrog, uint64_t seed, int64_t warmup, int64_t thin,
    int64_t n_samples, uint64_t offset, int64_t C, void* samples, void* lps,
    void* accs, void* leb_out, void* minv_out, void* x_state, void* g_state,
    void* mean_s, void* m2_s, void* stream) {
  const amh::DualAveraging da{target, t0, kappa, gamma, mu, log_eps0};
  const amh::MassAdaptation ma{mass_reg, warm_start};
#define X(T)                                                                  \
  if (amh::matches<T>(density, d))                                            \
    return (resume ? amh::launch_adaptive_hmc<T, true>                        \
                   : amh::launch_adaptive_hmc<T, false>)(                     \
        (const float*)params_t, (const float*)lp, (const float*)grad,         \
        (const float*)leb_in, (const float*)minv_in, (const float*)consts,    \
        n_consts, da, ma, n_leapfrog, seed, warmup, thin, n_samples, offset,  \
        C, (float*)samples, (float*)lps, (float*)accs, (float*)leb_out,       \
        (float*)minv_out, (float*)x_state, (float*)g_state, (float*)mean_s,   \
        (float*)m2_s, (cudaStream_t)stream);
  AMH_HMC_ADAPT_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_hmc_adapt() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_HMC_ADAPT_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
