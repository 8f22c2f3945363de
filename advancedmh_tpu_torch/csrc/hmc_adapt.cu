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
// Design: a block runs a group of chains, each spread over the lanes of its
// density's group form (csrc/group.cuh; the step, block shape and launch in
// csrc/hmc_group.cuh, shared with HMC and ChEES's frozen phase). On
// the logistic regression a chain takes 8 lanes, a block of 128 threads 16
// chains with X in its shared memory, and a value and gradient is a product
// over the group: the TPU kernel's X (n, d) @ beta (d, TC) per tile, here
// in float32 on the CUDA cores, summed in the plain density's order. The
// trajectory, the fall-back state, M^-1, the Welford moments (mean, M2) and
// the dual-averaging scalars live in the chain's lanes' registers (kJ = 4
// coordinates each at d = 32); ptxas must report no spills (chip_smoke.py
// prints its report). The flagship and the correlated Gaussian run one
// thread per chain through the same code (kLanes = 1, chosen at compile
// time).
//
// What bounds it on this card: one value and gradient per leapfrog step,
// ~36.7k float32 operations a chain at d = 32 and n = 256 issued one by one
// (no FMA under --fmad=false, so at best half the 67 TFLOP/s peak), from
// shared memory at about one float4 load per 8 operations.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py).

#include "hmc_group.cuh"

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
__global__ void __launch_bounds__(GroupShape<Density>::kThreads, GroupShape<Density>::kMinBlocks)
adaptive_hmc_kernel(
    const float* __restrict__ params_t, const float* __restrict__ lp_in,
    const float* __restrict__ grad_in, const float* __restrict__ leb_in,
    const float* __restrict__ minv_in, const float* __restrict__ consts,
    int n_consts, DualAveraging da, MassAdaptation ma, int n_leapfrog,
    uint32_t k0, uint32_t k1, int64_t warmup, int64_t thin, int64_t n_samples,
    uint64_t offset, int64_t C, float* __restrict__ samples,
    float* __restrict__ lps, float* __restrict__ accs,
    float* __restrict__ leb_out, float* __restrict__ minv_out,
    float* __restrict__ x_out, float* __restrict__ g_out) {
  constexpr int D = Density::kDim;
  constexpr int kJ = GroupShape<Density>::kJ;
  extern __shared__ __align__(16) float sh[];
  const GroupChain ch = group_chain<Density>(sh, consts, n_consts);
  const int64_t c = ch.c;
  if (c >= C) return;  // the chain's lanes leave together
  float x[kJ], g[kJ], x0[kJ], g0[kJ], minv[kJ];
  lane_load<kJ>(params_t, ch, C, x);
  lane_load<kJ>(grad_in, ch, C, g);
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    x0[k] = x[k];
    g0[k] = g[k];
  }
  float lp = lp_in[c];
  float leb;
  uint64_t j = offset;
  if (kResume) {
    leb = leb_in[c];
    lane_load<kJ>(minv_in, ch, C, minv);
  } else {
    float log_eps = da.log_eps0, h_bar = 0.0f;
    float mean[kJ], m2[kJ];
    leb = da.log_eps0;
#pragma unroll
    for (int k = 0; k < kJ; ++k) {
      mean[k] = x[k];
      m2[k] = 0.0f;
    }
    for (int64_t t = 1; t <= warmup; ++t) {
      const float tf = (float)t;
#pragma unroll
      for (int k = 0; k < kJ; ++k) minv[k] = reg_minv(m2[k], tf - 1.0f, ma);
      const bool acc = group_hmc_step<Density>(x, lp, g, x0, g0, minv, expf(log_eps),
                                               n_leapfrog, sh, n_consts, ch.scratch, ch.ln,
                                               c, ++j, k0, k1);
      dual_average(da, tf, acc ? 1.0f : 0.0f, log_eps, leb, h_bar);
#pragma unroll
      for (int k = 0; k < kJ; ++k) {
        const float delta = x[k] - mean[k];
        const float mean_new = mean[k] + delta / tf;
        m2[k] = m2[k] + delta * (x[k] - mean_new);
        mean[k] = mean_new;
      }
    }
#pragma unroll
    for (int k = 0; k < kJ; ++k)
      minv[k] = warmup > 0 ? reg_minv(m2[k], (float)warmup, ma) : reg_minv(0.0f, 0.0f, ma);
  }
  const float eps = expf(leb);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = group_hmc_step<Density>(x, lp, g, x0, g0, minv, eps, n_leapfrog, sh,
                                         n_consts, ch.scratch, ch.ln, c, ++j, k0, k1);
    lane_store<kJ>(samples + e * D * C, ch, C, x);
    if (ch.ln.lane == 0) {
      lps[e * C + c] = lp;
      accs[e * C + c] = accepted ? 1.0f : 0.0f;
    }
  }
  if (ch.ln.lane == 0) leb_out[c] = leb;
  lane_store<kJ>(minv_out, ch, C, minv);
  lane_store<kJ>(x_out, ch, C, x);
  lane_store<kJ>(g_out, ch, C, g);
}

template <class Density, bool kResume>
int launch_adaptive_hmc(const float* params_t, const float* lp,
                        const float* grad, const float* leb_in,
                        const float* minv_in, const float* consts, int n_consts,
                        DualAveraging da, MassAdaptation ma, int n_leapfrog,
                        uint64_t seed, int64_t warmup, int64_t thin,
                        int64_t n_samples, uint64_t offset, int64_t C,
                        float* samples, float* lps, float* accs, float* leb_out,
                        float* minv_out, float* x_out, float* g_out,
                        cudaStream_t stream) {
  return launch_group<Density>(
      adaptive_hmc_kernel<Density, kResume>, n_consts, C, stream, params_t, lp, grad, leb_in,
      minv_in, consts, n_consts, da, ma, n_leapfrog, (uint32_t)seed, (uint32_t)(seed >> 32),
      warmup, thin, n_samples, offset, C, samples, lps, accs, leb_out, minv_out, x_out, g_out);
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
    void* accs, void* leb_out, void* minv_out, void* x_out, void* g_out, void* stream) {
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
        (float*)minv_out, (float*)x_out, (float*)g_out, (cudaStream_t)stream);
  AMH_HMC_ADAPT_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

int amh_adaptive_hmc_info(const char* density, int32_t d, int32_t resume, int32_t n_consts,
                          int64_t C, int64_t* out) {
#define X(T)                                                                              \
  if (amh::matches<T>(density, d))                                                        \
    return resume                                                                         \
        ? amh::group_launch_info<T>(amh::adaptive_hmc_kernel<T, true>, n_consts, C, out)  \
        : amh::group_launch_info<T>(amh::adaptive_hmc_kernel<T, false>, n_consts, C, out);
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
