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
// Layout: the block shape, start and launch of csrc/hmc_group.cuh, as
// Barker. On the logistic regression a chain runs on the 8 lanes of its
// group form (csrc/group.cuh): lane l holds coordinates [4 l, 4 l + 4) of x
// and of the prior's loc, scale and log scale in registers, 16 chains share
// a 128-thread block, at least 4 blocks an SM; the conjugate and flat
// likelihoods run one thread a chain through the same code (kLanes = 1, 64
// threads). Dynamic shared memory holds the group form's constants (X with
// rows padded to d + 4 floats, then y and 1/prior^2: ~37 KB at 256 x 32),
// then each chain's scratch, where its lanes stage the candidate for the
// value-only likelihood (GroupForm::logp: lane l sums observations l, l + 8,
// .. into partial l; the 8 partials in order are LogisticRegression::logp's
// bits). The prior's columns stay in device memory: each lane reads its own
// once. Lane 0 writes the emitted (ll, accepted) and eps_bar.
//
// A step: each lane draws its coordinates' normals and the accept uniform
// from step j's Philox words (group.cuh::lane_noise, step_noise's bits),
// forms its coordinates of y = x + eps z and its prior terms, and the chain
// sums the terms over the coordinates in order (group.cuh::coord_sum: the
// row sum of the plain version). The decision and the per-chain dual
// averaging are the same in every lane. Step j of the launch is the
// absolute index offset + j, through burn-in and emission alike; the Pallas
// kernel's pairing of two steps' Box-Muller halves (a Mosaic layout choice)
// is not carried over.
//
// What bounds it on this card: the likelihood. On the d = 32 logistic
// regression with 256 observations a step is ~18k float operations a chain
// (the prior ~4d, the noise and the accept a few hundred), so the launch is
// operations-bound; on 8 lanes a chain that is 32 observations' dot
// products a lane, with X read from shared memory, 4 chains a warp reading
// the same rows. The emitted (ll, accepted) pairs set a bytes bound far
// below.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py). The prior
// divides by the scale (not a product with its reciprocal), as the plain
// version does.

#include "hmc_group.cuh"

namespace amh {

constexpr float kLog10 = (float)2.302585092994045684;  // log 10, rounded once

// One power-posterior RWMH step y = x + eps z of absolute index j for chain
// c over the lane's coordinates; returns whether it accepted, the same in
// every lane of the chain.
template <class Density>
__device__ __forceinline__ bool power_step(float (&x)[GroupShape<Density>::kJ], float& ll,
                                           float& plp, float beta, float eps,
                                           const float (&loc)[GroupShape<Density>::kJ],
                                           const float (&scale)[GroupShape<Density>::kJ],
                                           const float (&log_scale)[GroupShape<Density>::kJ],
                                           const float* sh, int n_consts, float* scratch,
                                           const Lanes& ln, uint64_t j, uint32_t c, uint32_t k0,
                                           uint32_t k1) {
  using GF = GroupForm<Density>;
  constexpr int kLanes = GF::kLanes;
  constexpr int kJ = GroupShape<Density>::kJ;
  float y[kJ];
  float logu;
  lane_noise<Density::kDim, kLanes>(j, c, k0, k1, ln.lane, y, logu);
#pragma unroll
  for (int k = 0; k < kJ; ++k) y[k] = x[k] + eps * y[k];
  const float ll_c = GF::logp(y, sh, n_consts, scratch, ln);
  float t[kJ];  // log p(x) = sum_i (-0.5 z_i) z_i - log s_i - log(2 pi)/2
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const float z = (y[k] - loc[k]) / scale[k];
    t[k] = -0.5f * z * z - log_scale[k] - (float)kHalfLog2Pi;
  }
  const float plp_c = coord_sum<kLanes, kJ>(t, ln);
  const float logalpha = (plp_c + beta * ll_c) - (plp + beta * ll);
  const bool accept = logu < logalpha;  // NaN rejects
#pragma unroll
  for (int k = 0; k < kJ; ++k) x[k] = accept ? y[k] : x[k];
  ll = accept ? ll_c : ll;
  plp = accept ? plp_c : plp;
  return accept;
}

// Draw e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...). `consts` holds the
// likelihood's n_consts constants, then the prior's loc (d) and scale (d).
template <class Density, bool kAdapt>
__global__ void __launch_bounds__(GroupShape<Density>::kThreads, GroupShape<Density>::kMinBlocks)
    power_rwmh_kernel(const float* __restrict__ x_t, const float* __restrict__ ll_in,
                      const float* __restrict__ plp_in, const float* __restrict__ beta_in,
                      const float* __restrict__ eps0_in, const float* __restrict__ consts,
                      int n_consts, DualAveraging da, uint32_t k0, uint32_t k1,
                      int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
                      int64_t C, float* __restrict__ lls, float* __restrict__ accs,
                      float* __restrict__ eps_out) {
  constexpr int D = Density::kDim;
  constexpr int kJ = GroupShape<Density>::kJ;
  extern __shared__ __align__(16) float sh[];
  const GroupChain ch = group_chain<Density>(sh, consts, n_consts);
  const int64_t c = ch.c;
  if (c >= C) return;  // the chain's lanes leave together
  float x[kJ], loc[kJ], scale[kJ], log_scale[kJ];
  lane_load<kJ>(x_t, ch, C, x);
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    loc[k] = consts[n_consts + ch.j0 + k];
    scale[k] = consts[n_consts + D + ch.j0 + k];
    log_scale[k] = logf(scale[k]);
  }
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
      const bool acc = power_step<Density>(x, ll, plp, beta, expf(log_eps), loc, scale,
                                           log_scale, sh, n_consts, ch.scratch, ch.ln, ++j,
                                           (uint32_t)c, k0, k1);
      dual_average(dc, (float)t, acc ? 1.0f : 0.0f, log_eps, leb, h_bar);
    }
    eps = expf(leb);
  } else {
    for (int64_t t = 1; t <= burn; ++t)
      power_step<Density>(x, ll, plp, beta, eps, loc, scale, log_scale, sh, n_consts,
                          ch.scratch, ch.ln, ++j, (uint32_t)c, k0, k1);
  }
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = power_step<Density>(x, ll, plp, beta, eps, loc, scale, log_scale, sh,
                                     n_consts, ch.scratch, ch.ln, ++j, (uint32_t)c, k0, k1);
    if (ch.ln.lane == 0) {
      lls[e * C + c] = ll;
      accs[e * C + c] = accepted ? 1.0f : 0.0f;
    }
  }
  if (ch.ln.lane == 0) eps_out[c] = eps;
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
#define X(T)                                                                            \
  if (amh::matches<T>(density, d))                                                      \
    return amh::launch_group<T>(                                                        \
        adapt ? amh::power_rwmh_kernel<T, true> : amh::power_rwmh_kernel<T, false>,     \
        n_consts, C, (cudaStream_t)stream, (const float*)x_t, (const float*)ll,         \
        (const float*)plp, (const float*)beta, (const float*)eps0, (const float*)consts, \
        n_consts, da, (uint32_t)seed, (uint32_t)(seed >> 32), burn, thin, n_samples,    \
        offset, C, (float*)lls, (float*)accs, (float*)eps_out);
  AMH_EVIDENCE_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

// The kernel's launch shape for C chains (csrc/hmc_group.cuh::group_launch_info).
int amh_evidence_info(const char* density, int32_t d, int32_t adapt, int32_t n_consts, int64_t C,
                      int64_t* out) {
#define X(T)                                                                               \
  if (amh::matches<T>(density, d))                                                         \
    return amh::group_launch_info<T>(                                                      \
        adapt ? amh::power_rwmh_kernel<T, true> : amh::power_rwmh_kernel<T, false>, n_consts, \
        C, out);
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
