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
// Layout: the block shape, start and prior draw of csrc/gp_group.cuh, shared
// with pCN: a chain on the 8 lanes of its likelihood's group form
// (csrc/group.cuh::GPGroupForm), coordinate i on lane i mod 8, lane l holding
// x, nu - mu, mu (and a diagonal scale) at coordinates l, l + 8, .. in
// registers (8 of each at d = 64, where one thread a chain held 192 floats
// and spilled); 16 chains a 128-thread block, at least 4 blocks an SM; L's
// padded rows and each chain's staged normals in shared memory.
//
// A step: nu - mu = L z from the step's normals (gp_group.cuh::prior_draw).
// Every lane then runs the same trips: the same theta, cos and sin and trip
// uniform (word 2P + 2 + k of the step's Philox stream,
// common.cuh::StepWords), the lane's coordinates of the candidate, and the
// likelihood from the 8 partials in order. The test lp' > log y is the same
// in all 8 lanes, so a chain's lanes leave the loop together, keeping the
// accepted candidate; a warp waits only for the slowest of its 4 chains. The
// trip loop ends at the first point in the slice (the TPU kernel runs all
// max_shrink trips because Mosaic runs data-dependent trip counts poorly);
// the trips a chain skips change nothing.
//
// What bounds it on this card: at d = 64 a step is the d(d+1)/2 products of
// L z (288 a lane with the zeros), the trips' evaluations of the likelihood
// (4.2 a chain-step on the GP classification, 7.0 on the regression, 8
// points a lane each) and one cosf/sinf pair a trip. The emission's bytes
// (d + 2 floats a chain and draw) set a bound far below.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py); cosf and
// sinf are the accurate ones, as torch.cos and torch.sin.

#include "gp_group.cuh"

namespace amh {

// One elliptical slice step of absolute index j for chain c, over the lane's
// coordinates; returns whether the chain found a point in the slice (the
// same in every lane). `loc` and `diag` are the lane's coordinates of mu and
// of a diagonal scale.
template <class Density, bool kTril>
__device__ __forceinline__ bool ess_step(float (&x)[GroupForm<Density>::kJ], float& lp,
                                         const float (&loc)[GroupForm<Density>::kJ],
                                         const float (&diag)[GroupForm<Density>::kJ],
                                         int max_shrink, const float* sh, const PriorChain& ch,
                                         uint64_t j, uint32_t k0, uint32_t k1) {
  using GF = GroupForm<Density>;
  constexpr int kJ = GF::kJ;
  constexpr int P = (Density::kDim + 1) / 2;
  StepWords s(j, (uint32_t)ch.c, k0, k1);
  float nu[kJ];  // nu - mu at the lane's coordinates
  prior_draw<Density, kTril>(s, diag, ch, nu);
  const float logy = lp + logf(s.uniform(2 * P));
  const float theta0 = kTwoPi * s.uniform(2 * P + 1);
  float theta = theta0, tmin = theta0 - kTwoPi, tmax = theta0;
  for (int trip = 0; trip < max_shrink; ++trip) {
    const float cs = cosf(theta), sn = sinf(theta);
    float cand[kJ];
#pragma unroll
    for (int k = 0; k < kJ; ++k) cand[k] = (loc[k] + (x[k] - loc[k]) * cs) + nu[k] * sn;
    const float lp_c = GF::logp(cand, sh, ch.ln);
    if (lp_c > logy) {
#pragma unroll
      for (int k = 0; k < kJ; ++k) x[k] = cand[k];
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
// is absolute iteration offset + t (t = 1, 2, ...).
template <class Density, bool kTril>
__global__ void __launch_bounds__(GroupShape<Density>::kThreads, GroupShape<Density>::kMinBlocks)
    ess_sample_kernel(const float* __restrict__ params_t,
                      const float* __restrict__ lp_in, const float* __restrict__ loc,
                      const float* __restrict__ scale, const float* __restrict__ consts,
                      int n_consts, int max_shrink, uint32_t k0, uint32_t k1,
                      int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
                      int64_t C, float* __restrict__ samples, float* __restrict__ lps,
                      float* __restrict__ accs) {
  using GF = GroupForm<Density>;
  constexpr int D = Density::kDim;
  constexpr int kJ = GF::kJ;
  extern __shared__ __align__(16) float sh[];
  const PriorChain ch = prior_chain<Density, kTril>(sh, consts, n_consts, scale);
  const int64_t c = ch.c;
  if (c >= C) return;  // the chain's lanes leave together
  float x[kJ], mu[kJ], diag[kJ];
  lane_column<Density>(params_t, ch, C, x);
  lane_vector<Density>(loc, ch, mu);
#pragma unroll
  for (int k = 0; k < kJ; ++k) diag[k] = kTril ? 0.0f : scale[GF::coord(ch.ln.lane, k)];
  float lp = lp_in[c];
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    ess_step<Density, kTril>(x, lp, mu, diag, max_shrink, sh, ch, ++j, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool done = false;
    for (int64_t t = 0; t < thin; ++t)
      done = ess_step<Density, kTril>(x, lp, mu, diag, max_shrink, sh, ch, ++j, k0, k1);
#pragma unroll
    for (int k = 0; k < kJ; ++k) samples[(e * D + GF::coord(ch.ln.lane, k)) * C + c] = x[k];
    if (ch.ln.lane == 0) {
      lps[e * C + c] = lp;
      accs[e * C + c] = done ? 1.0f : 0.0f;
    }
  }
}

template <class Density, bool kTril>
int launch_ess(const float* params_t, const float* lp, const float* loc,
               const float* scale, const float* consts, int n_consts, int max_shrink,
               uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
               uint64_t offset, int64_t C, float* samples, float* lps, float* accs,
               cudaStream_t stream) {
  return launch_group<Density, PriorShape<Density, kTril>>(
      ess_sample_kernel<Density, kTril>, n_consts, C, stream, params_t, lp, loc, scale,
      consts, n_consts, max_shrink, (uint32_t)seed, (uint32_t)(seed >> 32), burn, thin,
      n_samples, offset, C, samples, lps, accs);
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

// The kernel's launch shape for C chains (csrc/hmc_group.cuh::group_launch_info).
int amh_ess_info(const char* density, int32_t d, int32_t tril, int32_t n_consts, int64_t C,
                 int64_t* out) {
#define X(T)                                                                        \
  if (amh::matches<T>(density, d))                                                  \
    return tril ? amh::group_launch_info<T, amh::PriorShape<T, true>>(              \
                      amh::ess_sample_kernel<T, true>, n_consts, C, out)            \
                : amh::group_launch_info<T, amh::PriorShape<T, false>>(             \
                      amh::ess_sample_kernel<T, false>, n_consts, C, out);
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
