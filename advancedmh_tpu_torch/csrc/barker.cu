// Barker-proposal kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_barker.py::_barker_kernel: burn-in, then
// n_samples thinned draws of the Barker proposal (Livingstone & Zanella
// 2022): per coordinate z = sigma N(0, 1), its sign kept with the logistic
// probability of z g (g the gradient carried from the last accepted state),
// tested as log u - log(1 - u) < z g; y = x + delta, one value-and-gradient
// evaluation of the density at y, and
//   log alpha = (lp_y - lp) + sum_i [softplus(-delta_i g_i) - softplus(delta_i g_y,i)]
// summed over the coordinates in order, accepted iff -log u > -log alpha (a
// NaN log alpha rejects). The gradient at the last state is returned, as
// csrc/mala.cu does. The plain PyTorch version is
// ops/barker.py::barker_sample_reference; the C entry point at the end is
// bound there with ctypes.
//
// Layout: the block shape, start and launch of csrc/hmc_group.cuh, as HMC.
// On the logistic regression a chain runs on 8 lanes (its group form,
// csrc/group.cuh), lane l holding coordinates [4 l, 4 l + 4) of x, g, delta,
// y and g_y in registers (20 floats, where one thread a chain held 4 x 32 and
// spilled 456 B); 16 chains share a 128-thread block with X in its shared
// memory, at least 4 blocks an SM. The flagship and the correlated Gaussian
// run one thread a chain through the same code (kLanes = 1, 64 threads).
// Lane 0 writes lp and the decision, every lane its own coordinates of each
// draw and of the final gradient.
//
// Noise of a step, one Philox stream (common.cuh::StepWords) keyed by the
// absolute step and the chain: the d normals' Box-Muller words 0 .. 2P-1,
// the d sign uniforms at 2P .. 2P+d-1, the accept uniform at 2P+d. Each lane
// reads only its own coordinates' words (at d = 32 lane l's normals are
// sub-block l and its signs sub-block 8 + l) and the accept word, so a split
// run resumed at an offset is bit-exact. The lane keeps delta in registers
// for the Hastings sum (coord_sum: the coordinates in order).
//
// What bounds it on this card: as MALA, one value and gradient per step (at
// d = 32, 256 observations: ~99% of the step's operations), plus 2d softplus
// and d logit tests; on 8 lanes a chain that is the group value and gradient
// of HMC's kernels (csrc/group.cuh), once a step.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py); softplus
// is max(t, 0) + logf(1 + expf(-|t|)) with a NaN-propagating max, as
// jnp.maximum in the JAX kernel.

#include "hmc_group.cuh"

namespace amh {

// One Barker step of absolute index j for chain c at step size sigma: on
// entry x, g, lp hold the current state (the lane's coordinates of x and
// g), on exit the next. Returns whether it accepted, the same in every lane
// of the chain.
template <class Density>
__device__ __forceinline__ bool group_barker_step(
    float (&x)[Density::kDim / GroupForm<Density>::kLanes], float& lp,
    float (&g)[Density::kDim / GroupForm<Density>::kLanes], float sigma, const float* sh,
    int n_consts, float* scratch, const Lanes& ln, uint32_t c, uint64_t j, uint32_t k0,
    uint32_t k1) {
  using GF = GroupForm<Density>;
  constexpr int D = Density::kDim;
  constexpr int kLanes = GF::kLanes;
  constexpr int kJ = D / kLanes;
  constexpr int P = (D + 1) / 2;
  static_assert(kLanes == 1 || kJ % 2 == 0, "a lane holds whole Box-Muller pairs");
  StepWords s(j, c, k0, k1);
  float delta[kJ], y[kJ], g_y[kJ];
  step_normals<kJ>(s, delta, ln.lane * kJ);  // the lane's coordinates' pairs
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    delta[k] = sigma * delta[k];
    const float u = s.uniform(2 * P + ln.lane * kJ + k);
    const bool keep = logf(u) - logf(1.0f - u) < delta[k] * g[k];
    delta[k] = keep ? delta[k] : -delta[k];
    y[k] = x[k] + delta[k];
  }
  const float logu = logf(s.uniform(2 * P + D));
  const float lp_y = GF::value_and_grad(y, g_y, sh, n_consts, scratch, ln);
  float t[kJ];
#pragma unroll
  for (int k = 0; k < kJ; ++k)
    t[k] = softplus((-delta[k]) * g[k]) - softplus(delta[k] * g_y[k]);
  const float logalpha = (lp_y - lp) + coord_sum<kLanes, kJ>(t, ln);
  const bool accept = -logu > -logalpha;
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    x[k] = accept ? y[k] : x[k];
    g[k] = accept ? g_y[k] : g[k];
  }
  lp = accept ? lp_y : lp;
  return accept;
}

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...). The gradient at the last
// state is written to out_grad.
template <class Density>
__global__ void __launch_bounds__(GroupShape<Density>::kThreads, GroupShape<Density>::kMinBlocks)
    barker_sample_kernel(const float* __restrict__ params_t,
                         const float* __restrict__ lp_in,
                         const float* __restrict__ grad_in,
                         const float* __restrict__ consts, int n_consts, float sigma,
                         uint32_t k0, uint32_t k1, int64_t burn, int64_t thin,
                         int64_t n_samples, uint64_t offset, int64_t C,
                         float* __restrict__ samples, float* __restrict__ lps,
                         float* __restrict__ accs, float* __restrict__ out_grad) {
  constexpr int D = Density::kDim;
  constexpr int kJ = GroupShape<Density>::kJ;
  extern __shared__ __align__(16) float sh[];
  const GroupChain ch = group_chain<Density>(sh, consts, n_consts);
  const int64_t c = ch.c;
  if (c >= C) return;  // the chain's lanes leave together
  float x[kJ], g[kJ];
  lane_load<kJ>(params_t, ch, C, x);
  lane_load<kJ>(grad_in, ch, C, g);
  float lp = lp_in[c];
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    group_barker_step<Density>(x, lp, g, sigma, sh, n_consts, ch.scratch, ch.ln, (uint32_t)c,
                               ++j, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = group_barker_step<Density>(x, lp, g, sigma, sh, n_consts, ch.scratch, ch.ln,
                                            (uint32_t)c, ++j, k0, k1);
    lane_store<kJ>(samples + e * D * C, ch, C, x);
    if (ch.ln.lane == 0) {
      lps[e * C + c] = lp;
      accs[e * C + c] = accepted ? 1.0f : 0.0f;
    }
  }
  lane_store<kJ>(out_grad, ch, C, g);
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities with a value_and_grad that the kernel is instantiated for:
// the one list of the pairs (see csrc/common.cuh).
#define AMH_BARKER_DENSITIES(X) \
  X(amh::GaussianMeanScale)     \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::LogisticRegression<32>)

extern "C" {

int amh_barker_sample(const char* density, int32_t d, const void* params_t,
                      const void* lp, const void* grad, const void* consts,
                      int32_t n_consts, float sigma, uint64_t seed, int64_t burn,
                      int64_t thin, int64_t n_samples, uint64_t offset, int64_t C,
                      void* samples, void* lps, void* accs, void* out_grad,
                      void* stream) {
#define X(T)                                                                           \
  if (amh::matches<T>(density, d))                                                     \
    return amh::launch_group<T>(                                                       \
        amh::barker_sample_kernel<T>, n_consts, C, (cudaStream_t)stream,               \
        (const float*)params_t, (const float*)lp, (const float*)grad,                  \
        (const float*)consts, n_consts, sigma, (uint32_t)seed, (uint32_t)(seed >> 32), \
        burn, thin, n_samples, offset, C, (float*)samples, (float*)lps, (float*)accs,  \
        (float*)out_grad);
  AMH_BARKER_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

// The kernel's launch shape for C chains (csrc/hmc_group.cuh::group_launch_info).
int amh_barker_info(const char* density, int32_t d, int32_t n_consts, int64_t C, int64_t* out) {
#define X(T)                       \
  if (amh::matches<T>(density, d)) \
    return amh::group_launch_info<T>(amh::barker_sample_kernel<T>, n_consts, C, out);
  AMH_BARKER_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_barker() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_BARKER_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
