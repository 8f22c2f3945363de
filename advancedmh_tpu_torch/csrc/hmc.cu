// Fixed-step HMC kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_hmc.py::_hmc_kernel: burn-in, then
// n_samples thinned draws of endpoint HMC with step size eps, n_leapfrog
// leapfrog steps, a diagonal inverse mass shared by all chains (one (d, 1)
// column), momenta z / sqrt(M^-1) and the exact energy-error accept
// -log u > -logalpha. The plain PyTorch version is
// ops/hmc.py::hmc_sample_reference; the C entry point at the end is bound
// there with ctypes.
//
// Design: the group step of csrc/hmc_group.cuh, as AdaptiveHMC's frozen
// phase (csrc/hmc_adapt.cu). On the logistic regression a chain runs on 8
// lanes, lane l holding coordinates [4 l, 4 l + 4) of x, g, the fall-back
// (x0, g0) and M^-1 in registers; a block of 128 threads runs 16 chains with
// X in its shared memory (rows padded, csrc/group.cuh) and the chains'
// scratch beside it, at least 4 blocks an SM. Lane 0 writes lp and the
// decision, every lane its own coordinates of each draw and of the final
// gradient. The flagship and the correlated Gaussian run one thread per
// chain through the same code (kLanes = 1, 64 threads). The noise of a step
// is RWMH's (d normals, one uniform, from Philox keyed by the absolute step
// and the chain; each lane draws its own coordinates' words), so a split run
// resumed at an offset is bit-exact.
//
// What bounds it on this card: at d = 32 and 256 observations of the
// logistic regression a value and gradient is ~16 float operations per
// (observation, coordinate) pair and a step n_leapfrog of them. The
// operations bound is ~0.16 s for the 8192 x 4500 x 8 value-and-gradients of
// the main path's shape (chip_smoke.py::bound_hmc); the bytes bound (the
// emission) is far below. Under --fmad=false every multiply and add is its
// own instruction, so the floor is twice that bound; 8 lanes a chain give
// each scheduler 4 warps to issue from, where one thread a chain left one
// dependent stream.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py).

#include "hmc_group.cuh"

namespace amh {

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...). The last state's
// gradient is left in g_state.
template <class Density>
__global__ void __launch_bounds__(GroupShape<Density>::kThreads, GroupShape<Density>::kMinBlocks)
    hmc_sample_kernel(const float* __restrict__ params_t, const float* __restrict__ lp_in,
                      const float* __restrict__ grad_in, const float* __restrict__ minv_col,
                      const float* __restrict__ consts, int n_consts, float eps,
                      int n_leapfrog, uint32_t k0, uint32_t k1, int64_t burn, int64_t thin,
                      int64_t n_samples, uint64_t offset, int64_t C,
                      float* __restrict__ samples, float* __restrict__ lps,
                      float* __restrict__ accs, float* __restrict__ g_state) {
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
    minv[k] = minv_col[ch.j0 + k];
  }
  float lp = lp_in[c];
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    group_hmc_step<Density>(x, lp, g, x0, g0, minv, eps, n_leapfrog, sh, n_consts,
                            ch.scratch, ch.ln, c, ++j, k0, k1);
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
  lane_store<kJ>(g_state, ch, C, g);
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities with a value_and_grad that the kernel is instantiated for:
// the one list of the pairs (see csrc/common.cuh).
#define AMH_HMC_DENSITIES(X)    \
  X(amh::GaussianMeanScale)     \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::LogisticRegression<32>)

extern "C" {

int amh_hmc_sample(const char* density, int32_t d, const void* params_t,
                   const void* lp, const void* grad, const void* minv,
                   const void* consts, int32_t n_consts, float eps,
                   int32_t n_leapfrog, uint64_t seed, int64_t burn,
                   int64_t thin, int64_t n_samples, uint64_t offset, int64_t C,
                   void* samples, void* lps, void* accs, void* g_state, void* stream) {
#define X(T)                                                                           \
  if (amh::matches<T>(density, d))                                                     \
    return amh::launch_group<T>(                                                       \
        amh::hmc_sample_kernel<T>, n_consts, C, (cudaStream_t)stream,                  \
        (const float*)params_t, (const float*)lp, (const float*)grad,                  \
        (const float*)minv, (const float*)consts, n_consts, eps, n_leapfrog,           \
        (uint32_t)seed, (uint32_t)(seed >> 32), burn, thin, n_samples, offset, C,      \
        (float*)samples, (float*)lps, (float*)accs, (float*)g_state);
  AMH_HMC_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

// The kernel's launch shape for C chains (csrc/hmc_group.cuh::group_launch_info).
int amh_hmc_info(const char* density, int32_t d, int32_t n_consts, int64_t C, int64_t* out) {
#define X(T)                   \
  if (amh::matches<T>(density, d)) \
    return amh::group_launch_info<T>(amh::hmc_sample_kernel<T>, n_consts, C, out);
  AMH_HMC_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_hmc() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_HMC_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
