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
// Layout and design: csrc/hmc.cuh (one thread per chain; the trajectory and
// M^-1 in registers, the state to fall back to in device memory). The noise
// of a step is RWMH's (d normals, one uniform, from Philox keyed by the
// absolute step and the chain), so a split run resumed at an offset is
// bit-exact.
//
// What bounds it on this card: at d = 32 and 256 observations of the
// logistic regression a value and gradient is ~16 float operations per
// (observation, coordinate) pair and a step n_leapfrog of them, all
// dependent arithmetic inside one thread. The operations bound is
// ~0.16 s for the 8192 x 4500 x 8 value-and-gradients of the main path's
// shape (chip_smoke.py::bound_hmc); the bytes bound (the emission) is far
// below. 8192 chains are 128 blocks of 64 threads, 2 warps per SM, so one
// thread's chain of dependent instructions, not the SM's issue rate, sets
// the time: the kernel is latency-bound, and runs at most one warp per
// scheduler. Splitting a chain's observation sum over a warp (lane j
// owning coordinate j) is the next step.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py).

#include "hmc.cuh"

namespace amh {

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...). The last state's
// gradient is left in g_state.
template <class Density>
__global__ void __launch_bounds__(kHmcBlock)
    hmc_sample_kernel(const float* __restrict__ params_t,
                      const float* __restrict__ lp_in,
                      const float* __restrict__ grad_in,
                      const float* __restrict__ minv_col,
                      const float* __restrict__ consts, int n_consts, float eps,
                      int n_leapfrog, uint32_t k0, uint32_t k1, int64_t burn,
                      int64_t thin, int64_t n_samples, uint64_t offset,
                      int64_t C, float* __restrict__ samples,
                      float* __restrict__ lps, float* __restrict__ accs,
                      float* __restrict__ x_state, float* __restrict__ g_state) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh_consts[];
  load_consts(sh_consts, consts, n_consts);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[D], g[D], minv[D];
  hmc_load<D>(params_t, grad_in, x, g, x_state, g_state, c, C);
#pragma unroll
  for (int i = 0; i < D; ++i) minv[i] = minv_col[i];
  float lp = lp_in[c];
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    hmc_step<Density>(x, lp, g, minv, eps, n_leapfrog, sh_consts, n_consts,
                      x_state, g_state, c, C, ++j, k0, k1);
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
}

template <class Density>
int launch_hmc(const float* params_t, const float* lp, const float* grad,
               const float* minv, const float* consts, int n_consts, float eps,
               int n_leapfrog, uint64_t seed, int64_t burn, int64_t thin,
               int64_t n_samples, uint64_t offset, int64_t C, float* samples,
               float* lps, float* accs, float* x_state, float* g_state,
               cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(hmc_sample_kernel<Density>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kHmcBlock - 1) / kHmcBlock));
  hmc_sample_kernel<Density><<<grid, kHmcBlock, smem, stream>>>(
      params_t, lp, grad, minv, consts, n_consts, eps, n_leapfrog,
      (uint32_t)seed, (uint32_t)(seed >> 32), burn, thin, n_samples, offset, C,
      samples, lps, accs, x_state, g_state);
  return (int)cudaGetLastError();
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
                   void* samples, void* lps, void* accs, void* x_state,
                   void* g_state, void* stream) {
#define X(T)                                                                 \
  if (amh::matches<T>(density, d))                                           \
    return amh::launch_hmc<T>((const float*)params_t, (const float*)lp,      \
                              (const float*)grad, (const float*)minv,        \
                              (const float*)consts, n_consts, eps,           \
                              n_leapfrog, seed, burn, thin, n_samples, offset, \
                              C, (float*)samples, (float*)lps, (float*)accs, \
                              (float*)x_state, (float*)g_state,              \
                              (cudaStream_t)stream);
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
