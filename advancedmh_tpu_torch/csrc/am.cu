// Adaptive Metropolis kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_am.py::_am_kernel: burn-in, then
// n_samples thinned draws of Adaptive Metropolis in Roberts & Rosenthal's
// (2009) mixture form, with the chain's running covariance held as its
// Cholesky factor L and advanced on every step:
//   fixed = U_mix < beta or n <= adapt_start  (n the count before the step),
//   y = x + fs z  (fixed),  y = x + os L z  (adapted),
//     fs = fixed_scale / sqrt(d), os = opt_scale / sqrt(d), each rounded
//     once from float64,
//   accepted iff -log U_acc > -(lp_y - lp)  (the mixture is symmetric),
//   then (mean, L, n) advance with the realized state
//   (common.cuh::welford_chol_advance).
// The plain PyTorch version is ops/am.py::am_sample_reference; the C entry
// point at the end is bound there with ctypes.
//
// Noise of absolute step j of chain c (common.cuh::StepWords): the d
// normals' Box-Muller words 0 .. 2P-1, the mixture uniform at word 2P, the
// accept uniform at word 2P+1 (P = ceil(d/2)).
//
// Layout and the launch body: csrc/am.cuh. JAX raises above d = 8 (the
// unrolled sweep), and so does the wrapper; the registry below lists the
// instantiated d.
//
// What bounds it on this card: per step Box-Muller and two Philox blocks at
// d = 2, the density, and the Welford advance -- a divide, two square
// roots, d divides and square roots in the sweep and O(d^2) multiplies: a
// dependent chain of arithmetic per thread, latency-bound at 16384 chains
// (4 warps per SM). The emission's (d + 2) floats a chain and draw set a
// bytes bound far below. The design keeps the state and the packed factor in
// registers and touches memory only to emit.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py). The
// advance is the Pallas kernel's order -- inv = 1/(n+1), shrink =
// sqrt(n inv), coeff = sqrt(n) inv -- where the torch engine
// (samplers/am.py) has XLA's sqrt(n/(n+1)) and sqrt(n)/(n+1), which round
// differently.

#include "am.cuh"

namespace amh {

struct AmStep {
  float beta;         // weight of the fixed component
  float fs;           // fixed_scale / sqrt(d)
  float os;           // opt_scale / sqrt(d)
  float adapt_start;  // the adapted component waits while n <= adapt_start

  template <class Density>
  __device__ __forceinline__ bool advance(AmState<Density::kDim>& s, const float* consts,
                                          int n_consts, uint64_t j, uint32_t c, uint32_t k0,
                                          uint32_t k1) const {
    constexpr int D = Density::kDim;
    constexpr int P = (D + 1) / 2;
    StepWords w(j, c, k0, k1);
    float z[D], y[D];
    step_normals<D>(w, z);
    const bool fixed = w.uniform(2 * P) < beta || s.n <= adapt_start;
    if (fixed) {
#pragma unroll
      for (int i = 0; i < D; ++i) y[i] = s.x[i] + fs * z[i];
    } else {
      tri_matvec<D>(s.L, z, y);
#pragma unroll
      for (int i = 0; i < D; ++i) y[i] = s.x[i] + os * y[i];
    }
    const float lp_y = Density::logp(y, consts, n_consts);
    const float e = -logf(w.uniform(2 * P + 1));
    const bool accept = e > -(lp_y - s.lp);
    if (accept) {
#pragma unroll
      for (int i = 0; i < D; ++i) s.x[i] = y[i];
      s.lp = lp_y;
    }
    welford_chol_advance<D>(s.x, s.mean, s.L, s.n);
    return accept;
  }
};

template <class Density>
__global__ void __launch_bounds__(kAmBlock)
    am_sample_kernel(AmStep step, const float* __restrict__ x_in,
                     const float* __restrict__ lp_in, const float* __restrict__ mean_in,
                     const float* __restrict__ L_in, const float* __restrict__ n_in,
                     const float* __restrict__ consts, int n_consts, uint32_t k0,
                     uint32_t k1, int64_t burn, int64_t thin, int64_t n_samples,
                     uint64_t offset, int64_t C, float* __restrict__ samples,
                     float* __restrict__ lps, float* __restrict__ accs,
                     float* __restrict__ mean_out, float* __restrict__ L_out,
                     float* __restrict__ n_out) {
  am_family_run<Density>(step, x_in, lp_in, mean_in, L_in, n_in, consts, n_consts, k0, k1,
                         burn, thin, n_samples, offset, C, samples, lps, accs, mean_out,
                         L_out, n_out);
}

template <class Density>
int launch_am(AmStep step, const float* x, const float* lp, const float* mean,
              const float* L, const float* n, const float* consts, int n_consts,
              uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
              int64_t C, float* samples, float* lps, float* accs, float* mean_out,
              float* L_out, float* n_out, cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(am_sample_kernel<Density>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kAmBlock - 1) / kAmBlock));
  am_sample_kernel<Density><<<grid, kAmBlock, smem, stream>>>(
      step, x, lp, mean, L, n, consts, n_consts, (uint32_t)seed, (uint32_t)(seed >> 32),
      burn, thin, n_samples, offset, C, samples, lps, accs, mean_out, L_out, n_out);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities the kernel is instantiated for: the one list of the pairs
// (see csrc/common.cuh).
#define AMH_AM_DENSITIES(X)     \
  X(amh::GaussianMeanScale)     \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::CorrelatedGaussian<4>) \
  X(amh::CorrelatedGaussian<8>) \
  X(amh::Banana)

extern "C" {

int amh_am_sample(const char* density, int32_t d, const void* x, const void* lp,
                  const void* mean, const void* L, const void* n, const void* consts,
                  int32_t n_consts, float beta, float fs, float os, float adapt_start,
                  uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                  uint64_t offset, int64_t C, void* samples, void* lps, void* accs,
                  void* mean_out, void* L_out, void* n_out, void* stream) {
  const amh::AmStep step{beta, fs, os, adapt_start};
#define X(T)                                                                         \
  if (amh::matches<T>(density, d))                                                   \
    return amh::launch_am<T>(step, (const float*)x, (const float*)lp,                \
                             (const float*)mean, (const float*)L, (const float*)n,   \
                             (const float*)consts, n_consts, seed, burn, thin,       \
                             n_samples, offset, C, (float*)samples, (float*)lps,     \
                             (float*)accs, (float*)mean_out, (float*)L_out,          \
                             (float*)n_out, (cudaStream_t)stream);
  AMH_AM_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_am() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_AM_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
