// Langevin MALA kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_mala.py::_mala_kernel: burn-in, then
// n_samples thinned draws of MALA with the canonical Langevin proposal
//   y = x + (s2/2) g(x) + sqrt(s2) z,
// the asymmetric Hastings term of the two Gaussian proposal densities, and
// one value-and-gradient evaluation of the density per step, the gradient
// carried from step to step. The plain PyTorch version is
// ops/mala.py::mala_sample_reference; the C entry point at the end is bound
// there with ctypes.
//
// Layout and design as csrc/rwmh.cu: chains on the last axis (x and grad
// (d, C), lp (1, C), emitted (N, d, C) / (N, 1, C)); one thread runs one
// chain with x, lp and the gradient in registers; the density's constants
// sit in shared memory; the last block is masked. The noise of a step is
// RWMH's (d normals, one uniform, from Philox keyed by the absolute step and
// the chain), so the plain version draws it with ops/rwmh.py::step_noise and
// a split run resumed at an offset is bit-exact.
//
// What bounds it on this card: at d = 2 a step is the 30-observation value
// and gradient (~8 float operations per observation), Box-Muller and the
// accept logf, and ten Philox rounds: a dependent chain of arithmetic per
// thread, ~1.5x an RWMH step. With 16384 chains (under 4 warps per SM) the
// kernel is latency-bound, as rwmh_sample_kernel is; the emission's 16 bytes
// per chain and kept sample set the bytes bound, which lies far below the
// time the arithmetic takes. The design keeps the gradient in registers, so
// a step reads nothing from device memory but the shared constants, and
// leaves latency hiding (several chains per thread) to a later change.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py). The accept
// test is -log(u) > -logalpha, so a NaN logalpha (both lps -inf) rejects, as
// in the JAX kernel.

#include "common.cuh"

namespace amh {

constexpr int kMalaBlock = 128;

struct MalaConstants {
  float sigma;    // sqrt(s2)
  float half_s2;  // s2 / 2
  float inv_2s2;  // 1 / (2 s2)
};

// One MALA step; returns whether the proposal was accepted.
template <class Density>
__device__ __forceinline__ bool mala_step(float (&x)[Density::kDim], float& lp,
                                          float (&g)[Density::kDim],
                                          const MalaConstants& k,
                                          const float* consts, int n_consts,
                                          uint64_t j, uint32_t c, uint32_t k0,
                                          uint32_t k1) {
  constexpr int D = Density::kDim;
  // y holds the normals, then the proposal; the drift x + (s2/2) g is
  // recomputed where it is needed, so that at d = 32 only x, g, y and g_y
  // are live across the density
  float y[D], g_y[D];
  float logu;
  step_noise<D>(j, c, k0, k1, y, logu);
#pragma unroll
  for (int i = 0; i < D; ++i) y[i] = (x[i] + k.half_s2 * g[i]) + k.sigma * y[i];
  const float lp_y = Density::value_and_grad(y, consts, n_consts, g_y);
  float fwd = 0.0f, bwd = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float drift_y = y[i] + k.half_s2 * g_y[i];
    const float f = y[i] - (x[i] + k.half_s2 * g[i]);
    const float b = x[i] - drift_y;
    fwd = i == 0 ? f * f : fwd + f * f;
    bwd = i == 0 ? b * b : bwd + b * b;
  }
  const float logalpha = (lp_y - lp) + (fwd - bwd) * k.inv_2s2;
  const bool accept = -logu > -logalpha;
  if (accept) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      x[i] = y[i];
      g[i] = g_y[i];
    }
    lp = lp_y;
  }
  return accept;
}

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...). The gradient at the last
// state is written to out_grad.
template <class Density>
__global__ void __launch_bounds__(kMalaBlock)
    mala_sample_kernel(const float* __restrict__ params_t,
                       const float* __restrict__ lp_in,
                       const float* __restrict__ grad_in,
                       const float* __restrict__ consts, int n_consts,
                       MalaConstants k, uint32_t k0, uint32_t k1, int64_t burn,
                       int64_t thin, int64_t n_samples, uint64_t offset,
                       int64_t C, float* __restrict__ samples,
                       float* __restrict__ lps, float* __restrict__ accs,
                       float* __restrict__ out_grad) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh_consts[];
  load_consts(sh_consts, consts, n_consts);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[D], g[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = params_t[i * C + c];
    g[i] = grad_in[i * C + c];
  }
  float lp = lp_in[c];
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    mala_step<Density>(x, lp, g, k, sh_consts, n_consts, ++j, (uint32_t)c, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = mala_step<Density>(x, lp, g, k, sh_consts, n_consts, ++j,
                                    (uint32_t)c, k0, k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = x[i];
    lps[e * C + c] = lp;
    accs[e * C + c] = accepted ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) out_grad[i * C + c] = g[i];
}

template <class Density>
int launch_mala(const float* params_t, const float* lp, const float* grad,
                const float* consts, int n_consts, MalaConstants k,
                uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                uint64_t offset, int64_t C, float* samples, float* lps,
                float* accs, float* out_grad, cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(mala_sample_kernel<Density>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kMalaBlock - 1) / kMalaBlock));
  mala_sample_kernel<Density><<<grid, kMalaBlock, smem, stream>>>(
      params_t, lp, grad, consts, n_consts, k, (uint32_t)seed,
      (uint32_t)(seed >> 32), burn, thin, n_samples, offset, C, samples, lps,
      accs, out_grad);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities with a value_and_grad that the kernel is instantiated for:
// the one list of the pairs (see csrc/common.cuh).
#define AMH_MALA_DENSITIES(X) \
  X(amh::GaussianMeanScale)   \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::CorrelatedGaussian<4>) \
  X(amh::CorrelatedGaussian<8>) \
  X(amh::LogisticRegression<32>)

extern "C" {

int amh_mala_sample(const char* density, int32_t d, const void* params_t,
                    const void* lp, const void* grad, const void* consts,
                    int32_t n_consts, float sigma, float half_s2, float inv_2s2,
                    uint64_t seed, int64_t burn, int64_t thin,
                    int64_t n_samples, uint64_t offset, int64_t C,
                    void* samples, void* lps, void* accs, void* out_grad,
                    void* stream) {
  const amh::MalaConstants k{sigma, half_s2, inv_2s2};
#define X(T)                                                                  \
  if (amh::matches<T>(density, d))                                            \
    return amh::launch_mala<T>((const float*)params_t, (const float*)lp,      \
                               (const float*)grad, (const float*)consts,      \
                               n_consts, k, seed, burn, thin, n_samples,      \
                               offset, C, (float*)samples, (float*)lps,       \
                               (float*)accs, (float*)out_grad,                \
                               (cudaStream_t)stream);
  AMH_MALA_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_mala() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_MALA_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
