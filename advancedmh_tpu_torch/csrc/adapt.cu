// Dual-averaging RWMH kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_adapt.py::_adapt_rwmh_kernel: `warmup`
// isotropic random-walk steps y = x + eps z that adapt each chain's eps by
// HG14 dual averaging on the accept indicator (common.cuh::dual_average),
// then n_samples thinned draws at the frozen eps_bar = exp(log eps_bar). The
// resume variant (kResume) runs no warmup and starts frozen at a given
// per-chain log eps_bar; both form eps_bar as expf of the same stored
// log eps_bar, so a run split after its warmup and resumed is bit-exact. The
// plain PyTorch version is ops/adapt.py::adapt_rwmh_reference; the C entry
// point at the end is bound there with ctypes.
//
// Layout and design as csrc/rwmh.cu: chains on the last axis, one thread
// per chain with x, lp and the three adaptation statistics in registers,
// the density's constants in shared memory, the last block masked. Each step
// takes its noise from step_noise of its absolute index (RWMH's), through
// warmup and sampling alike; the TPU kernel's pairing of normals across two
// steps (a Mosaic layout choice) is not carried over.
//
// What bounds it on this card: as rwmh_sample_kernel, a dependent chain of
// arithmetic per thread (the density, Box-Muller and the accept logf; a
// warmup step adds one expf, one logf, one sqrtf and the averaging): latency,
// with 16384 chains under 4 warps per SM. The emission's bytes set a bound
// far below.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py). The accept
// test is log u < lp_y - lp, so a NaN candidate rejects.

#include "common.cuh"

namespace amh {

constexpr int kAdaptBlock = 128;

// One isotropic RWMH step; returns whether the proposal was accepted.
template <class Density>
__device__ __forceinline__ bool iso_step(float (&x)[Density::kDim], float& lp,
                                         float eps, const float* consts,
                                         int n_consts, uint64_t j, uint32_t c,
                                         uint32_t k0, uint32_t k1) {
  constexpr int D = Density::kDim;
  float y[D];
  float logu;
  step_noise<D>(j, c, k0, k1, y, logu);
#pragma unroll
  for (int i = 0; i < D; ++i) y[i] = x[i] + eps * y[i];
  const float lp_y = Density::logp(y, consts, n_consts);
  const bool accept = logu < lp_y - lp;
  if (accept) {
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = y[i];
    lp = lp_y;
  }
  return accept;
}

// Sample e is the state after warmup + (e+1)*thin steps; step t of the
// launch is absolute iteration offset + t (t = 1, 2, ...).
template <class Density, bool kResume>
__global__ void __launch_bounds__(kAdaptBlock)
    adapt_rwmh_kernel(const float* __restrict__ params_t,
                      const float* __restrict__ lp_in,
                      const float* __restrict__ leb_in,
                      const float* __restrict__ consts, int n_consts,
                      DualAveraging da, uint32_t k0, uint32_t k1,
                      int64_t warmup, int64_t thin, int64_t n_samples,
                      uint64_t offset, int64_t C, float* __restrict__ samples,
                      float* __restrict__ lps, float* __restrict__ accs,
                      float* __restrict__ leb_out) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh_consts[];
  load_consts(sh_consts, consts, n_consts);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = params_t[i * C + c];
  float lp = lp_in[c];
  uint64_t j = offset;
  float leb;
  if (kResume) {
    leb = leb_in[c];
  } else {
    float log_eps = da.log_eps0, h_bar = 0.0f;
    leb = da.log_eps0;
    for (int64_t t = 1; t <= warmup; ++t) {
      const bool acc = iso_step<Density>(x, lp, expf(log_eps), sh_consts, n_consts,
                                         ++j, (uint32_t)c, k0, k1);
      dual_average(da, (float)t, acc ? 1.0f : 0.0f, log_eps, leb, h_bar);
    }
  }
  const float eps = expf(leb);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = iso_step<Density>(x, lp, eps, sh_consts, n_consts, ++j,
                                   (uint32_t)c, k0, k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = x[i];
    lps[e * C + c] = lp;
    accs[e * C + c] = accepted ? 1.0f : 0.0f;
  }
  leb_out[c] = leb;
}

template <class Density, bool kResume>
int launch_adapt(const float* params_t, const float* lp, const float* leb_in,
                 const float* consts, int n_consts, DualAveraging da,
                 uint64_t seed, int64_t warmup, int64_t thin, int64_t n_samples,
                 uint64_t offset, int64_t C, float* samples, float* lps,
                 float* accs, float* leb_out, cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(adapt_rwmh_kernel<Density, kResume>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kAdaptBlock - 1) / kAdaptBlock));
  adapt_rwmh_kernel<Density, kResume><<<grid, kAdaptBlock, smem, stream>>>(
      params_t, lp, leb_in, consts, n_consts, da, (uint32_t)seed,
      (uint32_t)(seed >> 32), warmup, thin, n_samples, offset, C, samples, lps,
      accs, leb_out);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities the kernel is instantiated for (each fresh and resumed):
// the one list of the pairs (see csrc/common.cuh).
#define AMH_ADAPT_DENSITIES(X) \
  X(amh::GaussianMeanScale)    \
  X(amh::CorrelatedGaussian<2>)

extern "C" {

int amh_adapt_rwmh_sample(const char* density, int32_t d, int32_t resume,
                          const void* params_t, const void* lp,
                          const void* leb_in, const void* consts,
                          int32_t n_consts, float target, float t0, float kappa,
                          float gamma, float mu, float log_eps0, uint64_t seed,
                          int64_t warmup, int64_t thin, int64_t n_samples,
                          uint64_t offset, int64_t C, void* samples, void* lps,
                          void* accs, void* leb_out, void* stream) {
  const amh::DualAveraging da{target, t0, kappa, gamma, mu, log_eps0};
#define X(T)                                                                  \
  if (amh::matches<T>(density, d))                                            \
    return (resume ? amh::launch_adapt<T, true> : amh::launch_adapt<T, false>)( \
        (const float*)params_t, (const float*)lp, (const float*)leb_in,       \
        (const float*)consts, n_consts, da, seed, warmup, thin, n_samples,    \
        offset, C, (float*)samples, (float*)lps, (float*)accs,                \
        (float*)leb_out, (cudaStream_t)stream);
  AMH_ADAPT_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_adapt() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_ADAPT_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
