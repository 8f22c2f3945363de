// Slice-sampling kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_slice.py::_slice_kernel: burn-in, then
// n_samples thinned draws of Neal's slice sampler along a random unit
// direction u = z / |z|:
//   log y = lp + log U,  [L, R] = [-w U0, -w U0 + w],
//   stepping out with Neal's budget m split J = floor(m V) left and
//   K = m - 1 - J right, then at most max_shrink shrink trips
//   t = L + U_k (R - L), accepting x + t u iff lp > log y (strict: false for
//   NaN), else the rejected t becomes the bracket end on its own side of 0.
// A chain that exhausts its trips keeps its state and reports accepted = 0.
// The plain PyTorch version is ops/slice.py::slice_sample_reference; the C
// entry point at the end is bound there with ctypes.
//
// Layout and design as csrc/rwmh.cu: chains on the last axis, one thread per
// chain with x, lp and the direction in registers, the density's constants
// in shared memory, the last block masked. The TPU kernel spends exactly
// 2 (m - 1) + max_shrink density evaluations a step, because Mosaic runs
// data-dependent trip counts poorly; here a thread stops as soon as its
// chain is done: each end of the bracket grows on its own budget while it
// lies in the slice (the alternating masked loop gives the same L and R),
// and the shrink loop ends at the first point in the slice. Trip k's uniform
// is word 2P+3+k of the step's Philox stream (common.cuh::StepWords, one
// 4-word block computed when first needed), so the trips a chain skips
// change nothing.
//
// What bounds it on this card: the density evaluations a step really makes
// (4.4 a chain-step on the funnel) times the functor, a dependent chain of
// arithmetic per thread; with 8192 chains (one 64-thread block per SM) the
// kernel is latency-bound, and the trip counts differ from chain to chain, so a warp
// waits for its slowest chain. The emission's bytes set a bound far below.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py). The
// direction is z * (1 / sqrtf(max(sum z^2, 1e-30))), where JAX has rsqrt:
// CUDA's rsqrtf is not correctly rounded, and the plain version divides.

#include "common.cuh"

namespace amh {

// 64 threads a block: 8192 chains make 128 blocks, one on each of 128 of the
// 132 SMs; 128-thread blocks would fill only 64 SMs (on an H100 the ESS
// kernel then ran 17-25% slower; the others within 5%).
constexpr int kSliceBlock = 64;

struct SliceConstants {
  float width;
  int max_stepout;
  int max_shrink;
};

// One slice step; returns whether the chain found a point in the slice.
template <class Density>
__device__ __forceinline__ bool slice_step(float (&x)[Density::kDim], float& lp,
                                           const SliceConstants& k,
                                           const float* consts, int n_consts,
                                           uint64_t j, uint32_t c, uint32_t k0,
                                           uint32_t k1) {
  constexpr int D = Density::kDim;
  constexpr int P = (D + 1) / 2;
  StepWords s(j, c, k0, k1);
  float u[D];
  step_normals<D>(s, u);
  float sq = u[0] * u[0];
#pragma unroll
  for (int i = 1; i < D; ++i) sq = sq + u[i] * u[i];
  const float inv = 1.0f / sqrtf(nan_max(sq, 1e-30f));
#pragma unroll
  for (int i = 0; i < D; ++i) u[i] = u[i] * inv;
  const float logy = lp + logf(s.uniform(2 * P));
  const float w = k.width;
  float L = (-w) * s.uniform(2 * P + 1);
  float R = L + w;
  float J = floorf((float)k.max_stepout * s.uniform(2 * P + 2));
  float K = ((float)k.max_stepout - 1.0f) - J;
  float cand[D];
  auto ld_at = [&](float t) {
#pragma unroll
    for (int i = 0; i < D; ++i) cand[i] = x[i] + t * u[i];
    return Density::logp(cand, consts, n_consts);
  };
  while (J > 0.5f && ld_at(L) > logy) {
    L = L - w;
    J = J - 1.0f;
  }
  while (K > 0.5f && ld_at(R) > logy) {
    R = R + w;
    K = K - 1.0f;
  }
  for (int trip = 0; trip < k.max_shrink; ++trip) {
    const float t = L + s.uniform(2 * P + 3 + trip) * (R - L);
    const float lp_c = ld_at(t);
    if (lp_c > logy) {
#pragma unroll
      for (int i = 0; i < D; ++i) x[i] = cand[i];
      lp = lp_c;
      return true;
    }
    if (t < 0.0f)
      L = t;
    else
      R = t;
  }
  return false;
}

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...).
template <class Density>
__global__ void __launch_bounds__(kSliceBlock)
    slice_sample_kernel(const float* __restrict__ params_t,
                        const float* __restrict__ lp_in,
                        const float* __restrict__ consts, int n_consts,
                        SliceConstants k, uint32_t k0, uint32_t k1, int64_t burn,
                        int64_t thin, int64_t n_samples, uint64_t offset, int64_t C,
                        float* __restrict__ samples, float* __restrict__ lps,
                        float* __restrict__ accs) {
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
  for (int64_t t = 0; t < burn; ++t)
    slice_step<Density>(x, lp, k, sh_consts, n_consts, ++j, (uint32_t)c, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool done = false;
    for (int64_t t = 0; t < thin; ++t)
      done = slice_step<Density>(x, lp, k, sh_consts, n_consts, ++j, (uint32_t)c, k0,
                                 k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = x[i];
    lps[e * C + c] = lp;
    accs[e * C + c] = done ? 1.0f : 0.0f;
  }
}

template <class Density>
int launch_slice(const float* params_t, const float* lp, const float* consts,
                 int n_consts, SliceConstants k, uint64_t seed, int64_t burn,
                 int64_t thin, int64_t n_samples, uint64_t offset, int64_t C,
                 float* samples, float* lps, float* accs, cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(slice_sample_kernel<Density>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kSliceBlock - 1) / kSliceBlock));
  slice_sample_kernel<Density><<<grid, kSliceBlock, smem, stream>>>(
      params_t, lp, consts, n_consts, k, (uint32_t)seed, (uint32_t)(seed >> 32), burn,
      thin, n_samples, offset, C, samples, lps, accs);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities the kernel is instantiated for: the one list of the pairs
// (see csrc/common.cuh).
#define AMH_SLICE_DENSITIES(X)  \
  X(amh::GaussianMeanScale)     \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::NealFunnel<10>)

extern "C" {

int amh_slice_sample(const char* density, int32_t d, const void* params_t,
                     const void* lp, const void* consts, int32_t n_consts, float width,
                     int32_t max_stepout, int32_t max_shrink, uint64_t seed, int64_t burn,
                     int64_t thin, int64_t n_samples, uint64_t offset, int64_t C,
                     void* samples, void* lps, void* accs, void* stream) {
  const amh::SliceConstants k{width, max_stepout, max_shrink};
#define X(T)                                                                     \
  if (amh::matches<T>(density, d))                                               \
    return amh::launch_slice<T>((const float*)params_t, (const float*)lp,        \
                                (const float*)consts, n_consts, k, seed, burn, thin, \
                                n_samples, offset, C, (float*)samples,           \
                                (float*)lps, (float*)accs, (cudaStream_t)stream);
  AMH_SLICE_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_slice() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_SLICE_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
