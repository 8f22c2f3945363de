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
// Layout and design as csrc/mala.cu: chains on the last axis (x and grad
// (d, C), lp (1, C), emitted (N, d, C) / (N, 1, C)); one thread runs one
// chain with x, lp and the gradient in registers; the density's constants sit
// in shared memory; the last block is masked. The noise of a step is one
// Philox stream (common.cuh::StepWords): the d normals' Box-Muller words
// 0 .. 2P-1, the d sign uniforms at 2P .. 2P+d-1, the accept uniform at
// 2P+d. To keep only x, g, y and g_y live across the density (as MALA) at
// d = 32, the kernel keeps the signs as bits and draws the normals a second
// time after the density for the Hastings sum: the same words, so the same
// delta.
//
// What bounds it on this card: as MALA, one value and gradient per step (at
// d = 32, 256 observations: ~99% of the step's operations), plus 2d softplus
// and d logit tests; a dependent chain per thread, latency-bound at 8192 and
// 16384 chains (2-4 warps per SM). The emission's bytes set a bound below.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py); softplus
// is max(t, 0) + logf(1 + expf(-|t|)) with a NaN-propagating max, as
// jnp.maximum in the JAX kernel.

#include "common.cuh"

namespace amh {

// 64 threads a block: 8192 chains make 128 blocks, one on each of 128 of the
// 132 SMs; 128-thread blocks would fill only 64 SMs (on an H100 the ESS
// kernel then ran 17-25% slower; the others within 5%).
constexpr int kBarkerBlock = 64;

// The d normals of the step, scaled by sigma.
template <int D>
__device__ __forceinline__ void barker_normals(StepWords& s, float sigma, float (&z)[D]) {
  step_normals<D>(s, z);
#pragma unroll
  for (int i = 0; i < D; ++i) z[i] = sigma * z[i];
}

// One Barker step; returns whether the proposal was accepted.
template <class Density>
__device__ __forceinline__ bool barker_step(float (&x)[Density::kDim], float& lp,
                                            float (&g)[Density::kDim], float sigma,
                                            const float* consts, int n_consts,
                                            uint64_t j, uint32_t c, uint32_t k0,
                                            uint32_t k1) {
  constexpr int D = Density::kDim;
  constexpr int P = (D + 1) / 2;
  constexpr int kMasks = (D + 31) / 32;
  StepWords s(j, c, k0, k1);
  float y[D], g_y[D];
  barker_normals<D>(s, sigma, y);  // y holds z, then the proposal
  uint32_t keep[kMasks];
#pragma unroll
  for (int m = 0; m < kMasks; ++m) keep[m] = 0u;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float u = s.uniform(2 * P + i);
    const bool k = logf(u) - logf(1.0f - u) < y[i] * g[i];
    if (k) keep[i / 32] |= 1u << (i % 32);
    y[i] = x[i] + (k ? y[i] : -y[i]);
  }
  const float logu = logf(s.uniform(2 * P + D));
  const float lp_y = Density::value_and_grad(y, consts, n_consts, g_y);
  // the Hastings sum, with delta drawn again: the same words give the same z
  StepWords s2(j, c, k0, k1);
  float lr = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float z2[2];
    const float u1 = s2.uniform(2 * p);
    const float u2 = s2.uniform(2 * p + 1);
    const float r = sqrtf(-2.0f * logf(u1));
    float sn, cs;
    sincosf(kTwoPi * u2, &sn, &cs);
    z2[0] = sigma * (r * cs);
    z2[1] = sigma * (r * sn);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * p + h;
      if (i < D) {
        const float delta = (keep[i / 32] >> (i % 32)) & 1u ? z2[h] : -z2[h];
        const float term = softplus((-delta) * g[i]) - softplus(delta * g_y[i]);
        lr = i == 0 ? term : lr + term;
      }
    }
  }
  const float logalpha = (lp_y - lp) + lr;
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
__global__ void __launch_bounds__(kBarkerBlock)
    barker_sample_kernel(const float* __restrict__ params_t,
                         const float* __restrict__ lp_in,
                         const float* __restrict__ grad_in,
                         const float* __restrict__ consts, int n_consts, float sigma,
                         uint32_t k0, uint32_t k1, int64_t burn, int64_t thin,
                         int64_t n_samples, uint64_t offset, int64_t C,
                         float* __restrict__ samples, float* __restrict__ lps,
                         float* __restrict__ accs, float* __restrict__ out_grad) {
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
    barker_step<Density>(x, lp, g, sigma, sh_consts, n_consts, ++j, (uint32_t)c, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = barker_step<Density>(x, lp, g, sigma, sh_consts, n_consts, ++j,
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
int launch_barker(const float* params_t, const float* lp, const float* grad,
                  const float* consts, int n_consts, float sigma, uint64_t seed,
                  int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
                  int64_t C, float* samples, float* lps, float* accs, float* out_grad,
                  cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(barker_sample_kernel<Density>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kBarkerBlock - 1) / kBarkerBlock));
  barker_sample_kernel<Density><<<grid, kBarkerBlock, smem, stream>>>(
      params_t, lp, grad, consts, n_consts, sigma, (uint32_t)seed,
      (uint32_t)(seed >> 32), burn, thin, n_samples, offset, C, samples, lps, accs,
      out_grad);
  return (int)cudaGetLastError();
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
#define X(T)                                                                      \
  if (amh::matches<T>(density, d))                                                \
    return amh::launch_barker<T>((const float*)params_t, (const float*)lp,        \
                                 (const float*)grad, (const float*)consts,        \
                                 n_consts, sigma, seed, burn, thin, n_samples,    \
                                 offset, C, (float*)samples, (float*)lps,         \
                                 (float*)accs, (float*)out_grad,                  \
                                 (cudaStream_t)stream);
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
