// Multiple-Try Metropolis kernels for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_mtm.py:
//   mtm_sample_kernel <- _mtm_sampling_kernel (burn-in, then thinned
//                        emission of samples / lps / accepted),
//   mtm_kernel        <- _mtm_kernel (n_steps with no emission; returns the
//                        final params, lp and accept counts),
//   mtm_step          <- _mtm_step_fn.
// The plain PyTorch versions are in ops/mtm.py; the C entry points at the
// end are bound there with ctypes.
//
// One step from x with log density lp draws k candidates y_i = x + s z_i
// (per-dimension s, or L z_i for a lower-triangular L), selects one with a
// streaming Gumbel-argmax over lp(y_i) + g_i (strict >, so the first index
// wins a tie, as XLA's argmax), draws k - 1 references around the winner
// and accepts with
//   log alpha = logsumexp(lp(y_1..y_k)) - logsumexp(lp(r_1..r_{k-1}), lp(x)),
// both logsumexps streamed as running (max, scaled sum) pairs, so the state
// of a step is O(1) in k and k is a runtime argument. Every density is
// clamped at -1e30 with a NaN-keeping max (jnp.maximum), as the Pallas
// kernel clamps it: then a step whose current state, candidates and
// references all sit at -1e30 has log alpha = log k - log k = 0 and accepts
// (XLA's unclamped logsumexp gives -inf - (-inf) = NaN there and rejects;
// ROADMAP.md records the divergence). The accepted lp is the clamped one.
//
// Noise of absolute step j of chain c (common.cuh::StepWords, P = ceil(d/2)
// Box-Muller pairs): candidate i reads its normals from words
// i (2P + 1) .. i (2P + 1) + 2P - 1 and its Gumbel uniform from word
// i (2P + 1) + 2P; reference r reads k (2P + 1) + 2P r .. + 2P - 1; the
// accept uniform is word k (2P + 1) + 2P (k - 1). (The Pallas kernel shares
// Box-Muller halves across candidates; here every draw has words of its own.)
//
// Layout and design as csrc/rwmh.cu: chains on the last axis (params (d, C),
// lp (1, C), emitted (N, d, C) and (N, 1, C)), one thread per chain with x,
// the winner and the running sums in registers, the last block masked.
// Shared memory holds the density's constants, then the scale (d or d*d
// floats).
//
// What bounds it on this card: 2k - 1 densities a step (the flagship's 30
// observations each), 2k - 1 Box-Muller sets, k Gumbel draws and 4k - 4
// expf -- a long dependent chain of arithmetic per thread, latency-bound at
// 16384 chains (under 4 warps per SM); the bytes of the emission set a bound
// far below.
//
// Numerics: --fmad=false, no --use_fast_math, as the other kernels.

#include "common.cuh"

namespace amh {

constexpr int kMtmBlock = 64;
constexpr float kNegClamp = -1.0e30f;

template <int D, bool kTril>
__device__ __forceinline__ void perturb(const float (&x)[D], const float* scale,
                                        const float (&z)[D], float (&y)[D]) {
  if (kTril) {
    tril_matvec<D>(scale, z, y);
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] = x[i] + y[i];
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) y[i] = x[i] + scale[i] * z[i];
  }
}

// One MTM step of k tries; returns whether the winner was accepted.
template <class Density, bool kTril>
__device__ __forceinline__ bool mtm_step(float (&x)[Density::kDim], float& lp,
                                         const float* scale, const float* consts,
                                         int n_consts, int k, uint64_t j, uint32_t c,
                                         uint32_t k0, uint32_t k1) {
  constexpr int D = Density::kDim;
  constexpr int P = (D + 1) / 2;
  StepWords w(j, c, k0, k1);
  float best[D], z[D], y[D];
  float best_lp = 0.0f, best_score = 0.0f, m = 0.0f, s = 0.0f;
  for (int i = 0; i < k; ++i) {
    const int w0 = i * (2 * P + 1);
    step_normals<D>(w, z, w0);
    perturb<D, kTril>(x, scale, z, y);
    const float lp_y = nan_max(Density::logp(y, consts, n_consts), kNegClamp);
    const float score = lp_y + -logf(-logf(w.uniform(w0 + 2 * P)));
    if (i == 0) {
#pragma unroll
      for (int q = 0; q < D; ++q) best[q] = y[q];
      best_lp = lp_y;
      best_score = score;
      m = lp_y;
      s = 1.0f;
    } else {
      if (score > best_score) {
#pragma unroll
        for (int q = 0; q < D; ++q) best[q] = y[q];
        best_lp = lp_y;
        best_score = score;
      }
      const float m_new = nan_max(m, lp_y);
      s = s * expf(m - m_new) + expf(lp_y - m_new);
      m = m_new;
    }
  }
  const float lse_num = m + logf(s);
  const int r0 = k * (2 * P + 1);
  float m2 = nan_max(lp, kNegClamp), s2 = 1.0f;
  for (int r = 0; r < k - 1; ++r) {
    step_normals<D>(w, z, r0 + 2 * P * r);
    perturb<D, kTril>(best, scale, z, y);
    const float lp_r = nan_max(Density::logp(y, consts, n_consts), kNegClamp);
    const float m2_new = nan_max(m2, lp_r);
    s2 = s2 * expf(m2 - m2_new) + expf(lp_r - m2_new);
    m2 = m2_new;
  }
  const float logalpha = lse_num - (m2 + logf(s2));
  const bool accept = logf(w.uniform(r0 + 2 * P * (k - 1))) < logalpha;
  if (accept) {
#pragma unroll
    for (int q = 0; q < D; ++q) x[q] = best[q];
    lp = best_lp;
  }
  return accept;
}

// The density's constants, then the scale, into shared memory (once per
// block); returns the scale's place there.
__device__ __forceinline__ const float* load_mtm_shared(float* sh, const float* consts,
                                                        int n_consts, const float* scale,
                                                        int n_scale) {
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x) sh[i] = consts[i];
  for (int i = threadIdx.x; i < n_scale; i += blockDim.x) sh[n_consts + i] = scale[i];
  __syncthreads();
  return sh + n_consts;
}

// ---- kernel A: burn-in + thinned emission --------------------------------

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...).
template <class Density, bool kTril>
__global__ void __launch_bounds__(kMtmBlock)
    mtm_sample_kernel(const float* __restrict__ params_t, const float* __restrict__ lp_in,
                      const float* __restrict__ scale, const float* __restrict__ consts,
                      int n_consts, int k, uint32_t k0, uint32_t k1, int64_t burn,
                      int64_t thin, int64_t n_samples, uint64_t offset, int64_t C,
                      float* __restrict__ samples, float* __restrict__ lps,
                      float* __restrict__ accs) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh[];
  const float* s = load_mtm_shared(sh, consts, n_consts, scale, kTril ? D * D : D);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = params_t[i * C + c];
  float lp = lp_in[c];
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    mtm_step<Density, kTril>(x, lp, s, sh, n_consts, k, ++j, (uint32_t)c, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = mtm_step<Density, kTril>(x, lp, s, sh, n_consts, k, ++j, (uint32_t)c, k0,
                                          k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = x[i];
    lps[e * C + c] = lp;
    accs[e * C + c] = accepted ? 1.0f : 0.0f;
  }
}

// ---- kernel B: n_steps with no emission ----------------------------------

template <class Density, bool kTril>
__global__ void __launch_bounds__(kMtmBlock)
    mtm_kernel(const float* __restrict__ params_t, const float* __restrict__ lp_in,
               const float* __restrict__ scale, const float* __restrict__ consts,
               int n_consts, int k, uint32_t k0, uint32_t k1, int64_t n_steps,
               uint64_t offset, int64_t C, float* __restrict__ out_params,
               float* __restrict__ out_lp, float* __restrict__ out_acc) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh[];
  const float* s = load_mtm_shared(sh, consts, n_consts, scale, kTril ? D * D : D);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = params_t[i * C + c];
  float lp = lp_in[c];
  uint64_t j = offset;
  float count = 0.0f;
  for (int64_t t = 0; t < n_steps; ++t)
    count += mtm_step<Density, kTril>(x, lp, s, sh, n_consts, k, ++j, (uint32_t)c, k0, k1)
                 ? 1.0f
                 : 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) out_params[i * C + c] = x[i];
  out_lp[c] = lp;
  out_acc[c] = count;
}

// ---- host-side launch ------------------------------------------------------

template <class Density, bool kTril>
size_t mtm_smem(int n_consts) {
  return (n_consts + (kTril ? Density::kDim * Density::kDim : Density::kDim)) * sizeof(float);
}

inline dim3 mtm_grid(int64_t C) { return dim3((unsigned)((C + kMtmBlock - 1) / kMtmBlock)); }

template <class Density, bool kTril>
int launch_mtm_sample(const float* params_t, const float* lp, const float* scale,
                      const float* consts, int n_consts, int k, uint64_t seed, int64_t burn,
                      int64_t thin, int64_t n_samples, uint64_t offset, int64_t C,
                      float* samples, float* lps, float* accs, cudaStream_t stream) {
  const size_t smem = mtm_smem<Density, kTril>(n_consts);
  const cudaError_t err = allow_shared(mtm_sample_kernel<Density, kTril>, smem);
  if (err != cudaSuccess) return (int)err;
  mtm_sample_kernel<Density, kTril><<<mtm_grid(C), kMtmBlock, smem, stream>>>(
      params_t, lp, scale, consts, n_consts, k, (uint32_t)seed, (uint32_t)(seed >> 32), burn,
      thin, n_samples, offset, C, samples, lps, accs);
  return (int)cudaGetLastError();
}

template <class Density, bool kTril>
int launch_mtm_steps(const float* params_t, const float* lp, const float* scale,
                     const float* consts, int n_consts, int k, uint64_t seed, int64_t n_steps,
                     uint64_t offset, int64_t C, float* out_params, float* out_lp,
                     float* out_acc, cudaStream_t stream) {
  const size_t smem = mtm_smem<Density, kTril>(n_consts);
  const cudaError_t err = allow_shared(mtm_kernel<Density, kTril>, smem);
  if (err != cudaSuccess) return (int)err;
  mtm_kernel<Density, kTril><<<mtm_grid(C), kMtmBlock, smem, stream>>>(
      params_t, lp, scale, consts, n_consts, k, (uint32_t)seed, (uint32_t)(seed >> 32),
      n_steps, offset, C, out_params, out_lp, out_acc);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities both kernels are instantiated for: the one list of the pairs
// (see csrc/common.cuh).
#define AMH_MTM_DENSITIES(X)    \
  X(amh::GaussianMeanScale)     \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::CorrelatedGaussian<4>)

extern "C" {

int amh_mtm_sample(const char* density, int32_t d, int32_t tril, const void* params_t,
                   const void* lp, const void* scale, const void* consts, int32_t n_consts,
                   int32_t k, uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                   uint64_t offset, int64_t C, void* samples, void* lps, void* accs,
                   void* stream) {
#define X(T)                                                                               \
  if (amh::matches<T>(density, d))                                                         \
    return (tril ? amh::launch_mtm_sample<T, true> : amh::launch_mtm_sample<T, false>)(    \
        (const float*)params_t, (const float*)lp, (const float*)scale,                     \
        (const float*)consts, n_consts, k, seed, burn, thin, n_samples, offset, C,         \
        (float*)samples, (float*)lps, (float*)accs, (cudaStream_t)stream);
  AMH_MTM_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

int amh_mtm(const char* density, int32_t d, int32_t tril, const void* params_t, const void* lp,
            const void* scale, const void* consts, int32_t n_consts, int32_t k, uint64_t seed,
            int64_t n_steps, uint64_t offset, int64_t C, void* out_params, void* out_lp,
            void* out_acc, void* stream) {
#define X(T)                                                                                \
  if (amh::matches<T>(density, d))                                                          \
    return (tril ? amh::launch_mtm_steps<T, true> : amh::launch_mtm_steps<T, false>)(       \
        (const float*)params_t, (const float*)lp, (const float*)scale,                      \
        (const float*)consts, n_consts, k, seed, n_steps, offset, C, (float*)out_params,    \
        (float*)out_lp, (float*)out_acc, (cudaStream_t)stream);
  AMH_MTM_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_mtm() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_MTM_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
