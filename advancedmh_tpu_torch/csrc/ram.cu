// Robust Adaptive Metropolis kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_ram.py::_ram_kernel: `warmup` adaptive
// steps, then n_samples thinned draws with S frozen. A step proposes
// y = x + S U (U ~ N(0, I), S the chain's lower Cholesky factor), accepts by
// logalpha = min(lp_y - lp, 0), and during warmup adapts S by the rank-1
// Cholesky update (dalpha > 0) or downdate (dalpha < 0) of Vihola (2012):
//   S S' <- S (I + eta dalpha U U' / |U|^2) S',  eta = t^-gamma,
// keeping the old S when a downdate loses positive-definiteness or a
// diagonal entry (an eigenvalue of the triangular factor) leaves the
// configured bounds. The plain PyTorch version is
// ops/ram.py::ram_sample_reference; the C entry point at the end is bound
// there with ctypes.
//
// Layout as the JAX kernel at the wrapper: x (d, C), lp (1, C), S (d*d, C)
// row-major per chain, emitted (N, d, C) / (N, 1, C), final S (d*d, C). One
// thread runs one chain with x, lp and S (d*d floats; 4 at d = 2) in
// registers, everything unrolled over the template dimension D (JAX raises
// above d = 8; the registry below lists the instantiated d). The noise is
// RWMH's (d normals as U, one uniform), so ops/rwmh.py::step_noise serves
// the plain version.
//
// What bounds it on this card: per step the density, Box-Muller and Philox
// as in RWMH, plus during warmup expf/logf/sqrtf for eta, dalpha and |U| and
// the O(d^2) sweep with d divides and square roots -- a dependent chain of
// arithmetic per thread, latency-bound at 16384 chains (under 4 warps per
// SM). Bytes are the emission's 16 per chain and kept sample. The design
// keeps all per-chain state in registers and never touches memory inside a
// step; hiding the latency (more chains per thread) is later work.
//
// Numerics: --fmad=false, no --use_fast_math. NaN follows JAX: jnp.minimum
// and jnp.sign propagate NaN, so logalpha is written as `d > 0 ? 0 : d`
// (fminf(NaN, 0) would return 0 and accept), and a NaN dalpha makes the
// sweep's `r2 > 0` false, so S is kept. The sweep is the JAX kernel's
// chol_update algebra in its order (r = sqrt(max(r2, tiny)), c = r/Lkk,
// s = vk/Lkk, then the rows below), so S stays within float32 rounding of
// the plain version over thousands of adaptations.

#include <cfloat>

#include "common.cuh"

namespace amh {

constexpr int kRamBlock = 128;

struct RamParams {
  float alpha;   // target acceptance rate
  float gamma;   // eta = t^-gamma
  float eig_lo;  // bounds on diag(S), used when kClamp
  float eig_hi;
};

// One RAM step on the chain's registers; adapts S when kAdapt. `t` is the
// 1-based warmup iteration for eta.
template <class Density, bool kAdapt, bool kClamp>
__device__ __forceinline__ bool ram_step(float (&x)[Density::kDim], float& lp,
                                         float (&S)[Density::kDim * Density::kDim],
                                         const RamParams& p, int64_t t,
                                         const float* consts, int n_consts,
                                         uint64_t j, uint32_t c, uint32_t k0,
                                         uint32_t k1) {
  constexpr int D = Density::kDim;
  float U[D], SU[D], y[D];
  float logu;
  step_noise<D>(j, c, k0, k1, U, logu);
  tril_matvec<D>(S, U, SU);
#pragma unroll
  for (int i = 0; i < D; ++i) y[i] = x[i] + SU[i];
  const float lp_new = Density::logp(y, consts, n_consts);
  const float diff = lp_new - lp;
  const float logalpha = diff > 0.0f ? 0.0f : diff;  // NaN stays NaN
  const bool accept = -logu > -logalpha;
  if (accept) {
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = y[i];
    lp = lp_new;
  }
  if (kAdapt) {
    const float dalpha = expf(logalpha) - p.alpha;
    const float eta = expf(-p.gamma * logf((float)t));
    float uu = U[0] * U[0];
#pragma unroll
    for (int i = 1; i < D; ++i) uu = uu + U[i] * U[i];
    const float coeff = sqrtf(eta * fabsf(dalpha)) / fmaxf(sqrtf(uu), FLT_MIN);
    // sign(dalpha), NaN for NaN
    const float sgn = dalpha > 0.0f ? 1.0f : (dalpha < 0.0f ? -1.0f : dalpha);
    float v[D], L[D * D];
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = coeff * SU[i];
#pragma unroll
    for (int i = 0; i < D * D; ++i) L[i] = S[i];
    bool ok = true;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float Lkk = L[k * D + k];
      const float vk = v[k];
      const float r2 = Lkk * Lkk + sgn * vk * vk;
      ok = ok && (r2 > 0.0f);
      const float r = sqrtf(r2 > FLT_MIN ? r2 : FLT_MIN);  // max(r2, tiny), NaN -> tiny
      const float cc = r / Lkk;
      const float s = vk / Lkk;
      L[k * D + k] = r;
#pragma unroll
      for (int row = k + 1; row < D; ++row) {
        const float Lik = (L[row * D + k] + sgn * s * v[row]) / cc;
        v[row] = cc * v[row] - s * Lik;
        L[row * D + k] = Lik;
      }
    }
    bool valid = ok;
    if (kClamp) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float dk = L[k * D + k];
        valid = valid && (dk >= p.eig_lo) && (dk <= p.eig_hi);
      }
    }
    if (valid) {
#pragma unroll
      for (int i = 0; i < D * D; ++i) S[i] = L[i];
    }
  }
  return accept;
}

// Warmup steps t = 1..warmup adapt; then sample e is the state after
// warmup + (e+1)*thin steps with S frozen. Step t of the launch is absolute
// iteration offset + t.
template <class Density, bool kClamp>
__global__ void __launch_bounds__(kRamBlock)
    ram_sample_kernel(const float* __restrict__ params_t,
                      const float* __restrict__ lp_in,
                      const float* __restrict__ S_in,
                      const float* __restrict__ consts, int n_consts,
                      RamParams p, uint32_t k0, uint32_t k1, int64_t warmup,
                      int64_t thin, int64_t n_samples, uint64_t offset,
                      int64_t C, float* __restrict__ samples,
                      float* __restrict__ lps, float* __restrict__ accs,
                      float* __restrict__ S_out) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh_consts[];
  load_consts(sh_consts, consts, n_consts);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[D], S[D * D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = params_t[i * C + c];
#pragma unroll
  for (int i = 0; i < D * D; ++i) S[i] = S_in[i * C + c];
  float lp = lp_in[c];
  uint64_t j = offset;
  for (int64_t t = 1; t <= warmup; ++t)
    ram_step<Density, true, kClamp>(x, lp, S, p, t, sh_consts, n_consts, ++j,
                                    (uint32_t)c, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = ram_step<Density, false, kClamp>(x, lp, S, p, 1, sh_consts,
                                                  n_consts, ++j, (uint32_t)c,
                                                  k0, k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = x[i];
    lps[e * C + c] = lp;
    accs[e * C + c] = accepted ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < D * D; ++i) S_out[i * C + c] = S[i];
}

template <class Density, bool kClamp>
int launch_ram(const float* params_t, const float* lp, const float* S,
               const float* consts, int n_consts, RamParams p, uint64_t seed,
               int64_t warmup, int64_t thin, int64_t n_samples,
               uint64_t offset, int64_t C, float* samples, float* lps,
               float* accs, float* S_out, cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(ram_sample_kernel<Density, kClamp>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kRamBlock - 1) / kRamBlock));
  ram_sample_kernel<Density, kClamp>
      <<<grid, kRamBlock, smem, stream>>>(
          params_t, lp, S, consts, n_consts, p, (uint32_t)seed,
          (uint32_t)(seed >> 32), warmup, thin, n_samples, offset, C, samples,
          lps, accs, S_out);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities the kernel is instantiated for (each with and without the
// eigenvalue clamp): the one list of the pairs (see csrc/common.cuh).
#define AMH_RAM_DENSITIES(X)    \
  X(amh::GaussianMeanScale)     \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::CorrelatedGaussian<4>) \
  X(amh::CorrelatedGaussian<8>)

extern "C" {

int amh_ram_sample(const char* density, int32_t d, int32_t clamp,
                   const void* params_t, const void* lp, const void* S,
                   const void* consts, int32_t n_consts, float alpha,
                   float gamma, float eig_lo, float eig_hi, uint64_t seed,
                   int64_t warmup, int64_t thin, int64_t n_samples,
                   uint64_t offset, int64_t C, void* samples, void* lps,
                   void* accs, void* S_out, void* stream) {
  const amh::RamParams p{alpha, gamma, eig_lo, eig_hi};
#define X(T)                                                                   \
  if (amh::matches<T>(density, d))                                             \
    return (clamp ? amh::launch_ram<T, true> : amh::launch_ram<T, false>)(     \
        (const float*)params_t, (const float*)lp, (const float*)S,             \
        (const float*)consts, n_consts, p, seed, warmup, thin, n_samples,      \
        offset, C, (float*)samples, (float*)lps, (float*)accs, (float*)S_out,  \
        (cudaStream_t)stream);
  AMH_RAM_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_ram() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_RAM_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
