// Delayed-rejection Metropolis-Hastings kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_dr.py::_dr_kernel: burn-in, then
// n_samples thinned draws of two-stage delayed rejection (Mira 2001) with
// zero-mean Gaussian random-walk stages of per-dimension scales s1 (bold)
// and s2 (timid); both densities are evaluated on every step and stage 2 is
// masked in:
//   y1 = x + s1 z1,  la1 = lp1 - lp,  acc1 = log U1 < la1,
//   y2 = x + s2 z2,
//   dq = -0.5 (sum_i ((y1_i - y2_i) inv_s1_i)^2 - sum_i z1_i^2)
//        (log q1(y1|y2) - log q1(y1|x): both are densities of the same
//        Gaussian, so the normalisations cancel and |(y1 - x)/s1|^2 is
//        |z1|^2; sums in coordinate order, inv_s1 = 1/s1 once),
//   la2 = lp2 - lp + dq + log1m_exp(lp1 - lp2) - log1m_exp(la1),
//   acc2 = log U2 < la2 and not acc1,
// the state moving to y1, else y2, else staying. The plain PyTorch version
// is ops/dr.py::dr_sample_reference; the C entry point at the end is bound
// there with ctypes.
//
// Noise of absolute step j of chain c (common.cuh::StepWords): z1's
// Box-Muller words 0 .. 2P-1, z2's 2P .. 4P-1, U1 at 4P and U2 at 4P+1
// (JAX's kernel takes z1 and z2 as the two halves of one Box-Muller pair).
//
// Layout and design as csrc/rwmh.cu: chains on the last axis (x (d, C), lp
// (1, C), emitted (N, d, C) / (N, 1, C)), one thread per chain with x and lp
// in registers, the last block masked. Shared memory holds the density's
// constants, then s1, s2 and inv_s1 (d floats each).
//
// What bounds it on this card: two densities a step (the flagship's 30 or
// 300 observations each), two Box-Muller sets and two log1m_exp -- a
// dependent chain of arithmetic per thread, latency-bound at 16384 chains;
// the emission's bytes set a bound far below.
//
// Numerics: --fmad=false, no --use_fast_math. Two out-of-support candidates
// (the flagship's sigma < 0) make lp1 - lp2 = -inf - (-inf) = NaN:
// log1m_exp maps it to -1e30 and lp2 = -inf rejects stage 2, so the state
// never takes a NaN.

#include "common.cuh"

namespace amh {

constexpr int kDrBlock = 64;

// One delayed-rejection step; returns whether either stage accepted.
template <class Density>
__device__ __forceinline__ bool dr_step(float (&x)[Density::kDim], float& lp,
                                        const float* s1, const float* s2,
                                        const float* inv_s1, const float* consts,
                                        int n_consts, uint64_t j, uint32_t c, uint32_t k0,
                                        uint32_t k1) {
  constexpr int D = Density::kDim;
  constexpr int P = (D + 1) / 2;
  StepWords w(j, c, k0, k1);
  float z1[D], z2[D], y1[D], y2[D];
  step_normals<D>(w, z1);
  step_normals<D>(w, z2, 2 * P);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    y1[i] = x[i] + s1[i] * z1[i];
    y2[i] = x[i] + s2[i] * z2[i];
  }
  const float lp1 = Density::logp(y1, consts, n_consts);
  const float la1 = lp1 - lp;
  const bool acc1 = logf(w.uniform(4 * P)) < la1;
  const float lp2 = Density::logp(y2, consts, n_consts);
  float d12 = 0.0f, zz = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float t = (y1[i] - y2[i]) * inv_s1[i];
    d12 = i == 0 ? t * t : d12 + t * t;
    zz = i == 0 ? z1[i] * z1[i] : zz + z1[i] * z1[i];
  }
  const float dq = -0.5f * (d12 - zz);
  const float la2 = lp2 - lp + dq + log1m_exp(lp1 - lp2) - log1m_exp(la1);
  const bool acc2 = logf(w.uniform(4 * P + 1)) < la2 && !acc1;
  if (acc1 || acc2) {
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = acc1 ? y1[i] : y2[i];
    lp = acc1 ? lp1 : lp2;
  }
  return acc1 || acc2;
}

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...).
template <class Density>
__global__ void __launch_bounds__(kDrBlock)
    dr_sample_kernel(const float* __restrict__ params_t, const float* __restrict__ lp_in,
                     const float* __restrict__ scale1, const float* __restrict__ scale2,
                     const float* __restrict__ consts, int n_consts, uint32_t k0,
                     uint32_t k1, int64_t burn, int64_t thin, int64_t n_samples,
                     uint64_t offset, int64_t C, float* __restrict__ samples,
                     float* __restrict__ lps, float* __restrict__ accs) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh[];
  float* s1 = sh + n_consts;
  float* s2 = s1 + D;
  float* inv_s1 = s2 + D;
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x) sh[i] = consts[i];
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    s1[i] = scale1[i];
    s2[i] = scale2[i];
    inv_s1[i] = 1.0f / scale1[i];
  }
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float x[D];
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = params_t[i * C + c];
  float lp = lp_in[c];
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    dr_step<Density>(x, lp, s1, s2, inv_s1, sh, n_consts, ++j, (uint32_t)c, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = dr_step<Density>(x, lp, s1, s2, inv_s1, sh, n_consts, ++j, (uint32_t)c,
                                  k0, k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = x[i];
    lps[e * C + c] = lp;
    accs[e * C + c] = accepted ? 1.0f : 0.0f;
  }
}

template <class Density>
int launch_dr(const float* params_t, const float* lp, const float* s1, const float* s2,
              const float* consts, int n_consts, uint64_t seed, int64_t burn, int64_t thin,
              int64_t n_samples, uint64_t offset, int64_t C, float* samples, float* lps,
              float* accs, cudaStream_t stream) {
  const size_t smem = (n_consts + 3 * Density::kDim) * sizeof(float);
  const cudaError_t err = allow_shared(dr_sample_kernel<Density>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kDrBlock - 1) / kDrBlock));
  dr_sample_kernel<Density><<<grid, kDrBlock, smem, stream>>>(
      params_t, lp, s1, s2, consts, n_consts, (uint32_t)seed, (uint32_t)(seed >> 32), burn,
      thin, n_samples, offset, C, samples, lps, accs);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities the kernel is instantiated for: the one list of the pairs
// (see csrc/common.cuh).
#define AMH_DR_DENSITIES(X)     \
  X(amh::GaussianMeanScale)     \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::Banana)

extern "C" {

int amh_dr_sample(const char* density, int32_t d, const void* params_t, const void* lp,
                  const void* s1, const void* s2, const void* consts, int32_t n_consts,
                  uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                  uint64_t offset, int64_t C, void* samples, void* lps, void* accs,
                  void* stream) {
#define X(T)                                                                           \
  if (amh::matches<T>(density, d))                                                     \
    return amh::launch_dr<T>((const float*)params_t, (const float*)lp, (const float*)s1, \
                             (const float*)s2, (const float*)consts, n_consts, seed,   \
                             burn, thin, n_samples, offset, C, (float*)samples,        \
                             (float*)lps, (float*)accs, (cudaStream_t)stream);
  AMH_DR_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_dr() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_DR_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
