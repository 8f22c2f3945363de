// DRAM kernel for Hopper (sm_90a): delayed rejection with adaptive
// Metropolis (Haario, Laine, Mira & Saksman 2006).
//
// Replaces advancedmh_tpu/ops/pallas_dram.py::_dram_kernel: burn-in, then
// n_samples thinned draws; both stages propose from the chain's running
// covariance factor L, and both densities are evaluated on every step:
//   y1 = x + os L z1,  la1 = lp1 - lp,  acc1 = log U1 < la1,
//   y2 = x + gs L z2,  gs = gm os rounded once in float32 (pallas_dram.py:69),
//   dq = sum_r -0.5 ((z1_r - gm z2_r)^2 - z1_r^2)  (the shared-L q1 cross
//        term in z-space, in coordinate order),
//   la2 = lp2 - lp + dq + log1m_exp(lp1 - lp2) - log1m_exp(la1),
//   acc2 = log U2 < la2 and not acc1,
// the state moves to y1, else y2, else stays, and (mean, L, n) advance with
// it (common.cuh::welford_chol_advance) on every step. os = opt_scale /
// sqrt(d) is rounded once from float64, gm = gamma to float32. The plain
// PyTorch version is ops/dram.py::dram_sample_reference; the C entry point at
// the end is bound there with ctypes.
//
// Noise of absolute step j of chain c (common.cuh::StepWords): z1's
// Box-Muller words 0 .. 2P-1, z2's 2P .. 4P-1, U1 at 4P and U2 at 4P+1.
//
// Layout and the launch body: csrc/am.cuh (d <= 8, as JAX). At d = 8 a
// chain holds x, mean, the packed L (36), lp and n beside the step's z1, z2
// and the two candidates; ptxas's report (chip_smoke.py prints it) says
// whether that spills.
//
// What bounds it on this card: AM's step with two densities, two L z
// products, a second Box-Muller set and two log1m_exp a step -- a dependent
// chain of arithmetic per thread, latency-bound at 16384 chains; the bytes
// of the emission set a bound far below.
//
// Numerics: --fmad=false, no --use_fast_math. log1m_exp has expm1f and
// log1pf, the plain version torch.expm1 and torch.log1p; a NaN la1 (lp = lp1
// = -inf) rejects stage 1 and maps to -1e30, as in JAX.

#include "am.cuh"

namespace amh {

struct DramStep {
  float os;  // opt_scale / sqrt(d)
  float gs;  // gamma * os, in float32
  float gm;  // gamma

  template <class Density>
  __device__ __forceinline__ bool advance(AmState<Density::kDim>& s, const float* consts,
                                          int n_consts, uint64_t j, uint32_t c, uint32_t k0,
                                          uint32_t k1) const {
    constexpr int D = Density::kDim;
    constexpr int P = (D + 1) / 2;
    StepWords w(j, c, k0, k1);
    float z1[D], z2[D], y1[D], y2[D];
    step_normals<D>(w, z1);
    step_normals<D>(w, z2, 2 * P);
    float dq = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float dz = z1[i] - gm * z2[i];
      const float t = -0.5f * (dz * dz - z1[i] * z1[i]);
      dq = i == 0 ? t : dq + t;
    }
    tri_matvec<D>(s.L, z1, y1);
#pragma unroll
    for (int i = 0; i < D; ++i) y1[i] = s.x[i] + os * y1[i];
    const float lp1 = Density::logp(y1, consts, n_consts);
    const float la1 = lp1 - s.lp;
    const bool acc1 = logf(w.uniform(4 * P)) < la1;
    tri_matvec<D>(s.L, z2, y2);
#pragma unroll
    for (int i = 0; i < D; ++i) y2[i] = s.x[i] + gs * y2[i];
    const float lp2 = Density::logp(y2, consts, n_consts);
    const float la2 = lp2 - s.lp + dq + log1m_exp(lp1 - lp2) - log1m_exp(la1);
    const bool acc2 = logf(w.uniform(4 * P + 1)) < la2 && !acc1;
    if (acc1 || acc2) {
#pragma unroll
      for (int i = 0; i < D; ++i) s.x[i] = acc1 ? y1[i] : y2[i];
      s.lp = acc1 ? lp1 : lp2;
    }
    welford_chol_advance<D>(s.x, s.mean, s.L, s.n);
    return acc1 || acc2;
  }
};

template <class Density>
__global__ void __launch_bounds__(kAmBlock)
    dram_sample_kernel(DramStep step, const float* __restrict__ x_in,
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
int launch_dram(DramStep step, const float* x, const float* lp, const float* mean,
                const float* L, const float* n, const float* consts, int n_consts,
                uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                uint64_t offset, int64_t C, float* samples, float* lps, float* accs,
                float* mean_out, float* L_out, float* n_out, cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(dram_sample_kernel<Density>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + kAmBlock - 1) / kAmBlock));
  dram_sample_kernel<Density><<<grid, kAmBlock, smem, stream>>>(
      step, x, lp, mean, L, n, consts, n_consts, (uint32_t)seed, (uint32_t)(seed >> 32),
      burn, thin, n_samples, offset, C, samples, lps, accs, mean_out, L_out, n_out);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities the kernel is instantiated for: the one list of the pairs
// (see csrc/common.cuh).
#define AMH_DRAM_DENSITIES(X)   \
  X(amh::GaussianMeanScale)     \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::CorrelatedGaussian<4>) \
  X(amh::CorrelatedGaussian<8>) \
  X(amh::Banana)

extern "C" {

int amh_dram_sample(const char* density, int32_t d, const void* x, const void* lp,
                    const void* mean, const void* L, const void* n, const void* consts,
                    int32_t n_consts, float os, float gs, float gm, uint64_t seed,
                    int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
                    int64_t C, void* samples, void* lps, void* accs, void* mean_out,
                    void* L_out, void* n_out, void* stream) {
  const amh::DramStep step{os, gs, gm};
#define X(T)                                                                           \
  if (amh::matches<T>(density, d))                                                     \
    return amh::launch_dram<T>(step, (const float*)x, (const float*)lp,                \
                               (const float*)mean, (const float*)L, (const float*)n,   \
                               (const float*)consts, n_consts, seed, burn, thin,       \
                               n_samples, offset, C, (float*)samples, (float*)lps,     \
                               (float*)accs, (float*)mean_out, (float*)L_out,          \
                               (float*)n_out, (cudaStream_t)stream);
  AMH_DRAM_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_dram() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_DRAM_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
