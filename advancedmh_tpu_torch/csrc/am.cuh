// What the Adaptive Metropolis and DRAM kernels share (csrc/am.cu,
// csrc/dram.cu): a chain's state with its running moments, and the launch
// body that runs a step policy over burn-in and thinned emission.
//
// Layout as the JAX kernels at the wrapper (advancedmh_tpu/ops/pallas_am.py,
// pallas_dram.py): x and mean (d, C), lp and n (1, C), L (d*d, C) row-major
// per chain, emitted (N, d, C) / (N, 1, C). One thread runs one chain with
// x, mean, lp, n and the lower triangle of L (d (d + 1) / 2 floats, packed by
// rows; 36 at d = 8) in registers; the entries of L above the diagonal are
// not read, and the final L has zeros there. n counts the chain states the
// moments have consumed, in float32 as in JAX (exact below 2^24).
// Adaptation never freezes: every step, burn-in and emission alike,
// advances (mean, L, n) with the realized state. The kernels emit exactly
// n_samples draws (JAX rounds emission up to a multiple of 32 and masks the
// padded slots); nothing pools across chains, so any C runs.
#pragma once

#include "common.cuh"

namespace amh {

// 64 threads a block, as slice.cu: 16384 chains make 256 blocks, the
// card-only checks' 2048 make 32.
constexpr int kAmBlock = 64;

template <int D>
struct AmState {
  float x[D];
  float mean[D];
  float L[kTri<D>];
  float lp;
  float n;
};

// Burn-in steps, then sample e is the state after burn + (e+1)*thin steps;
// step t of the launch is absolute iteration offset + t (t = 1, 2, ...).
// `step.advance<Density>(state, consts, n_consts, j, c, k0, k1)` runs one
// step and returns whether it accepted.
template <class Density, class Step>
__device__ __forceinline__ void am_family_run(
    const Step& step, const float* __restrict__ x_in, const float* __restrict__ lp_in,
    const float* __restrict__ mean_in, const float* __restrict__ L_in,
    const float* __restrict__ n_in, const float* __restrict__ consts, int n_consts,
    uint32_t k0, uint32_t k1, int64_t burn, int64_t thin, int64_t n_samples,
    uint64_t offset, int64_t C, float* __restrict__ samples, float* __restrict__ lps,
    float* __restrict__ accs, float* __restrict__ mean_out, float* __restrict__ L_out,
    float* __restrict__ n_out) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh_consts[];
  load_consts(sh_consts, consts, n_consts);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  AmState<D> s;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    s.x[i] = x_in[i * C + c];
    s.mean[i] = mean_in[i * C + c];
#pragma unroll
    for (int k = 0; k <= i; ++k) s.L[tri(i, k)] = L_in[(i * D + k) * C + c];
  }
  s.lp = lp_in[c];
  s.n = n_in[c];
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    step.template advance<Density>(s, sh_consts, n_consts, ++j, (uint32_t)c, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = step.template advance<Density>(s, sh_consts, n_consts, ++j, (uint32_t)c,
                                                k0, k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = s.x[i];
    lps[e * C + c] = s.lp;
    accs[e * C + c] = accepted ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    mean_out[i * C + c] = s.mean[i];
#pragma unroll
    for (int k = 0; k < D; ++k) L_out[(i * D + k) * C + c] = k <= i ? s.L[tri(i, k)] : 0.0f;
  }
  n_out[c] = s.n;
}

}  // namespace amh
