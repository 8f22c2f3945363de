// The HMC step shared by csrc/hmc.cu and csrc/hmc_adapt.cu: momentum from the
// step's noise, n_leapfrog kick-drift-kick leapfrog steps, the exact
// energy-error accept. The plain version is ops/hmc.py::hmc_step.
//
// Layout: one thread runs one chain. The trajectory (x, p, g) and the
// diagonal inverse mass live in registers; the state to fall back to on a
// reject (x and g) lives in device memory, (d, C) with chains on the last
// axis, and is re-read only then. At d = 32 that keeps 4 x 32 floats and
// the density's temporaries live in a thread, not 7 x 32: ptxas then fills
// the 255 registers and spills at most a few hundred bytes (chip_smoke.py
// prints its report).
#pragma once

#include "common.cuh"

namespace amh {

constexpr int kHmcBlock = 64;

template <int D>
__device__ __forceinline__ float kinetic(const float (&p)[D],
                                         const float (&minv)[D]) {
  float k = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float t = p[i] * p[i] * minv[i];
    k = i == 0 ? t : k + t;
  }
  return k * 0.5f;
}

// The proposal of an HMC step of absolute index j for chain c, at step size
// eps and inverse mass minv: momentum from the step's noise, n_leapfrog
// leapfrog steps. On entry x, g, lp hold the current state; on exit x, g, p
// hold the end point (y, g_y, p1), lp_y its log density and logu the log of
// the accept uniform. Returns logalpha (ops/hmc.py::hmc_propose).
template <class Density>
__device__ __forceinline__ float hmc_propose(
    float (&x)[Density::kDim], float lp, float (&g)[Density::kDim],
    float (&p)[Density::kDim], const float (&minv)[Density::kDim], float eps,
    int n_leapfrog, const float* consts, int n_consts, int64_t c, uint64_t j,
    uint32_t k0, uint32_t k1, float& lp_y, float& logu) {
  constexpr int D = Density::kDim;
  step_noise<D>(j, (uint32_t)c, k0, k1, p, logu);
#pragma unroll
  for (int i = 0; i < D; ++i) p[i] = p[i] / sqrtf(minv[i]);
  const float k_0 = kinetic<D>(p, minv);
  const float half = 0.5f * eps;
  lp_y = lp;
  for (int l = 0; l < n_leapfrog; ++l) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      p[i] = p[i] + half * g[i];
      x[i] = x[i] + eps * minv[i] * p[i];
    }
    // only the trajectory's last value is read: the others are dead code
    if (l + 1 < n_leapfrog)
      Density::value_and_grad(x, consts, n_consts, g);
    else
      lp_y = Density::value_and_grad(x, consts, n_consts, g);
#pragma unroll
    for (int i = 0; i < D; ++i) p[i] = p[i] + half * g[i];
  }
  return (lp_y - kinetic<D>(p, minv)) - (lp - k_0);
}

// One HMC step of absolute index j for chain c, at step size eps and
// inverse mass minv. On entry x, g, lp hold the current state, which is also
// stored at x_state / g_state; on exit they hold the next state, stored
// there too. Returns whether the proposal was accepted.
template <class Density>
__device__ __forceinline__ bool hmc_step(
    float (&x)[Density::kDim], float& lp, float (&g)[Density::kDim],
    const float (&minv)[Density::kDim], float eps, int n_leapfrog,
    const float* consts, int n_consts, float* x_state, float* g_state,
    int64_t c, int64_t C, uint64_t j, uint32_t k0, uint32_t k1) {
  constexpr int D = Density::kDim;
  float p[D];
  float lp_y, logu;
  const float logalpha = hmc_propose<Density>(x, lp, g, p, minv, eps, n_leapfrog,
                                              consts, n_consts, c, j, k0, k1,
                                              lp_y, logu);
  const bool accept = -logu > -logalpha;  // NaN rejects
  if (accept) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      x_state[i * C + c] = x[i];
      g_state[i * C + c] = g[i];
    }
    lp = lp_y;
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      x[i] = x_state[i * C + c];
      g[i] = g_state[i * C + c];
    }
  }
  return accept;
}

// Every thread's start: the state into registers and into x_state/g_state.
template <int D>
__device__ __forceinline__ void hmc_load(const float* params_t,
                                         const float* grad_in, float (&x)[D],
                                         float (&g)[D], float* x_state,
                                         float* g_state, int64_t c, int64_t C) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    x[i] = params_t[i * C + c];
    g[i] = grad_in[i * C + c];
    x_state[i * C + c] = x[i];
    g_state[i * C + c] = g[i];
  }
}

}  // namespace amh
