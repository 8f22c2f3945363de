// The HMC step with a chain spread over the lanes of its density's group form
// (csrc/group.cuh): the step of csrc/hmc.cuh, the same arithmetic in the same
// order, for the AdaptiveHMC kernel (csrc/hmc_adapt.cu). The plain version is
// ops/hmc.py::hmc_step.
//
// Layout: kLanes threads of a warp run one chain; lane l holds coordinates
// [l kJ, (l + 1) kJ) of the trajectory (x, p, g), of the state to fall back
// to on a reject (x0, g0) and of the inverse mass, all in registers (7 kJ
// floats: 28 at d = 32 on 8 lanes, where one thread per chain held 4 x 32
// and spilled). A value and gradient of the logistic regression is then a
// product of the 8 lanes (group.cuh); the kinetic energies are sums over the
// coordinates in order, gathered with shuffles; the noise of the lane's
// coordinates is the lane's own Philox words. Densities without a group form
// run one thread per chain (kLanes = 1) through the same code.
#pragma once

#include "group.cuh"

namespace amh {

// 1/2 sum_i p_i^2 M^-1_i over the coordinates in order.
template <int kLanes, int kJ>
__device__ __forceinline__ float lane_kinetic(const float (&p)[kJ], const float (&minv)[kJ],
                                              const Lanes& ln) {
  float t[kJ];
#pragma unroll
  for (int k = 0; k < kJ; ++k) t[k] = p[k] * p[k] * minv[k];
  return coord_sum<kLanes, kJ>(t, ln) * 0.5f;
}

// One HMC step of absolute index j for chain c at step size eps and inverse
// mass minv (the lane's coordinates). On entry x, g, lp hold the current
// state and x0, g0 the same; on exit all hold the next state. The decision
// is the same in every lane of the chain. Returns whether it accepted.
template <class Density>
__device__ __forceinline__ bool group_hmc_step(
    float (&x)[Density::kDim / GroupForm<Density>::kLanes], float& lp,
    float (&g)[Density::kDim / GroupForm<Density>::kLanes],
    float (&x0)[Density::kDim / GroupForm<Density>::kLanes],
    float (&g0)[Density::kDim / GroupForm<Density>::kLanes],
    const float (&minv)[Density::kDim / GroupForm<Density>::kLanes], float eps,
    int n_leapfrog, const float* sh, int n_consts, float* scratch, const Lanes& ln,
    int64_t c, uint64_t j, uint32_t k0, uint32_t k1) {
  using GF = GroupForm<Density>;
  constexpr int D = Density::kDim;
  constexpr int kLanes = GF::kLanes;
  constexpr int kJ = D / kLanes;
  float p[kJ];
  float logu;
  lane_noise<D, kLanes>(j, (uint32_t)c, k0, k1, ln.lane, p, logu);
#pragma unroll
  for (int k = 0; k < kJ; ++k) p[k] = p[k] / sqrtf(minv[k]);
  const float k_0 = lane_kinetic<kLanes, kJ>(p, minv, ln);
  const float half = 0.5f * eps;
  float lp_y = lp;
  for (int l = 0; l < n_leapfrog; ++l) {
#pragma unroll
    for (int k = 0; k < kJ; ++k) {
      p[k] = p[k] + half * g[k];
      x[k] = x[k] + eps * minv[k] * p[k];
    }
    lp_y = GF::value_and_grad(x, g, sh, n_consts, scratch, ln);
#pragma unroll
    for (int k = 0; k < kJ; ++k) p[k] = p[k] + half * g[k];
  }
  const float logalpha = (lp_y - lane_kinetic<kLanes, kJ>(p, minv, ln)) - (lp - k_0);
  const bool accept = -logu > -logalpha;  // NaN rejects
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    x0[k] = accept ? x[k] : x0[k];
    g0[k] = accept ? g[k] : g0[k];
    x[k] = x0[k];
    g[k] = g0[k];
  }
  lp = accept ? lp_y : lp;
  return accept;
}

}  // namespace amh
