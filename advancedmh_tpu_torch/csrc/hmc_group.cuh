// The HMC step with a chain spread over the lanes of its density's group form
// (csrc/group.cuh), and the block shape, start and launch of the kernels
// built on it: HMC (csrc/hmc.cu), ChEES's frozen phase (csrc/chees.cu),
// AdaptiveHMC (csrc/hmc_adapt.cu), with their own steps Barker
// (csrc/barker.cu) and the evidence kernel (csrc/evidence.cu), and with their
// own steps and shared memory ESS and pCN (csrc/gp_group.cuh). The plain
// version of the HMC step is ops/hmc.py::hmc_step: the same arithmetic in the
// same order.
//
// Layout: kLanes threads of a warp run one chain; lane l holds coordinates
// [l kJ, (l + 1) kJ) of the trajectory (x, p, g), of the state to fall back
// to on a reject (x0, g0) and of the inverse mass, all in registers (7 kJ
// floats: 28 at d = 32 on 8 lanes, where one thread per chain held 4 x 32
// and spilled, or kept the fall-back state in device memory). A value and
// gradient of the logistic regression is then a product of the 8 lanes
// (group.cuh); the kinetic energies are sums over the coordinates in order,
// gathered with shuffles; the noise of the lane's coordinates is the lane's
// own Philox words. Densities without a group form run one thread per chain
// (kLanes = 1) through the same code.
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

// The block of a density: 16 chains of 8 lanes (group form), else 64 chains
// of one thread; at least 4 blocks an SM, so that 8192 chains keep 16 warps
// resident on each of the 132 SMs. Dynamic shared memory: the group form's
// constants, then each chain's scratch.
template <class Density>
struct GroupShape {
  static constexpr int kLanes = GroupForm<Density>::kLanes;
  static constexpr int kJ = Density::kDim / kLanes;
  static constexpr int kThreads = kLanes == 1 ? 64 : 128;
  static constexpr int kChains = kThreads / kLanes;
  static constexpr int kMinBlocks = kLanes == 1 ? 1 : 4;

  __host__ __device__ static int smem_floats(int n_consts) {
    return GroupForm<Density>::consts_floats(n_consts) + kChains * GroupForm<Density>::kScratch;
  }
};

// A thread's chain: its lanes, its index c in the batch, its lane's first
// coordinate j0 and the chain's shared scratch.
struct GroupChain {
  Lanes ln;
  int64_t c;
  int j0;
  float* scratch;
};

// Every kernel's start: the block loads the density's constants into `sh`
// (a block barrier), then each thread finds its chain. A chain with c >= C
// is past the end of the batch: its lanes return together.
template <class Density>
__device__ __forceinline__ GroupChain group_chain(float* sh, const float* consts,
                                                  int n_consts) {
  using GF = GroupForm<Density>;
  using S = GroupShape<Density>;
  GF::load(sh, consts, n_consts);
  const int slot = threadIdx.x / S::kLanes;
  const Lanes ln = chain_lanes<S::kLanes>();
  return GroupChain{ln, (int64_t)blockIdx.x * S::kChains + slot, ln.lane * S::kJ,
                    sh + GF::consts_floats(n_consts) + slot * GF::kScratch};
}

// The lane's kJ coordinates of column c of a (d, C) array, and back.
template <int kJ>
__device__ __forceinline__ void lane_load(const float* a, const GroupChain& ch, int64_t C,
                                          float (&v)[kJ]) {
#pragma unroll
  for (int k = 0; k < kJ; ++k) v[k] = a[(ch.j0 + k) * C + ch.c];
}

template <int kJ>
__device__ __forceinline__ void lane_store(float* a, const GroupChain& ch, int64_t C,
                                           const float (&v)[kJ]) {
#pragma unroll
  for (int k = 0; k < kJ; ++k) a[(ch.j0 + k) * C + ch.c] = v[k];
}

// Launch `kernel` over C chains in blocks of GroupShape<Density>, on `stream`,
// with the dynamic shared memory of `Shape` (GroupShape's own layout, or a
// kernel's that extends it, as csrc/gp_group.cuh::PriorShape).
template <class Density, class Shape = GroupShape<Density>, class... Params, class... Args>
int launch_group(void (*kernel)(Params...), int n_consts, int64_t C, cudaStream_t stream,
                 Args... args) {
  using S = Shape;
  const size_t smem = (size_t)S::smem_floats(n_consts) * sizeof(float);
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((C + S::kChains - 1) / S::kChains));
  kernel<<<grid, S::kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The launch shape and occupancy of `kernel` for C chains in blocks of
// `chains` chains of `lanes` lanes with `smem` bytes of dynamic shared
// memory: out[0..5] = chains a block, lanes a chain, threads a block,
// blocks, dynamic shared memory bytes, resident blocks an SM.
template <class Kernel>
int launch_info(Kernel kernel, int chains, int lanes, size_t smem, int64_t C, int64_t* out) {
  cudaError_t err = allow_shared(kernel, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, chains * lanes, smem);
  out[0] = chains;
  out[1] = lanes;
  out[2] = chains * lanes;
  out[3] = (C + chains - 1) / chains;
  out[4] = (int64_t)smem;
  out[5] = per_sm;
  return (int)err;
}

// launch_info of a kernel in blocks of GroupShape<Density>, with the dynamic
// shared memory of `Shape` (as launch_group).
template <class Density, class Shape = GroupShape<Density>, class Kernel>
int group_launch_info(Kernel kernel, int n_consts, int64_t C, int64_t* out) {
  using S = Shape;
  return launch_info(kernel, S::kChains, S::kLanes,
                     (size_t)S::smem_floats(n_consts) * sizeof(float), C, out);
}

}  // namespace amh
