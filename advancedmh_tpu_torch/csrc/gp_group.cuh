// The block shape, start and prior draw of the kernels that move a chain of
// a GP likelihood inside its Gaussian prior N(mu, Sigma): elliptical slice
// sampling (csrc/ess.cu) and preconditioned Crank-Nicolson (csrc/pcn.cu).
//
// A chain runs on the 8 lanes of its likelihood's group form
// (csrc/group.cuh::GPGroupForm), coordinate i on lane i mod 8: lane l holds
// the chain's coordinates l, l + 8, .. of x, mu (and of a diagonal scale) in
// registers, and its running sum is partial l of the likelihood's point sum.
// 16 chains share a 128-thread block (GroupShape), at least 4 blocks an SM.
// Shared memory holds the likelihood's constants, L with rows padded to
// d + 4 floats (lane l's rows start 4 l banks apart, so a chain's 8 lanes
// read 8 rows at once without a bank conflict, in aligned float4s) and each
// chain's staged normals, d + 8 floats apart (the 4 chains of a warp 8 banks
// apart).
//
// The prior draw L z of a step (prior_draw): each lane draws its own
// Box-Muller pairs (coordinates [l d/8, (l + 1) d/8), words 2p and 2p + 1 of
// pair p) and stages them; after a __syncwarp on the chain's mask, lane l
// forms rows l + 8k of L z, each over the columns 0 .. 8k + 7 in order (the
// same count in every lane; the entries above the diagonal are exact zeros,
// and adding them changes no sum, so the bits are the plain version's full
// rows). For a diagonal scale it is sigma_i z_i.
#pragma once

#include "hmc_group.cuh"

namespace amh {

// The kernels' dynamic shared memory, in floats: the constants (rounded up
// to a float4), then L's rows of kRowL floats (a lower-triangular scale),
// then each chain's staged normals, kZ apart.
template <class Density, bool kTril>
struct PriorShape : GroupShape<Density> {
  using GF = GroupForm<Density>;
  static constexpr int D = Density::kDim;
  static constexpr int kRowL = D + 4;
  static constexpr int kZ = D + 8;
  static_assert(D % 8 == 0 && GF::kJ % 2 == 0, "rows in float4s, whole Box-Muller pairs a lane");

  __host__ __device__ static int z_offset(int n_consts) {
    return GF::consts_floats(n_consts) + (kTril ? D * kRowL : 0);
  }
  __host__ __device__ static int smem_floats(int n_consts) {
    return z_offset(n_consts) + GroupShape<Density>::kChains * kZ;
  }
};

// A thread's chain: its lanes, its index c in the batch, the padded factor
// and the chain's staging of the normals.
struct PriorChain {
  Lanes ln;
  int64_t c;
  const float* L;
  float* zs;
};

// Every kernel's start: the block loads the constants and the factor into
// `sh` (a block barrier), then each thread finds its chain. A chain with
// c >= C is past the end of the batch: its lanes return together.
template <class Density, bool kTril>
__device__ __forceinline__ PriorChain prior_chain(float* sh, const float* consts, int n_consts,
                                                  const float* scale) {
  using S = PriorShape<Density, kTril>;
  constexpr int D = S::D;
  float* L = sh + S::GF::consts_floats(n_consts);
  for (int e = threadIdx.x; e < n_consts; e += blockDim.x) sh[e] = consts[e];
  if (kTril)
    for (int e = threadIdx.x; e < D * D; e += blockDim.x) L[(e / D) * S::kRowL + e % D] = scale[e];
  __syncthreads();
  const int slot = threadIdx.x / S::kLanes;
  return PriorChain{chain_lanes<S::kLanes>(), (int64_t)blockIdx.x * S::kChains + slot, L,
                    sh + S::z_offset(n_consts) + slot * S::kZ};
}

// The lane's values of column c of a (d, C) array (coordinates lane + 8k),
// and of a (d,) vector.
template <class Density>
__device__ __forceinline__ void lane_column(const float* a, const PriorChain& ch, int64_t C,
                                            float (&v)[GroupForm<Density>::kJ]) {
#pragma unroll
  for (int k = 0; k < GroupForm<Density>::kJ; ++k)
    v[k] = a[GroupForm<Density>::coord(ch.ln.lane, k) * C + ch.c];
}

template <class Density>
__device__ __forceinline__ void lane_vector(const float* a, const PriorChain& ch,
                                            float (&v)[GroupForm<Density>::kJ]) {
#pragma unroll
  for (int k = 0; k < GroupForm<Density>::kJ; ++k)
    v[k] = a[GroupForm<Density>::coord(ch.ln.lane, k)];
}

// nu = L z (or diag z) at the lane's coordinates, z the step's d normals
// (words 0 .. 2P - 1 of `s`), staged through the chain's `zs`.
template <class Density, bool kTril>
__device__ __forceinline__ void prior_draw(StepWords& s,
                                           const float (&diag)[GroupForm<Density>::kJ],
                                           const PriorChain& ch,
                                           float (&nu)[GroupForm<Density>::kJ]) {
  using S = PriorShape<Density, kTril>;
  constexpr int kJ = S::kJ;
  const Lanes& ln = ch.ln;
  {
    float z[kJ];  // the normals of coordinates [lane kJ, (lane + 1) kJ), staged
    step_normals<kJ>(s, z, ln.lane * kJ);
#pragma unroll
    for (int k = 0; k < kJ; ++k) ch.zs[ln.lane * kJ + k] = z[k];
  }
  __syncwarp(ln.mask);
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    const int i = S::GF::coord(ln.lane, k);
    if (kTril) {
      const float4* row = reinterpret_cast<const float4*>(ch.L + i * S::kRowL);
      const float4* zv = reinterpret_cast<const float4*>(ch.zs);
      float4 a = row[0], b = zv[0];
      float acc = a.x * b.x;
      acc = acc + a.y * b.y;
      acc = acc + a.z * b.z;
      acc = acc + a.w * b.w;
#pragma unroll 4
      for (int q = 1; q < 2 * k + 2; ++q) {
        a = row[q];
        b = zv[q];
        acc = acc + a.x * b.x;
        acc = acc + a.y * b.y;
        acc = acc + a.z * b.z;
        acc = acc + a.w * b.w;
      }
      nu[k] = acc;
    } else {
      nu[k] = diag[k] * ch.zs[i];
    }
  }
  __syncwarp(ln.mask);  // every lane has read z before the next step stages its own
}

}  // namespace amh
