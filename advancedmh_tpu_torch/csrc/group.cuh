// Chains spread over the lanes of a warp: a density's group form, and the
// per-lane pieces of a step that the MEADS (csrc/meads.cu) and AdaptiveHMC
// (csrc/hmc_adapt.cu, csrc/hmc_group.cuh) kernels share.
//
// A density's group form is a compile-time property (GroupForm<Density>):
// kLanes threads of one warp run one chain, lane l holding its coordinates
// [l kJ, (l + 1) kJ), kJ = kDim / kLanes. kLanes = 1 is one thread per chain,
// and the density's own value_and_grad runs there. The logistic regression
// has the group form with kLanes = 8, one lane per log-likelihood partial:
//
//   - X (n x D) sits in shared memory with rows padded to D + 4 floats (16-byte
//     aligned rows, and lane l's row starts 4 l banks on, so that the 8 lanes
//     of a chain read 8 rows without a bank conflict);
//   - lane l takes observations i = l, l + 8, l + 16, ..: z_i = X_i . b with
//     j in order 0..D-1, its term y z - softplus(z) into partial l, and
//     r_i = y - softplus'(z) into the chain's scratch, 64 observations a pass;
//   - lane l then sums g_j = sum_i X_ij r_i over the pass's observations in
//     order, for its own coordinates j;
//   - ll = the 8 partials in order, b.b in order, g_j - b_j inv_var.
//
// That is the order of LogisticRegression<D>::eval in csrc/common.cuh, which
// one thread runs for a whole chain, and of its plain twin in
// models/targets.py: the values are the same bits, 8 threads compute them.
// A chain's lanes exchange values through __shfl_sync and __syncwarp on
// their own 8-lane mask only, so a chain past the end of the batch simply
// does not run.
#pragma once

#include "common.cuh"

namespace amh {

// A chain's lanes: its lane index and the warp mask of its kLanes threads.
struct Lanes {
  int lane;
  unsigned mask;
};

template <int kLanes>
__device__ __forceinline__ Lanes chain_lanes() {
  static_assert(kLanes < 32 && 32 % kLanes == 0, "a chain's lanes lie in one warp");
  const int w = threadIdx.x & 31;
  return Lanes{w % kLanes, ((1u << kLanes) - 1u) << (w - w % kLanes)};
}

// One thread per chain: the constants as they are, the density's own
// value_and_grad.
template <class Density>
struct GroupForm {
  static constexpr int kLanes = 1;
  static constexpr int kScratch = 0;  // floats of shared scratch a chain

  __host__ __device__ static int consts_floats(int n_consts) { return (n_consts + 3) & ~3; }

  __device__ static void load(float* sh, const float* consts, int n_consts) {
    load_consts(sh, consts, n_consts);
  }

  __device__ __forceinline__ static float value_and_grad(const float (&x)[Density::kDim],
                                                         float (&g)[Density::kDim],
                                                         const float* sh, int n_consts,
                                                         float*, const Lanes&) {
    return Density::value_and_grad(x, sh, n_consts, g);
  }
};

template <int D>
struct GroupForm<LogisticRegression<D>> {
  static constexpr int kLanes = LogisticRegression<D>::kPartials;  // 8
  static constexpr int kJ = D / kLanes;
  static constexpr int kRow = D + 4;     // X row in shared memory
  static constexpr int kChunk = 64;      // observations a pass
  static constexpr int kR = kRow;        // r of the pass, after the staged b
  // a chain's scratch, 104 floats at D = 32: the 4 chains of a warp read
  // their r 8 banks apart
  static constexpr int kScratch = kRow + kChunk + 4;
  static_assert(D % (4 * kLanes) == 0, "lanes hold whole float4s of coordinates");

  __host__ __device__ static int n_obs(int n_consts) { return (n_consts - 1) / (D + 1); }

  __host__ __device__ static int consts_floats(int n_consts) {
    const int n = n_obs(n_consts);
    return (n * kRow + n + 1 + 3) & ~3;
  }

  // X with padded rows, then y, then inv_var; then a block barrier.
  __device__ static void load(float* sh, const float* consts, int n_consts) {
    const int n = n_obs(n_consts);
    for (int e = threadIdx.x; e < n * D; e += blockDim.x)
      sh[(e / D) * kRow + e % D] = consts[e];
    for (int e = threadIdx.x; e < n + 1; e += blockDim.x) sh[n * kRow + e] = consts[n * D + e];
    __syncthreads();
  }

  // The log density (the same in every lane) and the lane's kJ gradient
  // coordinates at the lane's coordinates x of the chain's position; the
  // chain's scratch holds the staged position and r.
  __device__ __forceinline__ static float value_and_grad(const float (&x)[kJ], float (&g)[kJ],
                                                         const float* sh, int n_consts,
                                                         float* scratch, const Lanes& ln) {
    const int n = n_obs(n_consts);
    const float* yv = sh + n * kRow;
    const float inv_var = yv[n];
    float* rs = scratch + kR;
#pragma unroll
    for (int k = 0; k < kJ; ++k) scratch[ln.lane * kJ + k] = x[k];
    __syncwarp(ln.mask);
    float b[D];
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(scratch)[q];
      b[4 * q] = v.x;
      b[4 * q + 1] = v.y;
      b[4 * q + 2] = v.z;
      b[4 * q + 3] = v.w;
    }
    float part = 0.0f;
    float gl[kJ];
#pragma unroll
    for (int k = 0; k < kJ; ++k) gl[k] = 0.0f;
    for (int i0 = 0; i0 < n; i0 += kChunk) {
      const int cn = n - i0 < kChunk ? n - i0 : kChunk;
#pragma unroll
      for (int m = 0; m < kChunk / kLanes; ++m) {
        const int ii = ln.lane + kLanes * m;
        if (ii < cn) {
          const int i = i0 + ii;
          const float4* xi = reinterpret_cast<const float4*>(sh + i * kRow);
          float z;
#pragma unroll
          for (int q = 0; q < D / 4; ++q) {
            const float4 v = xi[q];
            z = q == 0 ? v.x * b[0] : z + v.x * b[4 * q];
            z = z + v.y * b[4 * q + 1];
            z = z + v.z * b[4 * q + 2];
            z = z + v.w * b[4 * q + 3];
          }
          const float e = expf(-fabsf(z));
          part = part + (yv[i] * z - (fmaxf(z, 0.0f) + log1pf(e)));
          const float h = z > 0.0f ? 1.0f : (z == 0.0f ? 0.5f : 0.0f);
          const float s = z >= 0.0f ? 1.0f : -1.0f;
          rs[ii] = yv[i] - (h - s * (e / (1.0f + e)));
        }
      }
      __syncwarp(ln.mask);
      for (int ii = 0; ii < cn; ++ii) {
        const float r = rs[ii];
        const float4* xi = reinterpret_cast<const float4*>(sh + (i0 + ii) * kRow + ln.lane * kJ);
#pragma unroll
        for (int q = 0; q < kJ / 4; ++q) {
          const float4 v = xi[q];
          gl[4 * q] = gl[4 * q] + v.x * r;
          gl[4 * q + 1] = gl[4 * q + 1] + v.y * r;
          gl[4 * q + 2] = gl[4 * q + 2] + v.z * r;
          gl[4 * q + 3] = gl[4 * q + 3] + v.w * r;
        }
      }
      __syncwarp(ln.mask);
    }
    float ll;
#pragma unroll
    for (int m = 0; m < kLanes; ++m) {
      const float pm = __shfl_sync(ln.mask, part, m, kLanes);
      ll = m == 0 ? pm : ll + pm;
    }
    float bb = b[0] * b[0];
#pragma unroll
    for (int j = 1; j < D; ++j) bb = bb + b[j] * b[j];
#pragma unroll
    for (int k = 0; k < kJ; ++k) g[k] = gl[k] - x[k] * inv_var;
    return ll - (0.5f * inv_var) * bb;
  }
};

// sum_i t_i over the chain's coordinates i = 0..kDim-1 in order (t_0 first),
// t_i held by lane i / kJ at t[i % kJ]; the same value in every lane.
template <int kLanes, int kJ>
__device__ __forceinline__ float coord_sum(const float (&t)[kJ], const Lanes& ln) {
  float acc;
#pragma unroll
  for (int i = 0; i < kLanes * kJ; ++i) {
    const float v = kLanes == 1 ? t[i % kJ] : __shfl_sync(ln.mask, t[i % kJ], i / kJ, kLanes);
    acc = i == 0 ? v : acc + v;
  }
  return acc;
}

// The lane's kJ normals of step j's noise for chain c (coordinates
// [lane kJ, (lane + 1) kJ)) and log u, the bits step_noise<D> gives: pair p
// from words 2p and 2p + 1, the uniform from word 2 ceil(D/2).
template <int D, int kLanes>
__device__ __forceinline__ void lane_noise(uint64_t j, uint32_t c, uint32_t k0, uint32_t k1,
                                           int lane, float (&z)[D / kLanes], float& logu) {
  constexpr int kJ = D / kLanes;
  static_assert(kLanes == 1 || kJ % 2 == 0, "a lane holds whole Box-Muller pairs");
  StepWords s(j, c, k0, k1);
#pragma unroll
  for (int pp = 0; pp < (kJ + 1) / 2; ++pp) {
    const int p = lane * (kJ / 2) + pp;
    const float u1 = s.uniform(2 * p);
    const float u2 = s.uniform(2 * p + 1);
    const float r = sqrtf(-2.0f * logf(u1));
    float sn, cs;
    sincosf(kTwoPi * u2, &sn, &cs);
    z[2 * pp] = r * cs;
    if (2 * pp + 1 < kJ) z[2 * pp + 1] = r * sn;
  }
  logu = logf(s.uniform(2 * ((D + 1) / 2)));
}

}  // namespace amh
