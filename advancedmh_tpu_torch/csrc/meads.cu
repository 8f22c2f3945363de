// MEADS kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_meads.py::_meads_kernel (with
// _max_eig_cols): the whole warmup-free sampler in one launch. The chains
// form independent ensembles (tiles of `tile` chains, 1024 at d = 32 by the
// JAX rule; the last may be short), each split into K contiguous folds of F
// chains. In a step the folds move one after another; fold k is tuned by
// fold b = (k - 1) mod K's current state: sigma, the soft maximum
// eigenvalues of sigma * g and (x - mu) / sigma, then eps, gamma, alpha,
// delta; then every chain of fold k takes one GHMC step (nonreversible slice
// or Metropolis accept, momentum negated on rejection). ops/meads.py states
// the step; its plain version is ops/meads.py::meads_reference.
//
// Design: one tile, one thread-block cluster of n_cta <= 16 blocks
// (ops/meads.py::cluster_ctas picks n_cta from the tile and K; the launch is
// not cooperative, clusters are independent, so any chain count runs). Block
// r of a tile's cluster owns fold positions [r P, r P + P), P = ceil(F /
// n_cta), of every fold, and keeps those chains' state (x, g, p, lp, u) in
// its shared memory for the whole launch (in device memory, at the same
// positions, where the state does not fit beside the constants: tiles of
// about 6600 chains and more at d = 32, never with the JAX rule's tiles).
// A fold's statistics are sums over the F chains of the complementary fold:
//   1. each block sums its positions in order, one after another (the Gram
//      entries from the chains' sigma g and (x - mu)/sigma staged in shared
//      memory, 32 positions a pass, each thread owning entries (a, b));
//   2. after a cluster barrier every block adds the n_cta blocks' partials in
//      block order, read from their shared memory (distributed shared
//      memory, map_shared_rank), so every block holds the same totals;
//   3. sum G^2 by thread e mod 256 in order, then a shuffle tree in each
//      warp and a tree over the 8 warps.
// ops/meads.py::cluster_sum and pooled_max_eig take the same order. Three
// cluster barriers a fold (two without the preconditioner): after sum x,
// after sum (x - mu)^2, after the Gram round. The move needs none: a block
// moves only its own positions, and the partial buffers are distinct, so a
// block writes a buffer again only after a barrier that every reader of its
// last contents has passed. A last barrier keeps every block's shared
// memory alive until the others are done reading it.
//
// The move: the logistic regression spreads a chain over 8 lanes
// (csrc/group.cuh), 32 chains a block at once, its value and gradient a
// product over them; the other densities run one thread per chain (chosen at
// compile time by GroupForm). Each lane draws the noise of its coordinates.
//
// Precision: the TPU kernel forms the Gram matrix at d > 16 as a
// default-precision MXU product (bf16 operands, ~0.4% jitter on lambda);
// here it is exact float32 products and sums, no tensor cores.
//
// What bounds it on this card: one value and gradient per chain-step (the
// logistic regression's dominates at d = 32), 2 d^2 Gram products per chain
// and fold, and 3 K cluster barriers a step.
//
// Numerics: --fmad=false, no --use_fast_math; jnp.maximum / jnp.minimum
// propagate NaN (nan_max / nan_min); 1/sqrtf where JAX has rsqrt (rsqrtf is
// approximate); the slice drift wraps with a select, as the TPU kernel.

#include <cooperative_groups.h>

#include "group.cuh"

namespace cg = cooperative_groups;

namespace amh {

constexpr int kMeadsThreads = 256;
constexpr int kMeadsWarps = kMeadsThreads / 32;
constexpr int kMeadsStage = 32;  // positions staged a pass of the Gram round
constexpr int kMaxCluster = 16;

struct MeadsConsts {
  float mult, clip, slowdown;
};

// Shared memory of a block, in floats, after the density's constants:
// partials (sum x, sum (x - mu)^2, the two Gram matrices, the 4 column-norm
// sums), mu, sigma, the 4 totals, the warp sums, the staged rows, the
// chains' scratch, then the state when it is kept here.
template <class Density>
struct MeadsShape {
  static constexpr int D = Density::kDim;
  static constexpr int kDD = D * D;
  static constexpr int kLanes = GroupForm<Density>::kLanes;
  static constexpr int kSlots = kMeadsThreads / kLanes;  // chains moved at once
  static constexpr int kStride = D + 1;                  // staged row, padded
  static constexpr int kPartial = (2 * D + 2 * kDD + 4 + 3) & ~3;
  static constexpr int kFixed = kPartial + 2 * D + 4 + 2 * kMeadsWarps +
                                2 * kMeadsStage * kStride + 2 * kMeadsStage;
  static constexpr int kFixedAligned = (kFixed + 3) & ~3;
  static constexpr int kStateChain = 3 * D + 2;  // x, g, p, lp, u

  __host__ __device__ static int floats(int n_consts, int K, int P, bool state_shared) {
    return GroupForm<Density>::consts_floats(n_consts) + kFixedAligned +
           kSlots * GroupForm<Density>::kScratch +
           (state_shared ? K * P * kStateChain : 0);
  }
};

// The tile's lambda-hat = tr(A^2)/tr(A) from the pooled sums: s_gg = sum G^2,
// sc = sum of the column norms, sc2 = sum of their squares.
__device__ __forceinline__ float max_eig(float s_gg, float sc, float sc2, float ff,
                                         float ff1) {
  return ((s_gg - sc2) / ff1) / nan_max(sc / ff, 1e-30f);
}

// The halving tree of the 8 warps' values at w[0..7] (stride 2).
__device__ __forceinline__ float warps_tree(const float* w) {
  float a[kMeadsWarps];
#pragma unroll
  for (int i = 0; i < kMeadsWarps; ++i) a[i] = w[2 * i];
#pragma unroll
  for (int s = kMeadsWarps / 2; s > 0; s >>= 1)
#pragma unroll
    for (int i = 0; i < s; ++i) a[i] = a[i] + a[i + s];
  return a[0];
}

template <class Density, bool kPrecond, bool kNonrev>
__global__ void __launch_bounds__(kMeadsThreads, 2) meads_kernel(
    float* __restrict__ x_s, float* __restrict__ lp_s, float* __restrict__ g_s,
    float* __restrict__ p_s, float* __restrict__ u_s, const float* __restrict__ consts,
    int n_consts, MeadsConsts k, int K, int64_t tile, int64_t C, int n_cta,
    int state_shared, uint32_t k0, uint32_t k1, uint64_t t0, int64_t burn, int64_t thin,
    int64_t n_samples, float* __restrict__ samples, float* __restrict__ lps,
    float* __restrict__ accs) {
  using GF = GroupForm<Density>;
  using S = MeadsShape<Density>;
  constexpr int D = Density::kDim;
  constexpr int kDD = S::kDD;
  constexpr int kLanes = S::kLanes;
  constexpr int kJ = D / kLanes;
  constexpr int NT = kMeadsThreads;
  constexpr int kSt = S::kStride;
  extern __shared__ __align__(16) float sh[];
  cg::cluster_group cluster = cg::this_cluster();
  GF::load(sh, consts, n_consts);
  float* part = sh + GF::consts_floats(n_consts);  // read by the cluster's blocks
  float* mu_sh = part + S::kPartial;
  float* sig_sh = mu_sh + D;
  float* tot = sig_sh + D;                     // the 4 column-norm totals
  float* wsum = tot + 4;                       // the warps' sums of G^2 (g, z)
  float* stage_g = wsum + 2 * kMeadsWarps;     // kMeadsStage x (D + 1)
  float* stage_z = stage_g + kMeadsStage * kSt;
  float* cols = stage_z + kMeadsStage * kSt;   // the staged positions' norms (g, z)
  float* scratch_all = part + S::kFixedAligned;
  float* state = scratch_all + S::kSlots * GF::kScratch;

  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int64_t ti = (int64_t)blockIdx.x / n_cta;
  const int64_t n_full = C / tile;
  const int64_t base = ti * tile;
  const int F = (int)((ti < n_full ? tile : C % tile) / K);
  const int P = (F + n_cta - 1) / n_cta;
  const int j0 = rank * P;
  const int nv = F - j0 < 0 ? 0 : (F - j0 < P ? F - j0 : P);  // positions here
  const float ff = (float)F;
  const float ff1 = ff * (ff - 1.0f);

  // The state of chain (fold kk, position pp): in shared memory at kk P + pp
  // with stride K P, or in device memory at its chain index with stride C.
  const int64_t sstride = state_shared ? (int64_t)K * P : C;
  float* xs = state_shared ? state : x_s;
  float* gs = state_shared ? state + (int64_t)K * P * D : g_s;
  float* ps = state_shared ? state + 2 * (int64_t)K * P * D : p_s;
  float* ls = state_shared ? state + 3 * (int64_t)K * P * D : lp_s;
  float* us = state_shared ? ls + (int64_t)K * P : u_s;
  auto chain = [&](int kk, int pp) -> int64_t { return base + (int64_t)kk * F + j0 + pp; };
  auto at = [&](int kk, int pp) -> int64_t {
    return state_shared ? (int64_t)kk * P + pp : chain(kk, pp);
  };
  if (state_shared) {
    for (int e = tid; e < K * nv; e += NT) {
      const int kk = e / nv, pp = e % nv;
      const int64_t c = chain(kk, pp), a = at(kk, pp);
      for (int i = 0; i < D; ++i) {
        xs[i * sstride + a] = x_s[i * C + c];
        gs[i * sstride + a] = g_s[i * C + c];
        ps[i * sstride + a] = p_s[i * C + c];
      }
      ls[a] = lp_s[c];
      us[a] = u_s[c];
    }
    __syncthreads();
  }

  const Lanes ln = chain_lanes<kLanes>();
  const int slot = tid / kLanes;
  float* scratch = scratch_all + slot * GF::kScratch;
  const int64_t total = burn + n_samples * thin;
  for (int64_t s = 0; s < total; ++s) {
    const uint64_t t = t0 + (uint64_t)s;
    const float tf = (float)t;
    const bool emit = s + 1 > burn && (s + 1 - burn) % thin == 0;
    const int64_t e = (s + 1 - burn) / thin - 1;
    for (int kf = 0; kf < K; ++kf) {
      const int kb = (kf + K - 1) % K;
      // 1. mu: the block's positions of fold kb in order, then the blocks
      for (int i = tid; i < D; i += NT) {
        float a = 0.0f;
        for (int pp = 0; pp < P; ++pp) {
          const float v = pp < nv ? xs[i * sstride + at(kb, pp)] : 0.0f;
          a = pp == 0 ? v : a + v;
        }
        part[i] = a;
      }
      cluster.sync();
      for (int i = tid; i < D; i += NT) {
        float a = 0.0f;
        for (int r = 0; r < n_cta; ++r) {
          const float v = cluster.map_shared_rank(part, r)[i];
          a = r == 0 ? v : a + v;
        }
        mu_sh[i] = a / ff;
      }
      __syncthreads();
      // 2. sigma: two passes, as JAX
      if (kPrecond) {
        for (int i = tid; i < D; i += NT) {
          float a = 0.0f;
          for (int pp = 0; pp < P; ++pp) {
            const float xc = pp < nv ? xs[i * sstride + at(kb, pp)] - mu_sh[i] : 0.0f;
            const float v = xc * xc;
            a = pp == 0 ? v : a + v;
          }
          part[D + i] = a;
        }
        cluster.sync();
        for (int i = tid; i < D; i += NT) {
          float a = 0.0f;
          for (int r = 0; r < n_cta; ++r) {
            const float v = cluster.map_shared_rank(part, r)[D + i];
            a = r == 0 ? v : a + v;
          }
          sig_sh[i] = nan_max(sqrtf(a / ff), 1e-10f);
        }
      } else {
        for (int i = tid; i < D; i += NT) sig_sh[i] = 1.0f;
      }
      __syncthreads();
      // 3. the two Gram matrices and the column-norm sums, 32 positions a pass
      {
        float gram[2][(kDD + NT - 1) / NT] = {};
        float cn = 0.0f;  // thread q < 4: sum of cg, cg^2, cz, cz^2
        for (int p0 = 0; p0 < P; p0 += kMeadsStage) {
          const int np = P - p0 < kMeadsStage ? P - p0 : kMeadsStage;
          for (int e2 = tid; e2 < np * D; e2 += NT) {
            const int pq = e2 / D, i = e2 % D;
            const int pp = p0 + pq;
            const bool ok = pp < nv;
            const int64_t a = ok ? at(kb, pp) : 0;
            stage_g[pq * kSt + i] = ok ? sig_sh[i] * gs[i * sstride + a] : 0.0f;
            stage_z[pq * kSt + i] = ok ? (xs[i * sstride + a] - mu_sh[i]) / sig_sh[i] : 0.0f;
          }
          __syncthreads();
          for (int q = tid; q < 2 * np; q += NT) {
            const float* row = (q < np ? stage_g : stage_z) + (q % np) * kSt;
            float c2;
#pragma unroll
            for (int i = 0; i < D; ++i) c2 = i == 0 ? row[i] * row[i] : c2 + row[i] * row[i];
            cols[(q < np ? 0 : kMeadsStage) + q % np] = c2;
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* stg = m == 0 ? stage_g : stage_z;
#pragma unroll
            for (int w = 0; w < (kDD + NT - 1) / NT; ++w) {
              const int ee = tid + w * NT;
              if (ee < kDD) {
                const int ra = ee / D, cb = ee % D;
                float a = gram[m][w];
                for (int pq = 0; pq < np; ++pq) {
                  const float v = stg[pq * kSt + ra] * stg[pq * kSt + cb];
                  a = p0 + pq == 0 ? v : a + v;
                }
                gram[m][w] = a;
              }
            }
          }
          __syncthreads();
          if (tid < 4) {
            const float* cq = cols + (tid < 2 ? 0 : kMeadsStage);
            for (int pq = 0; pq < np; ++pq) {
              const float v = (tid & 1) ? cq[pq] * cq[pq] : cq[pq];
              cn = p0 + pq == 0 ? v : cn + v;
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int w = 0; w < (kDD + NT - 1) / NT; ++w) {
            const int ee = tid + w * NT;
            if (ee < kDD) part[2 * D + m * kDD + ee] = gram[m][w];
          }
        if (tid < 4) part[2 * D + 2 * kDD + tid] = cn;
      }
      cluster.sync();
      // the tile's sums of G^2: entry ee by thread ee mod NT, in order; the
      // warps' shuffle trees, then the tree over the warps
      {
        float sgg[2] = {0.0f, 0.0f};
#pragma unroll
        for (int m = 0; m < 2; ++m)
          for (int ee = tid; ee < kDD; ee += NT) {
            float a = 0.0f;
            for (int r = 0; r < n_cta; ++r) {
              const float v = cluster.map_shared_rank(part, r)[2 * D + m * kDD + ee];
              a = r == 0 ? v : a + v;
            }
            sgg[m] = sgg[m] + a * a;
          }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            sgg[m] = sgg[m] + __shfl_down_sync(0xffffffffu, sgg[m], o);
          if ((tid & 31) == 0) wsum[2 * (tid >> 5) + m] = sgg[m];
        }
        if (tid < 4) {
          float a = 0.0f;
          for (int r = 0; r < n_cta; ++r) {
            const float v = cluster.map_shared_rank(part, r)[2 * D + 2 * kDD + tid];
            a = r == 0 ? v : a + v;
          }
          tot[tid] = a;
        }
      }
      __syncthreads();
      const float lam_g = max_eig(warps_tree(wsum), tot[0], tot[1], ff, ff1);
      const float lam_x = max_eig(warps_tree(wsum + 1), tot[2], tot[3], ff, ff1);
      float eps = k.mult * (1.0f / sqrtf(nan_max(lam_g, 1e-30f)));
      eps = nan_min(eps, k.clip);
      float gamma = 1.0f / sqrtf(nan_max(lam_x, 1.0f));
      gamma = nan_max(gamma, k.slowdown / (eps * (tf + 1.0f)));
      const float alpha = 1.0f - expf(-2.0f * eps * gamma);
      const float delta = 0.5f * alpha;
      const float sa1 = sqrtf(1.0f - alpha), sa = sqrtf(alpha);
      const float half = 0.5f * eps;
      // 4. the move of fold kf's chains at this block's positions
      for (int p0 = 0; p0 < nv; p0 += S::kSlots) {
        const int pp = p0 + slot;
        if (pp >= nv) continue;  // the chain's lanes skip together
        const int64_t ck = chain(kf, pp), a = at(kf, pp);
        const int i0 = ln.lane * kJ;
        float z[kJ], logu;
        lane_noise<D, kLanes>(t, (uint32_t)ck, k0, k1, ln.lane, z, logu);
        const float lpk = ls[a];
        const float uk = us[a];
        float p1[kJ], q[kJ], y[kJ], sq[kJ];
#pragma unroll
        for (int kk = 0; kk < kJ; ++kk) {
          const int i = i0 + kk;
          p1[kk] = sa1 * ps[i * sstride + a] + sa * z[kk];
          sq[kk] = p1[kk] * p1[kk];
          q[kk] = p1[kk] + half * (sig_sh[i] * gs[i * sstride + a]);
          y[kk] = xs[i * sstride + a] + eps * (sig_sh[i] * q[kk]);
        }
        const float ke1 = 0.5f * coord_sum<kLanes, kJ>(sq, ln);
        float gy[kJ];
        const float lp_y = GF::value_and_grad(y, gy, sh, n_consts, scratch, ln);
#pragma unroll
        for (int kk = 0; kk < kJ; ++kk) {
          q[kk] = q[kk] + half * (sig_sh[i0 + kk] * gy[kk]);
          sq[kk] = q[kk] * q[kk];
        }
        const float ke2 = 0.5f * coord_sum<kLanes, kJ>(sq, ln);
        const float logalpha = (lp_y - ke2) - (lpk - ke1);
        const float acc_p = fabsf(logalpha) < 1e30f ? expf(fminf(logalpha, 0.0f)) : 0.0f;
        bool acc;
        float u_next = uk;
        if (kNonrev) {
          acc = uk < acc_p;
          const float u_new = acc ? uk / fmaxf(acc_p, 1e-30f)
                                  : (uk - acc_p) / fmaxf(1.0f - acc_p, 1e-30f);
          const float v = u_new + delta;
          u_next = v >= 1.0f ? v - 1.0f : v;
        } else {
          acc = -logu > -logalpha;  // NaN rejects
        }
#pragma unroll
        for (int kk = 0; kk < kJ; ++kk) {
          const int i = i0 + kk;
          const float xo = xs[i * sstride + a];
          if (emit) samples[(e * D + i) * C + ck] = acc ? y[kk] : xo;
          ps[i * sstride + a] = acc ? q[kk] : -p1[kk];
          if (acc) {
            xs[i * sstride + a] = y[kk];
            gs[i * sstride + a] = gy[kk];
          }
        }
        if (ln.lane == 0) {
          us[a] = u_next;
          if (acc) ls[a] = lp_y;
          if (emit) {
            lps[e * C + ck] = acc ? lp_y : lpk;
            accs[e * C + ck] = acc ? 1.0f : 0.0f;
          }
        }
      }
      __syncthreads();
    }
  }
  cluster.sync();  // the other blocks have read this block's partials
  if (state_shared) {
    for (int e2 = tid; e2 < K * nv; e2 += NT) {
      const int kk = e2 / nv, pp = e2 % nv;
      const int64_t c = chain(kk, pp), a = at(kk, pp);
      for (int i = 0; i < D; ++i) {
        x_s[i * C + c] = xs[i * sstride + a];
        g_s[i * C + c] = gs[i * sstride + a];
        p_s[i * C + c] = ps[i * sstride + a];
      }
      lp_s[c] = ls[a];
      u_s[c] = us[a];
    }
  }
}

// The launch of a (density, precond, accept) kernel: its configuration, or
// an error for arguments it does not take.
template <class Density, bool kPrecond, bool kNonrev>
struct MeadsLaunch {
  static cudaError_t config(int n_consts, int K, int64_t tile, int64_t C, int n_cta,
                            cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                            int& state_shared) {
    using S = MeadsShape<Density>;
    if (K < 2 || tile < 2 * K || tile % K || (C % tile) % K ||
        (C % tile != 0 && (C % tile) / K < 2) || n_cta < 1 || n_cta > kMaxCluster ||
        (n_cta & (n_cta - 1)))
      return cudaErrorInvalidValue;
    auto kernel = meads_kernel<Density, kPrecond, kNonrev>;
    const int64_t F = (C < tile ? C : tile) / K;
    const int P = (int)((F + n_cta - 1) / n_cta);
    size_t smem = (size_t)S::floats(n_consts, K, P, true) * sizeof(float);
    state_shared = smem <= 232448;
    if (!state_shared) smem = (size_t)S::floats(n_consts, K, P, false) * sizeof(float);
    cudaError_t err = allow_shared(kernel, smem);
    if (err == cudaSuccess && n_cta > 8)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    const int64_t n_tiles = C / tile + (C % tile != 0);
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3((unsigned)(n_tiles * n_cta));
    cfg.blockDim = dim3(kMeadsThreads);
    cfg.dynamicSmemBytes = smem;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)n_cta;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
  }

  static int run(float* x_s, float* lp_s, float* g_s, float* p_s, float* u_s,
                 const float* consts, int n_consts, MeadsConsts k, int K, int64_t tile,
                 int64_t C, int n_cta, uint64_t seed, uint64_t t0, int64_t burn,
                 int64_t thin, int64_t n_samples, float* samples, float* lps, float* accs,
                 cudaStream_t stream) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int state_shared = 0;
    cudaError_t err = config(n_consts, K, tile, C, n_cta, cfg, attr, state_shared);
    if (err != cudaSuccess) return (int)err;
    cfg.stream = stream;
    // A cluster the card cannot hold is refused here: an error, never a
    // silent fallback.
    err = cudaLaunchKernelEx(&cfg, meads_kernel<Density, kPrecond, kNonrev>, x_s, lp_s, g_s,
                             p_s, u_s, consts, n_consts, k, K, tile, C, n_cta, state_shared,
                             (uint32_t)seed, (uint32_t)(seed >> 32), t0, burn, thin,
                             n_samples, samples, lps, accs);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }

  // out[0..6] = blocks a cluster, blocks, threads a block, lanes a chain,
  // dynamic shared memory bytes, state in shared memory (0/1), clusters
  // resident at once on the card (cudaOccupancyMaxActiveClusters).
  static int info(int n_consts, int K, int64_t tile, int64_t C, int n_cta, int64_t* out) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int state_shared = 0, clusters = 0;
    cudaError_t err = config(n_consts, K, tile, C, n_cta, cfg, attr, state_shared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, meads_kernel<Density, kPrecond, kNonrev>,
                                           &cfg);
    out[0] = n_cta;
    out[1] = err == cudaSuccess ? (int64_t)cfg.gridDim.x : 0;
    out[2] = kMeadsThreads;
    out[3] = MeadsShape<Density>::kLanes;
    out[4] = err == cudaSuccess ? (int64_t)cfg.dynamicSmemBytes : 0;
    out[5] = state_shared;
    out[6] = clusters;
    return (int)err;
  }
};

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities with a value_and_grad the kernel is instantiated for (each
// with and without the diagonal preconditioner, for both accepts): the one
// list of the pairs (see csrc/common.cuh).
#define AMH_MEADS_DENSITIES(X)  \
  X(amh::GaussianMeanScale)     \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::LogisticRegression<32>) \
  X(amh::NealFunnel<10>)

#define AMH_MEADS_DISPATCH(T, CALL)                                               \
  if (precond)                                                                   \
    return nonrev ? amh::MeadsLaunch<T, true, true>::CALL                        \
                  : amh::MeadsLaunch<T, true, false>::CALL;                      \
  return nonrev ? amh::MeadsLaunch<T, false, true>::CALL                         \
                : amh::MeadsLaunch<T, false, false>::CALL;

extern "C" {

// x, lp, g, p, u hold the start and are updated in place.
int amh_meads_sample(const char* density, int32_t d, int32_t precond, int32_t nonrev,
                     void* x_s, void* lp_s, void* g_s, void* p_s, void* u_s,
                     const void* consts, int32_t n_consts, float mult, float clip,
                     float slowdown, int32_t K, int64_t tile, int64_t C, int32_t n_cta,
                     uint64_t seed, uint64_t t0, int64_t burn, int64_t thin,
                     int64_t n_samples, void* samples, void* lps, void* accs, void* stream) {
  const amh::MeadsConsts k{mult, clip, slowdown};
#define X(T)                                                                     \
  if (amh::matches<T>(density, d)) {                                             \
    AMH_MEADS_DISPATCH(T, run((float*)x_s, (float*)lp_s, (float*)g_s, (float*)p_s,  \
                           (float*)u_s, (const float*)consts, n_consts, k, K,    \
                           tile, C, n_cta, seed, t0, burn, thin, n_samples,      \
                           (float*)samples, (float*)lps, (float*)accs,           \
                           (cudaStream_t)stream))                                \
  }
  AMH_MEADS_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

int amh_meads_info(const char* density, int32_t d, int32_t precond, int32_t nonrev,
                   int32_t n_consts, int32_t K, int64_t tile, int64_t C, int32_t n_cta,
                   int64_t* out) {
#define X(T)                                                                     \
  if (amh::matches<T>(density, d)) {                                             \
    AMH_MEADS_DISPATCH(T, info(n_consts, K, tile, C, n_cta, out))                   \
  }
  AMH_MEADS_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_meads() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_MEADS_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
