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
// Design. A thread owns fold position j of its tile and loops over the K
// folds: for fold k it reads chain (b, j) for the statistics and moves chain
// (k, j), so every thread works in every phase. A tile's F threads span
// several 64-thread blocks; the launch is cooperative and a fold takes four
// grid barriers: after the pooled sum x (mu), after the pooled
// sum (x - mu)^2 (sigma, two passes as JAX), after the pooled Gram matrices
// of sigma * g and (x - mu) / sigma with their column-norm sums, and after
// the move (the next fold reads the moved chains). Sums are taken in the
// fixed order of csrc/pooling.cuh; each entry of a block's Gram matrix is a
// tree over the block's chains of that chain's product, formed from the
// chain's vector staged in shared memory (rows padded to d + 1 floats
// against bank conflicts), 64 entries at a time. Every block of a tile
// derives the same fold parameters from the same totals. The chains' state
// (x, lp, g, p, u) lives in device memory and is read and written through L2
// (__ldcg / __stcg): other blocks read it in the next fold.
//
// Precision: the TPU kernel forms the Gram matrix at d > 16 as a
// default-precision MXU product (bf16 operands, ~0.4% jitter on lambda);
// here it is exact float32 products and sums, no tensor cores.
//
// What bounds it on this card: one value and gradient per chain-step (the
// logistic regression's dominates at d = 32), 2 d^2 Gram products per chain
// and fold, and 4 K grid barriers a step.
//
// Numerics: --fmad=false, no --use_fast_math; jnp.maximum / jnp.minimum
// propagate NaN (nan_max / nan_min); 1/sqrtf where JAX has rsqrt (rsqrtf is
// approximate); the slice drift wraps with a select, as the TPU kernel.

#include "pooling.cuh"

namespace amh {

struct MeadsConsts {
  float mult, clip, slowdown;
};

template <int D>
struct MeadsShape {
  static constexpr int kDD = D * D;
  static constexpr int kRows = D > 64 ? D : 64;  // rows of the tree scratch
  static constexpr int kStride = D + 1;          // staged row, padded
  // partial rows: sum x (D), sum (x - mu)^2 (D), two Gram matrices, 4 sums
  static constexpr int kPartialRows = 2 * D + 2 * kDD + 4;
  static constexpr int kShared = kRows * kPoolBlock + 2 * kPoolBlock * kStride + 3 * D + 4;
};

// The tile's lambda-hat = tr(A^2)/tr(A) from the pooled sums: s_gg = sum G^2,
// sc = sum of the column norms, sc2 = sum of their squares.
__device__ __forceinline__ float max_eig(float s_gg, float sc, float sc2, float ff,
                                         float ff1) {
  return ((s_gg - sc2) / ff1) / nan_max(sc / ff, 1e-30f);
}

template <class Density, bool kPrecond, bool kNonrev>
__global__ void __launch_bounds__(kPoolBlock) meads_kernel(
    float* __restrict__ x_s, float* __restrict__ lp_s, float* __restrict__ g_s,
    float* __restrict__ p_s, float* __restrict__ u_s, const float* __restrict__ consts,
    int n_consts, MeadsConsts k, int K, int64_t tile, int64_t C, uint32_t k0,
    uint32_t k1, uint64_t t0, int64_t burn, int64_t thin, int64_t n_samples,
    float* __restrict__ samples, float* __restrict__ lps, float* __restrict__ accs,
    float* __restrict__ partials, int64_t nb) {
  constexpr int D = Density::kDim;
  using S = MeadsShape<D>;
  constexpr int B = kPoolBlock;
  extern __shared__ float sh[];
  float* red = sh + consts_floats(n_consts);  // kRows x B
  float* stage_g = red + S::kRows * B;         // B x (D + 1)
  float* stage_z = stage_g + B * S::kStride;   // B x (D + 1)
  float* mu_sh = stage_z + B * S::kStride;     // D
  float* sig_sh = mu_sh + D;                   // D
  float* tot = sig_sh + D;                     // D + 4 tile totals
  load_consts(sh, consts, n_consts);
  cg::grid_group grid = cg::this_grid();
  if (!grid.is_valid()) return;  // not a cooperative launch: never wait on it
  const int64_t F_full = tile / K;
  const PoolTile pt = pool_tile(C / tile, F_full, (C % tile) / K);
  const int64_t F = pt.n_items;
  const bool valid = pt.item < F;
  const int64_t base = pt.tile * tile + pt.item;  // + k * F: chain of fold k
  const float ff = (float)F;
  const float ff1 = ff * (ff - 1.0f);
  const int tid = threadIdx.x;
  float* part_a = partials;
  float* part_b = partials + D * nb;
  float* part_c = partials + 2 * D * nb;
  const int64_t total = burn + n_samples * thin;
  for (int64_t s = 0; s < total; ++s) {
    const uint64_t t = t0 + (uint64_t)s;
    const float tf = (float)t;
    const bool emit = s + 1 > burn && (s + 1 - burn) % thin == 0;
    const int64_t e = (s + 1 - burn) / thin - 1;
    for (int kf = 0; kf < K; ++kf) {
      const int64_t cb = base + (int64_t)((kf + K - 1) % K) * F;
      // the complementary fold: mu
      float xb[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        xb[i] = valid ? __ldcg(x_s + i * C + cb) : 0.0f;
        red[i * B + tid] = xb[i];
      }
      block_tree(red, D);
      store_partials(red, D, part_a, nb);
      grid.sync();
      tile_totals(part_a, D, nb, pt.first_block, pt.n_blocks, tot);
      for (int i = tid; i < D; i += B) mu_sh[i] = tot[i] / ff;
      __syncthreads();
      // sigma: two passes, as JAX
      if (kPrecond) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float xc = valid ? xb[i] - mu_sh[i] : 0.0f;
          red[i * B + tid] = xc * xc;
        }
        block_tree(red, D);
        store_partials(red, D, part_b, nb);
        grid.sync();
        tile_totals(part_b, D, nb, pt.first_block, pt.n_blocks, tot);
        for (int i = tid; i < D; i += B) sig_sh[i] = nan_max(sqrtf(tot[i] / ff), 1e-10f);
      } else {
        for (int i = tid; i < D; i += B) sig_sh[i] = 1.0f;
      }
      __syncthreads();
      // the two Gram matrices and the column-norm sums
      {
        float cg_ = 0.0f, cz = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float vg = valid ? sig_sh[i] * __ldcg(g_s + i * C + cb) : 0.0f;
          const float vz = valid ? (xb[i] - mu_sh[i]) / sig_sh[i] : 0.0f;
          stage_g[tid * S::kStride + i] = vg;
          stage_z[tid * S::kStride + i] = vz;
          cg_ = i == 0 ? vg * vg : cg_ + vg * vg;
          cz = i == 0 ? vz * vz : cz + vz * vz;
        }
        for (int m = 0; m < 2; ++m) {
          const float* stage = m == 0 ? stage_g : stage_z;
          for (int e0 = 0; e0 < S::kDD; e0 += S::kRows) {
            const int nq = S::kDD - e0 < S::kRows ? S::kDD - e0 : S::kRows;
            for (int q = 0; q < nq; ++q) {
              const int ee = e0 + q;
              red[q * B + tid] = stage[tid * S::kStride + ee / D] *
                                 stage[tid * S::kStride + ee % D];
            }
            block_tree(red, nq);
            store_partials(red, nq, part_c + (m * S::kDD + e0) * nb, nb);
          }
        }
        red[tid] = cg_;
        red[B + tid] = cg_ * cg_;
        red[2 * B + tid] = cz;
        red[3 * B + tid] = cz * cz;
        block_tree(red, 4);
        store_partials(red, 4, part_c + 2 * S::kDD * nb, nb);
      }
      grid.sync();
      // the tile's sums of G^2: entry ee by thread ee mod B, in order
      float sgg_g = 0.0f, sgg_z = 0.0f;
      for (int ee = tid; ee < S::kDD; ee += B) {
        const float* rg = part_c + ee * nb + pt.first_block;
        const float* rz = part_c + (S::kDD + ee) * nb + pt.first_block;
        float gg = __ldcg(rg), gz = __ldcg(rz);
        for (int64_t b = 1; b < pt.n_blocks; ++b) {
          gg = gg + __ldcg(rg + b);
          gz = gz + __ldcg(rz + b);
        }
        sgg_g = sgg_g + gg * gg;
        sgg_z = sgg_z + gz * gz;
      }
      red[tid] = sgg_g;
      red[B + tid] = sgg_z;
      block_tree(red, 2);
      tile_totals(part_c + 2 * S::kDD * nb, 4, nb, pt.first_block, pt.n_blocks, tot);
      const float lam_g = max_eig(red[0], tot[0], tot[1], ff, ff1);
      const float lam_x = max_eig(red[B], tot[2], tot[3], ff, ff1);
      float eps = k.mult * (1.0f / sqrtf(nan_max(lam_g, 1e-30f)));
      eps = nan_min(eps, k.clip);
      float gamma = 1.0f / sqrtf(nan_max(lam_x, 1.0f));
      gamma = nan_max(gamma, k.slowdown / (eps * (tf + 1.0f)));
      const float alpha = 1.0f - expf(-2.0f * eps * gamma);
      const float delta = 0.5f * alpha;
      const float sa1 = sqrtf(1.0f - alpha), sa = sqrtf(alpha);
      // the move of fold kf
      if (valid) {
        const int64_t ck = base + (int64_t)kf * F;
        float z[D], y[D], q[D];
        float logu;
        step_noise<D>(t, (uint32_t)ck, k0, k1, z, logu);
        const float lpk = __ldcg(lp_s + ck);
        const float uk = __ldcg(u_s + ck);
        const float half = 0.5f * eps;
        float ke1 = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float p1 = sa1 * __ldcg(p_s + i * C + ck) + sa * z[i];
          ke1 = i == 0 ? p1 * p1 : ke1 + p1 * p1;
          __stcg(p_s + i * C + ck, -p1);  // the momentum on a rejection
          q[i] = p1 + half * (sig_sh[i] * __ldcg(g_s + i * C + ck));
          y[i] = __ldcg(x_s + i * C + ck) + eps * (sig_sh[i] * q[i]);
        }
        ke1 = 0.5f * ke1;
        float gy[D];
        const float lp_y = Density::value_and_grad(y, sh, n_consts, gy);
        float ke2 = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          q[i] = q[i] + half * (sig_sh[i] * gy[i]);
          ke2 = i == 0 ? q[i] * q[i] : ke2 + q[i] * q[i];
        }
        ke2 = 0.5f * ke2;
        const float logalpha = (lp_y - ke2) - (lpk - ke1);
        const float a = fabsf(logalpha) < 1e30f ? expf(fminf(logalpha, 0.0f)) : 0.0f;
        bool acc;
        float u_next = uk;
        if (kNonrev) {
          acc = uk < a;
          const float u_new = acc ? uk / fmaxf(a, 1e-30f) : (uk - a) / fmaxf(1.0f - a, 1e-30f);
          const float v = u_new + delta;
          u_next = v >= 1.0f ? v - 1.0f : v;
        } else {
          acc = -logu > -logalpha;  // NaN rejects
        }
        __stcg(u_s + ck, u_next);
        if (acc) {
#pragma unroll
          for (int i = 0; i < D; ++i) {
            __stcg(x_s + i * C + ck, y[i]);
            __stcg(g_s + i * C + ck, gy[i]);
            __stcg(p_s + i * C + ck, q[i]);
          }
          __stcg(lp_s + ck, lp_y);
        }
        if (emit) {
#pragma unroll
          for (int i = 0; i < D; ++i)
            samples[(e * D + i) * C + ck] = acc ? y[i] : __ldcg(x_s + i * C + ck);
          lps[e * C + ck] = acc ? lp_y : lpk;
          accs[e * C + ck] = acc ? 1.0f : 0.0f;
        }
      }
      grid.sync();
    }
  }
}

template <class Density, bool kPrecond, bool kNonrev>
int launch_meads(float* x_s, float* lp_s, float* g_s, float* p_s, float* u_s,
                 const float* consts, int n_consts, MeadsConsts k, int K, int64_t tile,
                 int64_t C, uint64_t seed, uint64_t t0, int64_t burn, int64_t thin,
                 int64_t n_samples, float* samples, float* lps, float* accs,
                 float* partials, int64_t nb, cudaStream_t stream) {
  using S = MeadsShape<Density::kDim>;
  if (K < 2 || tile < 2 * K || tile % K || (C % tile) % K ||
      (C % tile != 0 && (C % tile) / K < 2) ||
      nb != pool_blocks(C / tile, tile / K, (C % tile) / K))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(consts_floats(n_consts) + S::kShared) * sizeof(float);
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  void* args[] = {&x_s,  &lp_s, &g_s,  &p_s,  &u_s,  &consts,  &n_consts,
                  &k,    &K,    &tile, &C,    &k0,   &k1,      &t0,
                  &burn, &thin, &n_samples, &samples, &lps, &accs, &partials, &nb};
  return launch_cooperative(meads_kernel<Density, kPrecond, kNonrev>, nb, smem, args,
                            stream);
}

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

extern "C" {

// x, lp, g, p, u hold the start and are updated in place.
int amh_meads_sample(const char* density, int32_t d, int32_t precond, int32_t nonrev,
                     void* x_s, void* lp_s, void* g_s, void* p_s, void* u_s,
                     const void* consts, int32_t n_consts, float mult, float clip,
                     float slowdown, int32_t K, int64_t tile, int64_t C, uint64_t seed,
                     uint64_t t0, int64_t burn, int64_t thin, int64_t n_samples,
                     void* samples, void* lps, void* accs, void* partials, int64_t nb,
                     void* stream) {
  const amh::MeadsConsts k{mult, clip, slowdown};
#define ARGS                                                                     \
  (float*)x_s, (float*)lp_s, (float*)g_s, (float*)p_s, (float*)u_s,              \
      (const float*)consts, n_consts, k, K, tile, C, seed, t0, burn, thin,       \
      n_samples, (float*)samples, (float*)lps, (float*)accs, (float*)partials,   \
      nb, (cudaStream_t)stream
#define X(T)                                                                     \
  if (amh::matches<T>(density, d)) {                                             \
    if (precond)                                                                 \
      return nonrev ? amh::launch_meads<T, true, true>(ARGS)                     \
                    : amh::launch_meads<T, true, false>(ARGS);                   \
    return nonrev ? amh::launch_meads<T, false, true>(ARGS)                      \
                  : amh::launch_meads<T, false, false>(ARGS);                    \
  }
  AMH_MEADS_DENSITIES(X)
#undef X
#undef ARGS
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
