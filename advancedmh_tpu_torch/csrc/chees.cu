// ChEES-HMC kernels for Hopper (sm_90a): the warmup and the frozen phase.
//
// chees_warmup_kernel replaces advancedmh_tpu/ops/pallas_chees.py::
// _chees_warmup_kernel (with _chees_adapt_step): the whole warmup in one
// launch, every step adapting log eps (dual averaging on the tile's mean
// acceptance probability), log T (Adam on the tile's ChEES gradient) and,
// with adapt_mass, the tile's Welford diagonal M^-1, each statistic pooled
// over a tile of chains (ops/chees.py states the step; its plain version is
// ops/chees.py::chees_warmup_reference). Out: x, lp, gradient, the last
// step's decisions, and per tile the 9 adapted scalars and the raw sums
// sum x, sum x^2 of all its steps (runtime/fused.py merges the tiles).
//
// chees_frozen_kernel replaces _chees_frozen_kernel: HMC at a frozen eps-bar
// (one value, or one per chain) and M^-1 column, trajectory k of the launch
// running trips[(phase + k) mod P] leapfrog steps (the host-staged van der
// Corput schedule; the TPU bakes it into the kernel as constants, here it is
// a small int array read through the cache). Plain version:
// ops/chees.py::chees_frozen_reference.
//
// Design. The warmup runs one thread a chain (the HMC step of csrc/hmc.cuh).
// Its statistics are pooled over tiles of `tile` chains (512 at d = 32 by
// the JAX rule): a tile spans several 64-thread blocks, so the kernel is
// launched cooperatively and pools in two rounds per step with a grid
// barrier each (csrc/pooling.cuh): round 1 sums w, healthy, x and y over the
// healthy chains (2 + 2d values), round 2 the ChEES contributions, w *
// healthy and this step's x, x^2 (2 + 2d). The two rounds write separate
// partial buffers, so a block that runs ahead into the next step's round 1
// cannot overwrite partials another block still reads. Every block of a tile
// derives the same tile scalars from the same totals; the vector statistics
// (M^-1, Welford mean and M2, the running sums) live in shared memory, one
// coordinate per thread. The trajectory stays in registers across the
// barriers; the state to fall back to on a reject is in device memory.
//
// The frozen phase pools nothing: it runs the group step of
// csrc/hmc_group.cuh, as csrc/hmc.cu does. On the logistic regression a
// chain runs on 8 lanes with x, g, the fall-back (x0, g0) and M^-1 in
// registers, 16 chains a 128-thread block with X in shared memory; the
// other densities, NealFunnel<10> among them, run one thread a chain through
// the same code. A trajectory's trip count is the same for every chain, so
// the chains of a warp never part on it; every lane of a chain reads the
// chain's eps.
//
// What bounds it on this card: the density (the logistic regression's value
// and gradient is ~99% of a step's operations), run as one dependent stream
// per chain in the warmup, plus its two grid barriers a step; in the frozen
// phase the issue rate of 8 lanes a chain (as csrc/hmc.cu).
//
// Numerics: --fmad=false, no --use_fast_math; the NaN semantics of the JAX
// kernel are kept: |logalpha| < 1e30 and the healthy test are false for NaN,
// a contribution is zeroed unless |contrib| < 1e30, jnp.clip propagates NaN
// (nan_max / nan_min), Adam's bias terms are 1 - exp(t log b).

#include "hmc.cuh"
#include "hmc_group.cuh"
#include "pooling.cuh"

namespace amh {

// The warmup's constants (ops/chees.py::CheesParams: each formed in float64
// from the sampler's settings, then rounded to float32).
struct CheesConsts {
  float target, t0, kappa, gamma, mu, lr, b1, one_minus_b1, b2, one_minus_b2;
  float log_b1, log_b2, log_max_leapfrog, mass_reg, warm_start;
};

template <class Density>
__global__ void __launch_bounds__(kPoolBlock) chees_warmup_kernel(
    const float* __restrict__ params_t, const float* __restrict__ lp_in,
    const float* __restrict__ grad_in, const float* __restrict__ sv_in,
    const float* __restrict__ minv_in, const int* __restrict__ trips,
    const float* __restrict__ us, int E, int64_t n_groups,
    const float* __restrict__ consts, int n_consts, CheesConsts k, int adapt_mass,
    uint32_t k0, uint32_t k1, uint64_t offset, int64_t C, int64_t tile,
    float* __restrict__ x_state, float* __restrict__ lp_out,
    float* __restrict__ g_state, float* __restrict__ acc_out,
    float* __restrict__ sv_tiles, float* __restrict__ sum_x,
    float* __restrict__ sum_x2, float* __restrict__ partials, int64_t nb) {
  constexpr int D = Density::kDim;
  constexpr int Q = 2 + 2 * D;
  constexpr int B = kPoolBlock;
  extern __shared__ float sh[];
  float* red = sh + consts_floats(n_consts);  // Q x B
  float* tot = red + Q * B;                   // Q tile totals
  float* minv_sh = tot + Q;                   // the tile's M^-1
  float* mean_sh = minv_sh + D;               // its Welford mean and M2
  float* m2_sh = mean_sh + D;
  float* sum1_sh = m2_sh + D;                 // its raw sums over all steps
  float* sum2_sh = sum1_sh + D;
  load_consts(sh, consts, n_consts);
  cg::grid_group grid = cg::this_grid();
  if (!grid.is_valid()) return;  // not a cooperative launch: never wait on it
  const PoolTile pt = pool_tile(C / tile, tile, C % tile);
  const bool valid = pt.item < pt.n_items;
  const int64_t c = pt.tile * tile + pt.item;
  const float cn = (float)pt.n_items;
  const int tid = threadIdx.x;
  float le = sv_in[0], leb = sv_in[1], hb = sv_in[2], lT = sv_in[3], lTb = sv_in[4];
  float am = sv_in[5], av = sv_in[6], t = sv_in[7], n = sv_in[8];
  for (int i = tid; i < D; i += B) {
    minv_sh[i] = minv_in[i];
    mean_sh[i] = 0.0f;
    m2_sh[i] = 0.0f;
    sum1_sh[i] = 0.0f;
    sum2_sh[i] = 0.0f;
  }
  __syncthreads();
  float x[D], g[D], p[D], minv[D];
  float lp = 0.0f;
  if (valid) {
    hmc_load<D>(params_t, grad_in, x, g, x_state, g_state, c, C);
    lp = lp_in[c];
  }
  bool accept = false;
  const int64_t total = (int64_t)E * n_groups;
  for (int64_t s = 0; s < total; ++s) {
    const int e = (int)(s % E);
#pragma unroll
    for (int i = 0; i < D; ++i) minv[i] = minv_sh[i];
    float lp_y = lp, logu = 0.0f, logalpha = 0.0f, w = 0.0f, hf = 0.0f;
    bool healthy = false;
    if (valid) {
      logalpha = hmc_propose<Density>(x, lp, g, p, minv, expf(le), trips[e], sh,
                                      n_consts, c, offset + (uint64_t)s + 1, k0, k1,
                                      lp_y, logu);
      w = fabsf(logalpha) < 1e30f ? expf(fminf(logalpha, 0.0f)) : 0.0f;
      healthy = true;
#pragma unroll
      for (int i = 0; i < D; ++i)
        healthy = healthy && fabsf(x[i]) < 1e10f && fabsf(p[i]) < 1e10f;
      hf = healthy ? 1.0f : 0.0f;
    }
    // round 1: w, healthy, and x, y over the healthy chains
    red[tid] = w;
    red[B + tid] = hf;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      red[(2 + i) * B + tid] = healthy ? x_state[i * C + c] : 0.0f;
      red[(2 + D + i) * B + tid] = healthy ? x[i] : 0.0f;
    }
    block_tree(red, Q);
    store_partials(red, Q, partials, nb);
    grid.sync();
    tile_totals(partials, Q, nb, pt.first_block, pt.n_blocks, tot);
    // eps: dual averaging on the tile's mean acceptance probability
    const float w_mean = tot[0] / cn;
    const float cnt = fmaxf(tot[1], 1.0f);
    const float wgt = 1.0f / (t + k.t0);
    hb = (1.0f - wgt) * hb + wgt * (k.target - w_mean);
    le = k.mu - sqrtf(t) / k.gamma * hb;
    const float eta = expf(-k.kappa * logf(t));
    leb = eta * le + (1.0f - eta) * leb;
    // round 2: the ChEES contributions, w * healthy and the new states' x, x^2
    float contrib = 0.0f;
    if (valid) {
      float s1 = 0.0f, s0 = 0.0f, dot = 0.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float x0c = x_state[i * C + c] - tot[2 + i] / cnt;
        const float x1c = x[i] - tot[2 + D + i] / cnt;
        const float v = p[i] * minv_sh[i];
        s1 = i == 0 ? x1c * x1c : s1 + x1c * x1c;
        s0 = i == 0 ? x0c * x0c : s0 + x0c * x0c;
        dot = i == 0 ? x1c * v : dot + x1c * v;
      }
      contrib = w * (s1 - s0) * dot * hf;
      if (!(fabsf(contrib) < 1e30f)) contrib = 0.0f;
      accept = -logu > -logalpha;  // NaN rejects
    }
    red[tid] = contrib;
    red[B + tid] = w * hf;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float xn = valid ? (accept ? x[i] : x_state[i * C + c]) : 0.0f;
      red[(2 + i) * B + tid] = xn;
      red[(2 + D + i) * B + tid] = xn * xn;
    }
    block_tree(red, Q);
    store_partials(red, Q, partials + Q * nb, nb);
    grid.sync();
    tile_totals(partials + Q * nb, Q, nb, pt.first_block, pt.n_blocks, tot);
    // T: Adam ascent on the ChEES gradient, clipped to [log eps, log(L eps)]
    const float den = fmaxf(tot[1], 1e-6f);
    const float traj_len = us[e] * expf(lT);
    float gT = traj_len * tot[0] / den;
    gT = gT < -1e6f ? -1e6f : (gT > 1e6f ? 1e6f : gT);
    am = k.b1 * am + k.one_minus_b1 * gT;
    av = k.b2 * av + k.one_minus_b2 * gT * gT;
    const float m_hat = am / (1.0f - expf(t * k.log_b1));
    const float v_hat = av / (1.0f - expf(t * k.log_b2));
    const float log_eps_now = logf(expf(le));
    lT = lT + k.lr * m_hat / (sqrtf(v_hat) + 1e-8f);
    lT = nan_min(nan_max(lT, log_eps_now), k.log_max_leapfrog + log_eps_now);
    lTb = eta * lT + (1.0f - eta) * lTb;
    // M^-1: the tile's Welford moments from this step's sums (CGL merge)
    const float n_new = n + cn;
    for (int i = tid; i < D; i += B) {
      const float sx = tot[2 + i], sx2 = tot[2 + D + i];
      sum1_sh[i] = sum1_sh[i] + sx;
      sum2_sh[i] = sum2_sh[i] + sx2;
      if (adapt_mass) {
        const float b_mean = sx / cn;
        const float m2_b = sx2 - sx * sx / cn;
        const float dlt = b_mean - mean_sh[i];
        mean_sh[i] = mean_sh[i] + (cn / n_new) * dlt;
        const float m2 = m2_sh[i] + m2_b + (n * cn / n_new) * dlt * dlt;
        m2_sh[i] = m2;
        const float var = m2 / fmaxf(n_new - 1.0f, 1.0f);
        const float est = (n_new / (n_new + k.mass_reg)) * var +
                          1e-3f * (k.mass_reg / (n_new + k.mass_reg));
        if (n_new >= k.warm_start) minv_sh[i] = est;
      }
    }
    if (adapt_mass) n = n_new;
    t = t + 1.0f;
    if (valid) {
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
    }
    __syncthreads();  // M^-1 and the totals are read again next step
  }
  if (valid) {
    lp_out[c] = lp;
    acc_out[c] = accept ? 1.0f : 0.0f;
  }
  if ((int64_t)blockIdx.x == pt.first_block) {
    const int64_t nt = C / tile + (C % tile != 0);
    if (tid == 0) {
      const float sv[9] = {le, leb, hb, lT, lTb, am, av, t, n};
      for (int q = 0; q < 9; ++q) sv_tiles[q * nt + pt.tile] = sv[q];
    }
    for (int i = tid; i < D; i += B) {
      sum_x[i * nt + pt.tile] = sum1_sh[i];
      sum_x2[i * nt + pt.tile] = sum2_sh[i];
    }
  }
}

template <class Density>
int launch_chees_warmup(const float* params_t, const float* lp, const float* grad,
                        const float* sv_in, const float* minv_in, const int* trips,
                        const float* us, int E, int64_t n_groups, const float* consts,
                        int n_consts, CheesConsts k, int adapt_mass, uint64_t seed,
                        uint64_t offset, int64_t C, int64_t tile, float* x_state,
                        float* lp_out, float* g_state, float* acc_out, float* sv_tiles,
                        float* sum_x, float* sum_x2, float* partials, int64_t nb,
                        cudaStream_t stream) {
  constexpr int D = Density::kDim;
  constexpr int Q = 2 + 2 * D;
  if (tile < 1 || nb != pool_blocks(C / tile, tile, C % tile))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(consts_floats(n_consts) + Q * kPoolBlock + Q + 5 * D) * sizeof(float);
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  void* args[] = {&params_t, &lp,   &grad,     &sv_in,   &minv_in,  &trips,
                  &us,       &E,    &n_groups, &consts,  &n_consts, &k,
                  &adapt_mass, &k0, &k1,       &offset,  &C,        &tile,
                  &x_state,  &lp_out, &g_state, &acc_out, &sv_tiles, &sum_x,
                  &sum_x2,   &partials, &nb};
  return launch_cooperative(chees_warmup_kernel<Density>, nb, smem, args, stream);
}

// Sample e is the state after (e+1)*thin trajectories; trajectory k of the
// launch is absolute step offset + k + 1.
template <class Density>
__global__ void __launch_bounds__(GroupShape<Density>::kThreads, GroupShape<Density>::kMinBlocks)
    chees_frozen_kernel(const float* __restrict__ params_t, const float* __restrict__ lp_in,
                        const float* __restrict__ grad_in, const float* __restrict__ eps_in,
                        int eps_per_chain, const float* __restrict__ minv_in,
                        const float* __restrict__ consts, int n_consts,
                        const int* __restrict__ trips, int P, int64_t phase, uint32_t k0,
                        uint32_t k1, int64_t thin, int64_t n_samples, uint64_t offset,
                        int64_t C, float* __restrict__ samples, float* __restrict__ lps,
                        float* __restrict__ accs, float* __restrict__ g_state) {
  constexpr int D = Density::kDim;
  constexpr int kJ = GroupShape<Density>::kJ;
  // not `sh`: the warmup kernel above declares that name without the alignment
  extern __shared__ __align__(16) float sh_group[];
  const GroupChain ch = group_chain<Density>(sh_group, consts, n_consts);
  const int64_t c = ch.c;
  if (c >= C) return;  // the chain's lanes leave together
  float x[kJ], g[kJ], x0[kJ], g0[kJ], minv[kJ];
  lane_load<kJ>(params_t, ch, C, x);
  lane_load<kJ>(grad_in, ch, C, g);
#pragma unroll
  for (int k = 0; k < kJ; ++k) {
    x0[k] = x[k];
    g0[k] = g[k];
    minv[k] = minv_in[ch.j0 + k];
  }
  float lp = lp_in[c];
  const float eps = eps_in[eps_per_chain ? c : 0];
  uint64_t j = offset;
  int64_t traj = phase;
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t s = 0; s < thin; ++s, ++traj)
      accepted = group_hmc_step<Density>(x, lp, g, x0, g0, minv, eps, __ldg(trips + traj % P),
                                         sh_group, n_consts, ch.scratch, ch.ln, c, ++j, k0, k1);
    lane_store<kJ>(samples + e * D * C, ch, C, x);
    if (ch.ln.lane == 0) {
      lps[e * C + c] = lp;
      accs[e * C + c] = accepted ? 1.0f : 0.0f;
    }
  }
  lane_store<kJ>(g_state, ch, C, g);
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities with a value_and_grad that both kernels are instantiated
// for: the one list of the pairs (see csrc/common.cuh). NealFunnel<10> has no
// group form and runs one thread a chain in both.
#define AMH_CHEES_DENSITIES(X) \
  X(amh::GaussianMeanScale)    \
  X(amh::CorrelatedGaussian<2>) \
  X(amh::LogisticRegression<32>) \
  X(amh::NealFunnel<10>)

extern "C" {

int amh_chees_warmup(const char* density, int32_t d, const void* params_t,
                     const void* lp, const void* grad, const void* sv_in,
                     const void* minv_in, const void* trips, const void* us, int32_t E,
                     int64_t n_groups, const void* consts, int32_t n_consts,
                     float target, float t0, float kappa, float gamma, float mu,
                     float lr, float b1, float one_minus_b1, float b2,
                     float one_minus_b2, float log_b1, float log_b2,
                     float log_max_leapfrog, float mass_reg, float warm_start,
                     int32_t adapt_mass, uint64_t seed, uint64_t offset, int64_t C,
                     int64_t tile, void* x_state, void* lp_out, void* g_state,
                     void* acc_out, void* sv_tiles, void* sum_x, void* sum_x2,
                     void* partials, int64_t nb, void* stream) {
  const amh::CheesConsts k{target, t0,     kappa,        gamma,  mu,
                           lr,     b1,     one_minus_b1, b2,     one_minus_b2,
                           log_b1, log_b2, log_max_leapfrog, mass_reg, warm_start};
#define X(T)                                                                    \
  if (amh::matches<T>(density, d))                                              \
    return amh::launch_chees_warmup<T>(                                         \
        (const float*)params_t, (const float*)lp, (const float*)grad,           \
        (const float*)sv_in, (const float*)minv_in, (const int*)trips,          \
        (const float*)us, E, n_groups, (const float*)consts, n_consts, k,        \
        adapt_mass, seed, offset, C, tile, (float*)x_state, (float*)lp_out,     \
        (float*)g_state, (float*)acc_out, (float*)sv_tiles, (float*)sum_x,      \
        (float*)sum_x2, (float*)partials, nb, (cudaStream_t)stream);
  AMH_CHEES_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

int amh_chees_frozen_sample(const char* density, int32_t d, const void* params_t,
                            const void* lp, const void* grad, const void* eps,
                            int32_t eps_per_chain, const void* minv, const void* consts,
                            int32_t n_consts, const void* trips, int32_t P,
                            int64_t phase, uint64_t seed, int64_t thin,
                            int64_t n_samples, uint64_t offset, int64_t C,
                            void* samples, void* lps, void* accs, void* g_state,
                            void* stream) {
  if (P < 1 || phase < 0) return (int)cudaErrorInvalidValue;
#define X(T)                                                                           \
  if (amh::matches<T>(density, d))                                                     \
    return amh::launch_group<T>(                                                       \
        amh::chees_frozen_kernel<T>, n_consts, C, (cudaStream_t)stream,                \
        (const float*)params_t, (const float*)lp, (const float*)grad,                  \
        (const float*)eps, (int)eps_per_chain, (const float*)minv,                     \
        (const float*)consts, n_consts, (const int*)trips, (int)P, phase,              \
        (uint32_t)seed, (uint32_t)(seed >> 32), thin, n_samples, offset, C,            \
        (float*)samples, (float*)lps, (float*)accs, (float*)g_state);
  AMH_CHEES_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

// The frozen kernel's launch shape for C chains
// (csrc/hmc_group.cuh::group_launch_info).
int amh_chees_frozen_info(const char* density, int32_t d, int32_t n_consts, int64_t C,
                          int64_t* out) {
#define X(T)                       \
  if (amh::matches<T>(density, d)) \
    return amh::group_launch_info<T>(amh::chees_frozen_kernel<T>, n_consts, C, out);
  AMH_CHEES_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_chees() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_CHEES_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
