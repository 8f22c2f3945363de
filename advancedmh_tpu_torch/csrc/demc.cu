// Differential-evolution MCMC (DE-MC) kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_demc.py::_demc_kernel: burn-in, then
// n_samples thinned draws of the red-black DE-MC move (ter Braak 2006) on one
// population of M members (any even M >= 6), split into halves of H = M/2. A
// step moves the first half against the frozen second half, then the second
// half against the updated first half. A moving member x draws two distinct
// members r1, r2 of the other half and proposes
//   y = (x + g (x_r1 - x_r2)) + noise z,  g = 1 with probability p_jump
//   (a mode jump), else gamma,
// or, with probability p_snooker (ter Braak and Vrugt 2008), the snooker
// move along e = x - x_z through a third member z:
//   coef = (gs (x_r1 - x_r2).e) / |e|^2,  y = x + coef e,
//   log ratio = (d - 1)/2 (log |y - x_z|^2 - log |e|^2),
// with the guards |e|^2 > 1e-30 and |y - x_z|^2 > 1e-30 (a failed guard
// gives log ratio -1e30, as the Pallas kernel; the torch engine keeps XLA's
// -inf, and both reject). It accepts iff log u < (lp(y) - lp(x)) + log ratio.
// The plain PyTorch version is ops/demc.py::demc_sample_reference; the C
// entry point at the end is bound there with ctypes.
//
// Indices (the draws are uniforms u in (0, 1)): r1 = floor(u H) clamped to
// H - 1 (as csrc/emcee.cu clamps its partner); r2 = floor(u (H - 1)) clamped
// to H - 2, then bumped past r1; z = floor(u (H - 2)) clamped to H - 3, then
// bumped past min(r1, r2) and then past max(r1, r2). The clamps only catch
// a product that rounds up to its bound.
//
// Noise of absolute step j of member w (common.cuh::StepWords with the
// member index as the chain): word 0 draws r1, 1 r2, 2 the jump, 3 the
// accept uniform, 4 .. 4 + 2P - 1 the noise normals (P = ceil(d/2)
// Box-Muller pairs), 4 + 2P the snooker member z and 4 + 2P + 1 the snooker
// choice.
//
// Design as csrc/emcee.cu: the TPU kernel gathers x_r1 - x_r2 (and x_z) with
// one-hot matmuls because members sit on vector lanes; here they are indexed
// loads. Every half-move reads the whole other half, and the main path's
// population (16384 members) spans many blocks, so the kernel is launched
// cooperatively with as many blocks as are co-resident, the active members
// grid-strided over all threads, and the grid synchronises after each
// half-move. The state (d + 1 floats a member) lives in device memory, where
// it stays in L2; state that other blocks wrote is read with __ldcg (L1 is
// not coherent across SMs) and written with __stcg.
//
// What bounds it on this card: two grid barriers a step and, between them,
// one short dependent chain per member (Philox, Box-Muller, the density, a
// logf) with H = 8192 active members -- under 2 warps per SM, bound by
// latency and barriers, not by bytes or operations.
//
// Numerics: --fmad=false, no --use_fast_math, as the other kernels.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace amh {

constexpr int kDemcBlock = 256;

struct DemcParams {
  float gamma;          // the DE scale, 2.38/sqrt(2d) unless given
  float noise;          // the noise scale
  float p_jump;         // probability of a g = 1 move
  float p_snooker;      // probability of a snooker move (0: none drawn)
  float snooker_gamma;  // gs
  float half_dm1;       // (d - 1)/2, rounded once from float64
};

template <class Density>
__global__ void __launch_bounds__(kDemcBlock)
    demc_sample_kernel(float* __restrict__ x_state, float* __restrict__ lp_state,
                       const float* __restrict__ consts, int n_consts, DemcParams prm,
                       int64_t M, uint32_t k0, uint32_t k1, int64_t burn, int64_t thin,
                       int64_t n_samples, uint64_t offset, float* __restrict__ samples,
                       float* __restrict__ lps, float* __restrict__ accs) {
  constexpr int D = Density::kDim;
  constexpr int P = (D + 1) / 2;
  extern __shared__ float sh_consts[];
  load_consts(sh_consts, consts, n_consts);
  cg::grid_group grid = cg::this_grid();
  if (!grid.is_valid()) return;  // not a cooperative launch: never wait on it
  const int64_t H = M / 2;
  const float Hf = (float)H;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool snooker_on = prm.p_snooker > 0.0f;
  const int64_t total = burn + n_samples * thin;
  for (int64_t t = 1; t <= total; ++t) {
    const uint64_t j = offset + (uint64_t)t;
    const bool emit = t > burn && (t - burn) % thin == 0;
    const int64_t e = (t - burn) / thin - 1;
    for (int h = 0; h < 2; ++h) {
      const int64_t other = (1 - h) * H;
      for (int64_t ai = first; ai < H; ai += stride) {
        const int64_t w = h * H + ai;
        StepWords words(j, (uint32_t)w, k0, k1);
        int64_t r1 = (int64_t)floorf(words.uniform(0) * Hf);
        r1 = r1 < H - 1 ? r1 : H - 1;
        int64_t r2 = (int64_t)floorf(words.uniform(1) * (Hf - 1.0f));
        r2 = r2 < H - 2 ? r2 : H - 2;
        r2 += r2 >= r1;
        const float g = words.uniform(2) < prm.p_jump ? 1.0f : prm.gamma;
        float z[D], x[D], diff[D], y[D];
        step_normals<D>(words, z, 4);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          x[i] = __ldcg(x_state + i * M + w);
          diff[i] = __ldcg(x_state + i * M + other + r1) - __ldcg(x_state + i * M + other + r2);
          y[i] = (x[i] + g * diff[i]) + prm.noise * z[i];
        }
        float log_ratio = 0.0f;
        if (snooker_on) {
          int64_t rz = (int64_t)floorf(words.uniform(4 + 2 * P) * (Hf - 2.0f));
          rz = rz < H - 3 ? rz : H - 3;
          const int64_t lo = r1 < r2 ? r1 : r2;
          const int64_t hi = r1 < r2 ? r2 : r1;
          rz += rz >= lo;
          rz += rz >= hi;
          float ev[D], xz[D];
          float ee = 0.0f, de = 0.0f;
#pragma unroll
          for (int i = 0; i < D; ++i) {
            xz[i] = __ldcg(x_state + i * M + other + rz);
            ev[i] = x[i] - xz[i];
            ee = i == 0 ? ev[i] * ev[i] : ee + ev[i] * ev[i];
            de = i == 0 ? diff[i] * ev[i] : de + diff[i] * ev[i];
          }
          const bool safe = ee > 1e-30f;
          const float coef = prm.snooker_gamma * de * (safe ? 1.0f / fmaxf(ee, 1e-30f) : 0.0f);
          float ys[D], ee_y = 0.0f;
#pragma unroll
          for (int i = 0; i < D; ++i) {
            ys[i] = x[i] + coef * ev[i];
            const float ey = ys[i] - xz[i];
            ee_y = i == 0 ? ey * ey : ee_y + ey * ey;
          }
          const float log_j =
              safe && ee_y > 1e-30f
                  ? prm.half_dm1 * (logf(fmaxf(ee_y, 1e-30f)) - logf(fmaxf(ee, 1e-30f)))
                  : -1e30f;
          if (words.uniform(4 + 2 * P + 1) < prm.p_snooker) {
#pragma unroll
            for (int i = 0; i < D; ++i) y[i] = ys[i];
            log_ratio = log_j;
          }
        }
        const float lp_x = __ldcg(lp_state + w);
        const float lp_y = Density::logp(y, sh_consts, n_consts);
        const bool accept = logf(words.uniform(3)) < lp_y - lp_x + log_ratio;
        if (accept) {
#pragma unroll
          for (int i = 0; i < D; ++i) __stcg(x_state + i * M + w, y[i]);
          __stcg(lp_state + w, lp_y);
        }
        if (emit) {
#pragma unroll
          for (int i = 0; i < D; ++i) samples[(e * D + i) * M + w] = accept ? y[i] : x[i];
          lps[e * M + w] = accept ? lp_y : lp_x;
          accs[e * M + w] = accept ? 1.0f : 0.0f;
        }
      }
      grid.sync();
    }
  }
}

template <class Density>
int launch_demc(float* x_state, float* lp_state, const float* consts, int n_consts,
                DemcParams prm, int64_t M, uint64_t seed, int64_t burn, int64_t thin,
                int64_t n_samples, uint64_t offset, float* samples, float* lps, float* accs,
                cudaStream_t stream) {
  if (M < 6 || M % 2 != 0) return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = (size_t)n_consts * sizeof(float);
  auto* kernel = demc_sample_kernel<Density>;
  if (err == cudaSuccess) err = allow_shared(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDemcBlock, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int64_t needed = (M / 2 + kDemcBlock - 1) / kDemcBlock;
  const int64_t resident = (int64_t)per_sm * n_sm;
  const dim3 grid((unsigned)(needed < resident ? needed : resident));
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  void* args[] = {&x_state, &lp_state, &consts, &n_consts, &prm, &M, &k0, &k1,
                  &burn, &thin, &n_samples, &offset, &samples, &lps, &accs};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid, dim3(kDemcBlock), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities the kernel is instantiated for: the one list of the pairs
// (see csrc/common.cuh).
#define AMH_DEMC_DENSITIES(X) \
  X(amh::EmceeDemo)           \
  X(amh::CorrelatedGaussian<2>)

extern "C" {

// x_state (d, M) and lp_state (M) hold the start and are updated in place.
int amh_demc_sample(const char* density, int32_t d, void* x_state, void* lp_state,
                    const void* consts, int32_t n_consts, float gamma, float noise,
                    float p_jump, float p_snooker, float snooker_gamma, float half_dm1,
                    int64_t M, uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                    uint64_t offset, void* samples, void* lps, void* accs, void* stream) {
  const amh::DemcParams prm{gamma, noise, p_jump, p_snooker, snooker_gamma, half_dm1};
#define X(T)                                                                                 \
  if (amh::matches<T>(density, d))                                                           \
    return amh::launch_demc<T>((float*)x_state, (float*)lp_state, (const float*)consts,      \
                               n_consts, prm, M, seed, burn, thin, n_samples, offset,        \
                               (float*)samples, (float*)lps, (float*)accs,                   \
                               (cudaStream_t)stream);
  AMH_DEMC_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_demc() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_DEMC_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
