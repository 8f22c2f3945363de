// Preconditioned Crank-Nicolson kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_pcn.py::_pcn_kernel: burn-in, then
// n_samples thinned draws of pCN for a target likelihood x N(m, Sigma) whose
// density (the functor) is the log-likelihood only:
//   x' = (m + rho (x - m)) + beta (L z)   (L z in IEEE float32, or sigma z),
//   accepted iff log u < lp(x') - lp(x),
// with rho = sqrt(1 - beta^2) rounded once from float64 by the caller. The
// noise of a step is RWMH's (d normals and the accept uniform, word 2P),
// each step from its own counter (the TPU kernel pairs two steps' normals
// from one Box-Muller draw, a layout choice not carried over). The plain
// PyTorch version is ops/pcn.py::pcn_sample_reference; the C entry point at
// the end is bound there with ctypes.
//
// Layout: elliptical slice sampling's step with one likelihood evaluation
// and no trips, on the block shape, start and prior draw of
// csrc/gp_group.cuh: a chain on the 8 lanes of its likelihood's group form,
// coordinate i on lane i mod 8 (x, m and a diagonal scale at the lane's
// coordinates in registers), 16 chains a 128-thread block, at least 4 blocks
// an SM, L's padded rows and each chain's staged normals in shared memory.
// A step: L z from the staged normals (gp_group.cuh::prior_draw), the lane's
// coordinates of the proposal, the likelihood from the 8 partials in order;
// log u comes from word 2P, so the decision is the same in every lane. Lane
// 0 writes lp and the decision of each draw; the draw itself goes out
// through shared memory, a row of the block's 16 chains at a time.
//
// What bounds it on this card: at d = 64 a step is the d(d+1)/2 products of
// L z (288 a lane with the zeros), the d normals and one likelihood (8
// points a lane); the emission's bytes (d + 2 floats a chain and draw) set
// a bound below. Written by each warp's 4 chains, 16 bytes in each of 8
// rows a store, the draws took a third of the launch on an H100 at 8192 x
// (1999 + 4000); written as the block's 64-byte rows, the launch is a
// quarter shorter.
//
// Numerics: --fmad=false, no --use_fast_math (see ops/_build.py). The accept
// test is log u < lp' - lp, so a NaN candidate rejects.

#include "gp_group.cuh"

namespace amh {

struct PcnConstants {
  float rho;   // sqrt(1 - beta^2)
  float beta;
};

// One pCN step of absolute index j for chain c over the lane's coordinates
// (mu and diag the lane's coordinates of m and of a diagonal scale); returns
// whether the proposal was accepted, the same in every lane of the chain.
template <class Density, bool kTril>
__device__ __forceinline__ bool pcn_step(float (&x)[GroupForm<Density>::kJ], float& lp,
                                         const float (&mu)[GroupForm<Density>::kJ],
                                         const float (&diag)[GroupForm<Density>::kJ],
                                         const PcnConstants& k, const float* sh,
                                         const PriorChain& ch, uint64_t j, uint32_t k0,
                                         uint32_t k1) {
  using GF = GroupForm<Density>;
  constexpr int kJ = GF::kJ;
  constexpr int P = (Density::kDim + 1) / 2;
  StepWords s(j, (uint32_t)ch.c, k0, k1);
  float y[kJ];  // L z, then the proposal
  prior_draw<Density, kTril>(s, diag, ch, y);
#pragma unroll
  for (int q = 0; q < kJ; ++q) y[q] = (mu[q] + k.rho * (x[q] - mu[q])) + k.beta * y[q];
  const float logu = logf(s.uniform(2 * P));
  const float lp_y = GF::logp(y, sh, ch.ln);
  const bool accept = logu < lp_y - lp;
#pragma unroll
  for (int q = 0; q < kJ; ++q) x[q] = accept ? y[q] : x[q];
  lp = accept ? lp_y : lp;
  return accept;
}

// The kernel's dynamic shared memory: PriorShape's, then the block's draw
// staged by coordinate, kStageRow floats a coordinate (its kChains chains,
// then 4 floats of padding, so that the 32 lanes of a warp write 32 banks).
template <class Density, bool kTril>
struct PcnShape : PriorShape<Density, kTril> {
  using P = PriorShape<Density, kTril>;
  static constexpr int kStageRow = P::kChains + 4;

  __host__ __device__ static int stage_offset(int n_consts) { return P::smem_floats(n_consts); }
  __host__ __device__ static int smem_floats(int n_consts) {
    return stage_offset(n_consts) + P::D * kStageRow;
  }
};

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...). A draw goes out through
// shared memory: each lane stages its coordinates, then the block writes
// each coordinate's row of its chains as one contiguous run (16 chains, 64
// bytes) where a warp's own 4 chains would write 16 bytes of 8 rows. So
// every chain of the block, one past the end of the batch too, reaches the
// block's barriers; such a chain takes no step.
template <class Density, bool kTril>
__global__ void __launch_bounds__(GroupShape<Density>::kThreads, GroupShape<Density>::kMinBlocks)
    pcn_sample_kernel(const float* __restrict__ params_t,
                      const float* __restrict__ lp_in, const float* __restrict__ mean,
                      const float* __restrict__ scale, const float* __restrict__ consts,
                      int n_consts, PcnConstants k, uint32_t k0, uint32_t k1,
                      int64_t burn, int64_t thin, int64_t n_samples, uint64_t offset,
                      int64_t C, float* __restrict__ samples, float* __restrict__ lps,
                      float* __restrict__ accs) {
  using GF = GroupForm<Density>;
  using S = PcnShape<Density, kTril>;
  constexpr int D = Density::kDim;
  constexpr int kJ = GF::kJ;
  extern __shared__ __align__(16) float sh[];
  const PriorChain ch = prior_chain<Density, kTril>(sh, consts, n_consts, scale);
  const int64_t c = ch.c;
  const bool live = c < C;
  const int slot = threadIdx.x / S::kLanes;
  const int64_t c0 = (int64_t)blockIdx.x * S::kChains;
  const int n_live = C - c0 < S::kChains ? (int)(C - c0) : S::kChains;
  float* stage = sh + S::stage_offset(n_consts);
  float x[kJ], mu[kJ], diag[kJ];
  float lp = 0.0f;
  uint64_t j = offset;
  if (live) {
    lane_column<Density>(params_t, ch, C, x);
    lane_vector<Density>(mean, ch, mu);
#pragma unroll
    for (int q = 0; q < kJ; ++q) diag[q] = kTril ? 0.0f : scale[GF::coord(ch.ln.lane, q)];
    lp = lp_in[c];
    for (int64_t t = 0; t < burn; ++t)
      pcn_step<Density, kTril>(x, lp, mu, diag, k, sh, ch, ++j, k0, k1);
  }
  for (int64_t e = 0; e < n_samples; ++e) {
    if (live) {
      bool accepted = false;
      for (int64_t t = 0; t < thin; ++t)
        accepted = pcn_step<Density, kTril>(x, lp, mu, diag, k, sh, ch, ++j, k0, k1);
#pragma unroll
      for (int q = 0; q < kJ; ++q) stage[GF::coord(ch.ln.lane, q) * S::kStageRow + slot] = x[q];
      if (ch.ln.lane == 0) {
        lps[e * C + c] = lp;
        accs[e * C + c] = accepted ? 1.0f : 0.0f;
      }
    }
    __syncthreads();
    for (int f = threadIdx.x; f < D * S::kChains; f += blockDim.x) {
      const int i = f / S::kChains, s = f % S::kChains;
      if (s < n_live) samples[(e * D + i) * C + c0 + s] = stage[i * S::kStageRow + s];
    }
    __syncthreads();  // the block has read the draw before its next one is staged
  }
}

template <class Density, bool kTril>
int launch_pcn(const float* params_t, const float* lp, const float* mean,
               const float* scale, const float* consts, int n_consts, PcnConstants k,
               uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
               uint64_t offset, int64_t C, float* samples, float* lps, float* accs,
               cudaStream_t stream) {
  return launch_group<Density, PcnShape<Density, kTril>>(
      pcn_sample_kernel<Density, kTril>, n_consts, C, stream, params_t, lp, mean, scale,
      consts, n_consts, k, (uint32_t)seed, (uint32_t)(seed >> 32), burn, thin, n_samples,
      offset, C, samples, lps, accs);
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The likelihoods the kernel is instantiated for (each with a diagonal and a
// lower-triangular prior scale): the one list of the pairs (see
// csrc/common.cuh).
#define AMH_PCN_DENSITIES(X)     \
  X(amh::GPRegression<16>)       \
  X(amh::GPRegression<64>)       \
  X(amh::GPClassification<16>)   \
  X(amh::GPClassification<64>)

extern "C" {

int amh_pcn_sample(const char* density, int32_t d, int32_t tril, const void* params_t,
                   const void* lp, const void* mean, const void* scale,
                   const void* consts, int32_t n_consts, float rho, float beta,
                   uint64_t seed, int64_t burn, int64_t thin, int64_t n_samples,
                   uint64_t offset, int64_t C, void* samples, void* lps, void* accs,
                   void* stream) {
  const amh::PcnConstants k{rho, beta};
#define X(T)                                                                       \
  if (amh::matches<T>(density, d))                                                 \
    return (tril ? amh::launch_pcn<T, true> : amh::launch_pcn<T, false>)(          \
        (const float*)params_t, (const float*)lp, (const float*)mean,              \
        (const float*)scale, (const float*)consts, n_consts, k, seed, burn, thin,  \
        n_samples, offset, C, (float*)samples, (float*)lps, (float*)accs,          \
        (cudaStream_t)stream);
  AMH_PCN_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

// The kernel's launch shape for C chains (csrc/hmc_group.cuh::group_launch_info).
int amh_pcn_info(const char* density, int32_t d, int32_t tril, int32_t n_consts, int64_t C,
                 int64_t* out) {
#define X(T)                                                                        \
  if (amh::matches<T>(density, d))                                                  \
    return tril ? amh::group_launch_info<T, amh::PcnShape<T, true>>(                \
                      amh::pcn_sample_kernel<T, true>, n_consts, C, out)            \
                : amh::group_launch_info<T, amh::PcnShape<T, false>>(               \
                      amh::pcn_sample_kernel<T, false>, n_consts, C, out);
  AMH_PCN_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_pcn() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_PCN_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
