// Random-walk Metropolis kernels for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_mh.py:
//   rwmh_sample_kernel  <- _rwmh_sampling_kernel (burn-in, then thinned
//                          emission of samples / lps / accepted),
//   rwmh_kernel         <- _rwmh_kernel (n_steps with no emission; returns
//                          final params, lp and accept counts),
//   step_noise          <- _uniform_from_bits + _normal_pair, with the TPU
//                          hardware PRNG replaced by Philox4x32-10,
//   mh_step             <- _perturb_fn + the accept test of one_step.
// The plain PyTorch versions are in ops/rwmh.py; the C entry points at the
// end are bound there with ctypes.
//
// Layout as in the JAX kernels: chains on the last axis. params_t is (d, C),
// lp (1, C), emitted samples (N, d, C), lps and accepted (N, 1, C). One thread
// runs one chain with its state in registers; neighbouring threads are
// neighbouring chains, so every load and store of a step is coalesced. The
// last block is masked, so any C works without padding.
//
// What bounds it on this card: at d = 2 a step is ~30 FMA-class operations
// of the 30-observation density, a logf for the accept test and a logf, sqrtf
// and sincosf for Box-Muller, plus ten Philox rounds -- a chain of dependent
// arithmetic per thread. It is latency-bound, not bound by bytes or FLOPs:
// 16384 chains are 512 warps, under 4 per SM on 132 SMs, too few to hide the
// latency of the dependent chain. The emission writes 16 bytes per chain per
// kept sample, far below the memory bandwidth. This version keeps the kernel
// simple; more chains per thread (instruction-level parallelism) or a
// warp-split observation sum are later work.
//
// Numerics: build with --fmad=false and without --use_fast_math, so each
// multiply and add rounds as in the plain version and the transcendental
// functions are the accurate ones. What differs from PyTorch is then only the
// last ulp of logf / sincosf and the order of the observation sum, which
// leaves lp a few bits off the plain version's and, rarely, flips an accept
// test that lands on its threshold (ops/_build.py has the measured rates).

#include "common.cuh"

namespace amh {

constexpr int kBlock = 128;

// ---- one MH step --------------------------------------------------------

// candidate = x + scale * z (per-dimension) or x + L z (lower-triangular L,
// row-major, column accumulation as in the plain version); accept iff
// log(u) < lp_cand - lp, so a NaN or -inf candidate is rejected and a -inf
// current state accepts any finite candidate.
template <class Density, bool kTril>
__device__ __forceinline__ bool mh_step(float (&x)[Density::kDim], float& lp,
                                        const float* scale, const float* consts,
                                        int n_consts, uint64_t j, uint32_t c,
                                        uint32_t k0, uint32_t k1) {
  constexpr int D = Density::kDim;
  float z[D];
  float logu;
  step_noise<D>(j, c, k0, k1, z, logu);
  float cand[D];
  if (kTril) {
    tril_matvec<D>(scale, z, cand);
#pragma unroll
    for (int i = 0; i < D; ++i) cand[i] = x[i] + cand[i];
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) cand[i] = x[i] + scale[i] * z[i];
  }
  const float lp_cand = Density::logp(cand, consts, n_consts);
  const bool accept = logu < lp_cand - lp;
  if (accept) {
#pragma unroll
    for (int i = 0; i < D; ++i) x[i] = cand[i];
    lp = lp_cand;
  }
  return accept;
}

// Shared set-up of both kernels: the density's constants into shared memory
// (once per block), then the chain's scale and state into registers.
template <class Density, bool kTril>
struct ChainState {
  static constexpr int D = Density::kDim;
  static constexpr int kScale = kTril ? D * D : D;
  float scale[kScale];
  float x[D];
  float lp;
};

template <class Density, bool kTril>
__device__ __forceinline__ void load_state(ChainState<Density, kTril>& st,
                                           const float* params_t,
                                           const float* lp_in,
                                           const float* scale, int64_t c,
                                           int64_t C) {
#pragma unroll
  for (int i = 0; i < ChainState<Density, kTril>::kScale; ++i)
    st.scale[i] = scale[i];
#pragma unroll
  for (int i = 0; i < Density::kDim; ++i) st.x[i] = params_t[i * C + c];
  st.lp = lp_in[c];
}

// ---- kernel A: burn-in + thinned emission --------------------------------

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...).
template <class Density, bool kTril>
__global__ void __launch_bounds__(kBlock)
    rwmh_sample_kernel(const float* __restrict__ params_t,
                       const float* __restrict__ lp_in,
                       const float* __restrict__ scale,
                       const float* __restrict__ consts, int n_consts,
                       uint32_t k0, uint32_t k1, int64_t burn, int64_t thin,
                       int64_t n_samples, uint64_t offset, int64_t C,
                       float* __restrict__ samples, float* __restrict__ lps,
                       float* __restrict__ accs) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh_consts[];
  load_consts(sh_consts, consts, n_consts);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  ChainState<Density, kTril> st;
  load_state(st, params_t, lp_in, scale, c, C);
  uint64_t j = offset;
  for (int64_t t = 0; t < burn; ++t)
    mh_step<Density, kTril>(st.x, st.lp, st.scale, sh_consts, n_consts, ++j,
                            (uint32_t)c, k0, k1);
  for (int64_t e = 0; e < n_samples; ++e) {
    bool accepted = false;
    for (int64_t t = 0; t < thin; ++t)
      accepted = mh_step<Density, kTril>(st.x, st.lp, st.scale, sh_consts,
                                         n_consts, ++j, (uint32_t)c, k0, k1);
#pragma unroll
    for (int i = 0; i < D; ++i) samples[(e * D + i) * C + c] = st.x[i];
    lps[e * C + c] = st.lp;
    accs[e * C + c] = accepted ? 1.0f : 0.0f;
  }
}

// ---- kernel B: n_steps with no emission (any n_steps, odd included) -------

template <class Density, bool kTril>
__global__ void __launch_bounds__(kBlock)
    rwmh_kernel(const float* __restrict__ params_t,
                const float* __restrict__ lp_in,
                const float* __restrict__ scale,
                const float* __restrict__ consts, int n_consts, uint32_t k0,
                uint32_t k1, int64_t n_steps, uint64_t offset, int64_t C,
                float* __restrict__ out_params, float* __restrict__ out_lp,
                float* __restrict__ out_acc) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh_consts[];
  load_consts(sh_consts, consts, n_consts);
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  ChainState<Density, kTril> st;
  load_state(st, params_t, lp_in, scale, c, C);
  uint64_t j = offset;
  float count = 0.0f;
  for (int64_t t = 0; t < n_steps; ++t)
    count += mh_step<Density, kTril>(st.x, st.lp, st.scale, sh_consts,
                                     n_consts, ++j, (uint32_t)c, k0, k1)
                 ? 1.0f
                 : 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) out_params[i * C + c] = st.x[i];
  out_lp[c] = st.lp;
  out_acc[c] = count;
}

// ---- host-side launch ------------------------------------------------------

inline dim3 grid_for(int64_t C) { return dim3((unsigned)((C + kBlock - 1) / kBlock)); }

template <class Density, bool kTril>
int launch_sample(const float* params_t, const float* lp, const float* scale,
                  const float* consts, int n_consts, uint64_t seed,
                  int64_t burn, int64_t thin, int64_t n_samples,
                  uint64_t offset, int64_t C, float* samples, float* lps,
                  float* accs, cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(rwmh_sample_kernel<Density, kTril>, smem);
  if (err != cudaSuccess) return (int)err;
  rwmh_sample_kernel<Density, kTril>
      <<<grid_for(C), kBlock, smem, stream>>>(
          params_t, lp, scale, consts, n_consts, (uint32_t)seed,
          (uint32_t)(seed >> 32), burn, thin, n_samples, offset, C, samples,
          lps, accs);
  return (int)cudaGetLastError();
}

template <class Density, bool kTril>
int launch_steps(const float* params_t, const float* lp, const float* scale,
                 const float* consts, int n_consts, uint64_t seed,
                 int64_t n_steps, uint64_t offset, int64_t C,
                 float* out_params, float* out_lp, float* out_acc,
                 cudaStream_t stream) {
  const size_t smem = n_consts * sizeof(float);
  const cudaError_t err = allow_shared(rwmh_kernel<Density, kTril>, smem);
  if (err != cudaSuccess) return (int)err;
  rwmh_kernel<Density, kTril>
      <<<grid_for(C), kBlock, smem, stream>>>(
          params_t, lp, scale, consts, n_consts, (uint32_t)seed,
          (uint32_t)(seed >> 32), n_steps, offset, C, out_params, out_lp,
          out_acc);
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities both kernels are instantiated for. This list is the one
// place that says which (density, d) pairs exist: it dispatches the entry
// points, which return amh::kNoKernel for any other pair (the wrapper turns
// that into a ValueError), and amh_pairs_rwmh() exports it.
#define AMH_RWMH_DENSITIES(X)                                           \
  X(amh::GaussianMeanScale)                                             \
  X(amh::CorrelatedGaussian<2>)                                         \
  X(amh::CorrelatedGaussian<4>)                                         \
  X(amh::CorrelatedGaussian<8>)                                         \
  X(amh::EmceeDemo)                                                     \
  X(amh::LogisticRegression<32>)

extern "C" {

int amh_rwmh_sample(const char* density, int32_t d, int32_t tril,
                    const void* params_t, const void* lp, const void* scale,
                    const void* consts, int32_t n_consts, uint64_t seed,
                    int64_t burn, int64_t thin, int64_t n_samples,
                    uint64_t offset, int64_t C, void* samples, void* lps,
                    void* accs, void* stream) {
#define X(T)                                                                \
  if (amh::matches<T>(density, d))                                          \
    return (tril ? amh::launch_sample<T, true> : amh::launch_sample<T, false>)( \
        (const float*)params_t, (const float*)lp, (const float*)scale,      \
        (const float*)consts, n_consts, seed, burn, thin, n_samples, offset, \
        C, (float*)samples, (float*)lps, (float*)accs, (cudaStream_t)stream);
  AMH_RWMH_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

int amh_rwmh(const char* density, int32_t d, int32_t tril, const void* params_t,
             const void* lp, const void* scale, const void* consts,
             int32_t n_consts, uint64_t seed, int64_t n_steps, uint64_t offset,
             int64_t C, void* out_params, void* out_lp, void* out_acc,
             void* stream) {
#define X(T)                                                                \
  if (amh::matches<T>(density, d))                                          \
    return (tril ? amh::launch_steps<T, true> : amh::launch_steps<T, false>)( \
        (const float*)params_t, (const float*)lp, (const float*)scale,      \
        (const float*)consts, n_consts, seed, n_steps, offset, C,           \
        (float*)out_params, (float*)out_lp, (float*)out_acc,                \
        (cudaStream_t)stream);
  AMH_RWMH_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_rwmh() {
  static const std::string text = [] {
    std::string s;
#define X(T) s += amh::pair_text<T>();
    AMH_RWMH_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

const char* amh_error_string(int32_t code) {
  if (code == amh::kNoKernel) return "no kernel instantiated for this (density, d)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
