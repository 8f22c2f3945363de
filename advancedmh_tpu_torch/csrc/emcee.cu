// Affine-invariant ensemble (emcee stretch move) kernel for Hopper (sm_90a).
//
// Replaces advancedmh_tpu/ops/pallas_emcee.py::_emcee_kernel: burn-in, then
// n_samples thinned draws of the red-black stretch move. The W walkers form
// W / T independent ensembles of T = tile_walkers walkers; each ensemble
// splits into halves of H = T/2. A step moves the first half against the
// frozen second half, then the second half against the updated first half.
// A moving walker x draws a partner p from the other half, z =
// ((a-1)u + 1)^2 / a, proposes y = p + z (x - p) and accepts iff
// log(u') <= (d-1) log z + lp(y) - lp(x) (<=, not <, as in the JAX kernel).
// The plain PyTorch version is ops/emcee.py::emcee_sample_reference; the C
// entry point at the end is bound there with ctypes.
//
// Random numbers: per walker and half-move, one Philox4x32-10 call with
// counter (low word of the absolute step j, global walker index, half, high
// word of j) gives the three uniforms (partner, z, accept) from words 0-2.
//
// Design. The TPU kernel gathers partners with a one-hot matmul because
// walkers sit on vector lanes; here the gather is an indexed load. The hard
// part is the barrier: every half-move reads the whole other half, and the
// sampler's one ensemble has W = 16384 walkers at full width -- more than a
// block holds, and one block per ensemble would use one SM of 132. So the
// kernel is launched cooperatively (cudaLaunchCooperativeKernel) with as
// many blocks as are co-resident, walkers grid-strided over all threads, and
// the grid synchronises (cooperative_groups::this_grid().sync()) after each
// half-move. The state (d + 1 floats a walker, 196 KB at W = 16384 and
// d = 2) lives in device memory, where it stays in L2; reads of state that
// other blocks wrote bypass L1 (__ldcg), which is not coherent across SMs.
//
// What bounds it on this card: two grid barriers a step (a few microseconds
// each) and, between them, one short dependent chain per walker (Philox, a
// logf, the density). With W/2 = 8192 active walkers a half-move occupies
// under 2 warps per SM, so the kernel is bound by latency and barriers, not
// by bytes (16 per walker and kept sample) or operations.
//
// Numerics: --fmad=false, no --use_fast_math. The demo density has no sum
// over observations, so the plain version evaluates it in the same order.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace amh {

constexpr int kEmceeBlock = 256;

struct EmceeShape {
  int64_t W;  // walkers
  int64_t T;  // walkers per ensemble (tile_walkers)
};

template <class Density>
__global__ void __launch_bounds__(kEmceeBlock)
    emcee_sample_kernel(float* __restrict__ x_state,
                        float* __restrict__ lp_state,
                        const float* __restrict__ consts, int n_consts,
                        float a, EmceeShape shape, uint32_t k0, uint32_t k1,
                        int64_t burn, int64_t thin, int64_t n_samples,
                        uint64_t offset, float* __restrict__ samples,
                        float* __restrict__ lps, float* __restrict__ accs) {
  constexpr int D = Density::kDim;
  extern __shared__ float sh_consts[];
  load_consts(sh_consts, consts, n_consts);
  cg::grid_group grid = cg::this_grid();
  if (!grid.is_valid()) return;  // not a cooperative launch: never wait on it
  const int64_t W = shape.W;
  const int64_t T = shape.T;
  const int64_t H = T / 2;
  const int64_t n_active = W / 2;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float a_minus_1 = a - 1.0f;
  const float dm1 = (float)(D - 1);
  const int64_t total = burn + n_samples * thin;
  for (int64_t t = 1; t <= total; ++t) {
    const uint64_t j = offset + (uint64_t)t;
    const bool emit = t > burn && (t - burn) % thin == 0;
    const int64_t e = (t - burn) / thin - 1;
    for (int h = 0; h < 2; ++h) {
      for (int64_t ai = first; ai < n_active; ai += stride) {
        const int64_t ens = ai / H;
        const int64_t w = ens * T + h * H + ai % H;
        const Words4 r = philox4x32_10((uint32_t)j, (uint32_t)w, (uint32_t)h,
                                       (uint32_t)(j >> 32), k0, k1);
        const float u_j = uniform_from_bits(r.v[0]);
        const float u_z = uniform_from_bits(r.v[1]);
        const float u_a = uniform_from_bits(r.v[2]);
        int64_t k = (int64_t)floorf(u_j * (float)H);
        k = k < H ? k : H - 1;
        const int64_t p = ens * T + (1 - h) * H + k;
        const float zz = a_minus_1 * u_z + 1.0f;
        const float z = zz * zz / a;
        float x[D], y[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          x[i] = __ldcg(x_state + i * W + w);
          const float xp = __ldcg(x_state + i * W + p);
          y[i] = xp + z * (x[i] - xp);
        }
        const float lp_x = __ldcg(lp_state + w);
        const float lp_y = Density::logp(y, sh_consts, n_consts);
        const float logalpha = dm1 * logf(z) + lp_y - lp_x;
        const bool accept = logf(u_a) <= logalpha;
        if (accept) {
#pragma unroll
          for (int i = 0; i < D; ++i) __stcg(x_state + i * W + w, y[i]);
          __stcg(lp_state + w, lp_y);
        }
        if (emit) {
#pragma unroll
          for (int i = 0; i < D; ++i) samples[(e * D + i) * W + w] = accept ? y[i] : x[i];
          lps[e * W + w] = accept ? lp_y : lp_x;
          accs[e * W + w] = accept ? 1.0f : 0.0f;
        }
      }
      grid.sync();
    }
  }
}

template <class Density>
int launch_emcee(float* x_state, float* lp_state, const float* consts,
                 int n_consts, float a, EmceeShape shape, uint64_t seed,
                 int64_t burn, int64_t thin, int64_t n_samples,
                 uint64_t offset, float* samples, float* lps, float* accs,
                 cudaStream_t stream) {
  int dev = 0, n_sm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = (size_t)n_consts * sizeof(float);
  auto* kernel = emcee_sample_kernel<Density>;
  if (err == cudaSuccess) err = allow_shared(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kEmceeBlock, smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int64_t needed = (shape.W / 2 + kEmceeBlock - 1) / kEmceeBlock;
  const int64_t resident = (int64_t)per_sm * n_sm;
  const dim3 grid((unsigned)(needed < resident ? needed : resident));
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  void* args[] = {&x_state, &lp_state, &consts, &n_consts, &a, &shape, &k0,
                  &k1, &burn, &thin, &n_samples, &offset, &samples, &lps,
                  &accs};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid,
                                    dim3(kEmceeBlock), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace amh

// ---- plain C interface (loaded with ctypes by ops/_build.py) --------------
//
// The densities the kernel is instantiated for: the one list of the pairs
// (see csrc/common.cuh).
#define AMH_EMCEE_DENSITIES(X) X(amh::EmceeDemo)

extern "C" {

// x_state (d, W) and lp_state (W) hold the start and are updated in place.
int amh_emcee_sample(const char* density, int32_t d, void* x_state,
                     void* lp_state, const void* consts, int32_t n_consts,
                     float a, int64_t W, int64_t T, uint64_t seed, int64_t burn,
                     int64_t thin, int64_t n_samples, uint64_t offset,
                     void* samples, void* lps, void* accs, void* stream) {
  const amh::EmceeShape shape{W, T};
#define X(T_)                                                                 \
  if (amh::matches<T_>(density, d))                                           \
    return amh::launch_emcee<T_>((float*)x_state, (float*)lp_state,           \
                                 (const float*)consts, n_consts, a, shape,    \
                                 seed, burn, thin, n_samples, offset,         \
                                 (float*)samples, (float*)lps, (float*)accs,  \
                                 (cudaStream_t)stream);
  AMH_EMCEE_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

const char* amh_pairs_emcee() {
  static const std::string text = [] {
    std::string s;
#define X(T_) s += amh::pair_text<T_>();
    AMH_EMCEE_DENSITIES(X)
#undef X
    return s;
  }();
  return text.c_str();
}

}  // extern "C"
