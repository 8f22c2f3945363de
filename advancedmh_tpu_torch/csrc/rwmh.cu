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
// lp (1, C), emitted samples (N, d, C), lps and accepted (N, 1, C). The last
// block is masked, so any C works without padding. Two forms of a chain,
// chosen at compile time by the density and at the launch by its number of
// constants (in_form below, the one place that rule lives):
//
// One thread a chain (every density but the flagship, and the flagship with
// more observations than its lanes' registers hold): the state in
// registers, the density's constants in shared memory, neighbouring threads
// on neighbouring chains. Each step is one serial chain of dependent work --
// ten Philox rounds, Box-Muller's logf, sqrtf and sincosf, the density, the
// accept test's logf -- and 16384 chains are 512 warps, under 4 an SM: too
// few to hide it. The flagship took ~1300 cycles a step this way (H100,
// 16384 x 40490 steps in 30.6 ms, 5.9% of its operation bound).
//
// A group of RwmhGroup<Density>::kLanes lanes a chain (the flagship,
// GaussianMeanScale, up to 32 observations), which removes the three
// losses of that form:
//   - the density over lanes: lane l holds observations l, l + kLanes, ..
//     in registers, loaded once a launch, and sums their terms as partial
//     l; the partials combine in a fixed butterfly, so every lane holds the
//     same lp;
//   - the noise off the serial path: the noise of step j depends only on
//     (seed, j, chain), so lane l draws all of step base + l's (its Philox
//     block, Box-Muller pair and logf(u), step_noise's words), while the
//     group runs the kLanes steps before them; step base + t then takes its
//     normals and log u from lane t by __shfl_sync;
//   - more warps: kLanes times as many threads hide each step's latency.
// Every lane of a group holds the same state and takes the same decisions;
// the draws are written with one store a lane and row (lane r writes rows
// r, r + kLanes, .. of x, lp, accepted), so a warp writes 32 / kLanes
// consecutive chains of each row at once. The block is 128 threads
// (csrc/hmc_group.cuh::launch_group with RwmhShape).
//
// What bounds it now: the schedulers' instruction rate. With 2 lanes a
// chain (two warps a scheduler at 16384 chains) a step is ~340 instructions
// a warp (cuobjdump), mostly the density's 16 observation slots a lane, the
// noise and the accurate logf and division each lane repeats. Measured at
// 16384 chains (tools/kernel_ab.py, H100 80GB HBM3, 700 W): 14.91 ms for
// 40490 steps thinned by 10 (30.58 ms one thread a chain, 12% of the
// operation bound), 2.22 ms for 4499 steps all emitted (4.54 ms); with a
// lower-triangular scale 17.27 ms thinned (28.87 ms one thread). 2 lanes
// beat 4 (16.86 ms), 8 (23.57 ms), one thread a chain with the observations
// in registers and the next step's noise drawn during this one (28.3 ms),
// and groups of L chains on L lanes that share the density's lanes
// (22.7-27.3 ms); staging the draws through shared memory was slower too
// (15.39 against 14.38 ms); PERF.md §6 row 1. A __shfl_sync with the
// group's own lane mask cost a convergence check of some 40 instructions at
// every exchange (17.13 against 22.17 ms at 4 lanes), so every lane of a
// warp runs to the end and the shuffles take the whole warp.
//
// Numerics: build with --fmad=false and without --use_fast_math, so each
// multiply and add rounds as in the plain version and the transcendental
// functions are the accurate ones. What differs from PyTorch is then only the
// last ulp of logf / sincosf and, in the group form, the order of the
// observation sum (the plain tile density adds in order, as the one-thread
// form does), which leaves lp a few bits off the plain version's and,
// rarely, flips an accept test that lands on its threshold (ops/_build.py
// has the measured rates).

#include <type_traits>

#include "hmc_group.cuh"

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

// ---- a chain on a group of lanes -----------------------------------------

constexpr unsigned kWarp = 0xffffffffu;  // the group form's shuffles take the whole warp

// A density's group form in the RWMH kernels: kLanes = 0 for none (one
// thread a chain).
template <class Density>
struct RwmhGroup {
  static constexpr int kLanes = 0;
};

// The flagship (GaussianMeanScale: x = (mu, sigma), consts = the n
// observations) on kLanes lanes a chain. Lane l holds observations i = l +
// kLanes k (k < kK) in registers and sums their terms (w_k z_i) z_i, z_i =
// (obs_i - mu) inv, in order of k from 0 as partial l, with w_k = -0.5 for
// an observation and 0 past the last (a slot held as 0, whose term +-0
// changes no partial: each starts at +0 and adds terms <= 0); the partials
// combine by a butterfly (xor 1, 2, ..), so every lane holds p0 + p1 at
// kLanes = 2 and ((p0 + p1) + (p2 + p3)) at 4. The rest is
// GaussianMeanScale::logp's algebra: inv = 1 / max(sigma, 0.1), (sum + n log
// inv) - n log(2 pi)/2, -inf where sigma < 0. That functor, which sums in
// order, stays the density of every other kernel and of the front end's
// initial lp.
template <>
struct RwmhGroup<GaussianMeanScale> {
  static constexpr int kLanes = 2;
  static constexpr int kMaxObs = 32;  // observations the lanes' registers hold
  static constexpr int kK = kMaxObs / kLanes;
  float obs[kK], w[kK];
  float nf, norm;

  __device__ __forceinline__ RwmhGroup(const float* consts, int n, int lane)
      : nf((float)n), norm((float)((double)n * kHalfLog2Pi)) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const int i = lane + kLanes * k;
      obs[k] = i < n ? consts[i] : 0.0f;
      w[k] = i < n ? -0.5f : 0.0f;
      asm("" : "+f"(w[k]));  // kept in a register: the compiler would redo i < n every step
    }
  }

  __device__ __forceinline__ float logp(const float (&x)[2]) const {
    const float mu = x[0];
    const float sigma = x[1];
    const float inv = 1.0f / fmaxf(sigma, 0.1f);
    float part = 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float z = (obs[k] - mu) * inv;
      part = part + w[k] * z * z;
    }
#pragma unroll
    for (int m = 1; m < kLanes; m <<= 1)
      part = part + __shfl_xor_sync(kWarp, part, m, kLanes);
    const float lp = (part + nf * logf(inv)) - norm;
    return sigma >= 0.0f ? lp : -INFINITY;
  }
};

// The block of the group form: 128 threads, 128 / kLanes chains; no shared
// memory (the observations sit in registers). Every lane of a warp that
// holds a chain runs to the end (the lanes past the batch on a copy of its
// last chain, writing nothing), so that each exchange takes the whole warp
// as a compile-time mask: a partial one costs a convergence check of some
// 40 instructions at every shuffle.
template <class Density>
struct RwmhShape {
  static constexpr int kLanes = RwmhGroup<Density>::kLanes;
  static constexpr int kThreads = 128;
  static constexpr int kChains = kThreads / kLanes;

  __host__ __device__ static int smem_floats(int) { return 0; }
};

// One step of a group: step base + t's normals and log u from lane t
// (which drew them ahead), then mh_step's proposal and accept test. The
// state and the decision are the same in every lane.
template <class Density, bool kTril>
__device__ __forceinline__ bool group_step(const RwmhGroup<Density>& g,
                                           float (&x)[Density::kDim], float& lp,
                                           const float* scale,
                                           const float (&z_lane)[Density::kDim],
                                           float logu_lane, int t) {
  constexpr int D = Density::kDim;
  constexpr int L = RwmhGroup<Density>::kLanes;
  float z[D];
#pragma unroll
  for (int i = 0; i < D; ++i) z[i] = __shfl_sync(kWarp, z_lane[i], t, L);
  const float logu = __shfl_sync(kWarp, logu_lane, t, L);
  float cand[D];
  if (kTril) {
    tril_matvec<D>(scale, z, cand);
#pragma unroll
    for (int i = 0; i < D; ++i) cand[i] = x[i] + cand[i];
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) cand[i] = x[i] + scale[i] * z[i];
  }
  const float lp_cand = g.logp(cand);
  const bool accept = logu < lp_cand - lp;
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = accept ? cand[i] : x[i];
  lp = accept ? lp_cand : lp;
  return accept;
}

// Runs `total` steps of a group from absolute step offset + 1, calling
// done(accepted) after each (the same in every lane). The noise of the next
// kLanes steps is drawn while the group runs the current ones: lane l draws
// step base + l.
template <class Density, bool kTril, class Done>
__device__ __forceinline__ void group_run(const RwmhGroup<Density>& g,
                                          float (&x)[Density::kDim], float& lp,
                                          const float* scale, int64_t total, uint64_t offset,
                                          uint32_t c, uint32_t k0, uint32_t k1, int lane,
                                          Done done) {
  constexpr int D = Density::kDim;
  constexpr int L = RwmhGroup<Density>::kLanes;
  float z[D], logu;
  step_noise<D>(offset + 1 + lane, c, k0, k1, z, logu);
  int64_t s = 0;
  for (; s + L <= total; s += L) {
    float z_next[D], logu_next;
    step_noise<D>(offset + s + L + 1 + lane, c, k0, k1, z_next, logu_next);
#pragma unroll
    for (int t = 0; t < L; ++t)
      done(group_step<Density, kTril>(g, x, lp, scale, z, logu, t));
#pragma unroll
    for (int i = 0; i < D; ++i) z[i] = z_next[i];
    logu = logu_next;
  }
#pragma unroll
  for (int t = 0; t < L - 1; ++t)
    if (s + t < total) done(group_step<Density, kTril>(g, x, lp, scale, z, logu, t));
}

// A lane's group: its lane, its chain c (the batch's last chain for a group
// past the end) and whether c is its own. A warp wholly past the end
// returns (every lane at once).
struct GroupLane {
  int lane;
  int64_t c;
  bool live;
};

template <class Density>
__device__ __forceinline__ bool group_lane(int64_t C, GroupLane& gl) {
  using S = RwmhShape<Density>;
  const int64_t first = (int64_t)blockIdx.x * S::kChains;
  if (first + (int64_t)(threadIdx.x / 32) * (32 / S::kLanes) >= C) return false;
  const int64_t c = first + threadIdx.x / S::kLanes;
  gl = GroupLane{(int)(threadIdx.x % S::kLanes), c < C ? c : C - 1, c < C};
  return true;
}

// Row r of a chain's column (x_0 .. x_{D-1}, lp, v), r known at compile time.
template <int D>
__device__ __forceinline__ float column_row(int r, const float (&x)[D], float lp, float v) {
  return r < D ? x[r < D ? r : 0] : (r == D ? lp : v);
}

// The rows of a chain's column that a lane writes, row r = lane + L j:
// each row's next address and its stride between emitted samples, computed
// once, so that a write picks its value among registers by the lane (a
// runtime index would put x in local memory) and moves its pointer on.
template <int D, int L>
struct LaneRows {
  static constexpr int kRows = (D + 2 + L - 1) / L;
  float* ptr[kRows];
  int64_t stride[kRows];
  bool on[kRows];  // row lane + L j exists and the lane's chain is its own
  int lane;

  __device__ __forceinline__ LaneRows(float* out_x, float* out_lp, float* out_v,
                                      int64_t sample_stride, const GroupLane& gl, int64_t C)
      : lane(gl.lane) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = gl.lane + L * j;
      on[j] = gl.live && r < D + 2;
      ptr[j] = r < D ? out_x + r * C + gl.c : (r == D ? out_lp : out_v) + gl.c;
      stride[j] = r < D ? sample_stride * D : sample_stride;
    }
  }

  __device__ __forceinline__ void write(const float (&x)[D], float lp, float v) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      float val = column_row<D>(L * j, x, lp, v);
#pragma unroll
      for (int q = 1; q < L; ++q)
        if (L * j + q < D + 2) val = lane == q ? column_row<D>(L * j + q, x, lp, v) : val;
      if (on[j]) *ptr[j] = val;
      ptr[j] += stride[j];
    }
  }
};

// ---- kernel A: burn-in + thinned emission --------------------------------

// Sample e is the state after burn + (e+1)*thin steps; step t of the launch
// is absolute iteration offset + t (t = 1, 2, ...). kGroup: the group form.
template <class Density, bool kTril, bool kGroup>
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
  if constexpr (kGroup) {
    constexpr int L = RwmhGroup<Density>::kLanes;
    GroupLane gl;
    if (!group_lane<Density>(C, gl)) return;
    const RwmhGroup<Density> g(consts, n_consts, gl.lane);
    ChainState<Density, kTril> st;
    load_state(st, params_t, lp_in, scale, gl.c, C);
    LaneRows<D, L> rows(samples, lps, accs, C, gl, C);
    int64_t left = burn + thin;  // steps until the next sample is taken
    group_run<Density, kTril>(
        g, st.x, st.lp, st.scale, burn + n_samples * thin, offset, (uint32_t)gl.c, k0, k1,
        gl.lane, [&](bool accepted) {
          const bool take = --left == 0;
          if (take) rows.write(st.x, st.lp, accepted ? 1.0f : 0.0f);
          left = take ? thin : left;
        });
  } else {
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
}

// ---- kernel B: n_steps with no emission (any n_steps, odd included) -------

template <class Density, bool kTril, bool kGroup>
__global__ void __launch_bounds__(kBlock)
    rwmh_kernel(const float* __restrict__ params_t,
                const float* __restrict__ lp_in,
                const float* __restrict__ scale,
                const float* __restrict__ consts, int n_consts, uint32_t k0,
                uint32_t k1, int64_t n_steps, uint64_t offset, int64_t C,
                float* __restrict__ out_params, float* __restrict__ out_lp,
                float* __restrict__ out_acc) {
  constexpr int D = Density::kDim;
  if constexpr (kGroup) {
    constexpr int L = RwmhGroup<Density>::kLanes;
    GroupLane gl;
    if (!group_lane<Density>(C, gl)) return;
    const RwmhGroup<Density> g(consts, n_consts, gl.lane);
    ChainState<Density, kTril> st;
    load_state(st, params_t, lp_in, scale, gl.c, C);
    float count = 0.0f;
    group_run<Density, kTril>(g, st.x, st.lp, st.scale, n_steps, offset, (uint32_t)gl.c, k0,
                              k1, gl.lane, [&](bool accepted) { count += accepted ? 1.0f : 0.0f; });
    LaneRows<D, L>(out_params, out_lp, out_acc, 0, gl, C).write(st.x, st.lp, count);
  } else {
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
}

// ---- host-side launch ------------------------------------------------------

inline dim3 grid_for(int64_t C) { return dim3((unsigned)((C + kBlock - 1) / kBlock)); }

// The one rule that picks a launch's form: f(std::true_type{}) where the
// density has a group form and its n_consts observations fit the lanes'
// registers, else f(std::false_type{}), one thread a chain. Both launches and
// amh_rwmh_info go through it.
template <class Density, class F>
int in_form(int n_consts, F f) {
  if constexpr (RwmhGroup<Density>::kLanes > 0)
    if (n_consts <= RwmhGroup<Density>::kMaxObs) return f(std::true_type{});
  return f(std::false_type{});
}

// Launches `kernel` in its form: RwmhShape's blocks
// (csrc/hmc_group.cuh::launch_group), or one thread a chain with the
// constants in shared memory; *lanes = the lanes a chain it launched.
template <class Density, bool kGroup, class Kernel, class... Args>
int launch_form(Kernel kernel, int n_consts, int64_t C, cudaStream_t stream, int32_t* lanes,
                Args... args) {
  if constexpr (kGroup) {
    *lanes = RwmhGroup<Density>::kLanes;
    return launch_group<Density, RwmhShape<Density>>(kernel, n_consts, C, stream, args...);
  } else {
    *lanes = 1;
    const size_t smem = n_consts * sizeof(float);
    const cudaError_t err = allow_shared(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid_for(C), kBlock, smem, stream>>>(args...);
    return (int)cudaGetLastError();
  }
}

template <class Density, bool kTril>
int launch_sample(const float* params_t, const float* lp, const float* scale,
                  const float* consts, int n_consts, uint64_t seed,
                  int64_t burn, int64_t thin, int64_t n_samples,
                  uint64_t offset, int64_t C, float* samples, float* lps,
                  float* accs, int32_t* lanes, cudaStream_t stream) {
  return in_form<Density>(n_consts, [&](auto group) {
    constexpr bool kGroup = decltype(group)::value;
    return launch_form<Density, kGroup>(
        rwmh_sample_kernel<Density, kTril, kGroup>, n_consts, C, stream, lanes, params_t, lp,
        scale, consts, n_consts, (uint32_t)seed, (uint32_t)(seed >> 32), burn, thin,
        n_samples, offset, C, samples, lps, accs);
  });
}

template <class Density, bool kTril>
int launch_steps(const float* params_t, const float* lp, const float* scale,
                 const float* consts, int n_consts, uint64_t seed,
                 int64_t n_steps, uint64_t offset, int64_t C,
                 float* out_params, float* out_lp, float* out_acc,
                 int32_t* lanes, cudaStream_t stream) {
  return in_form<Density>(n_consts, [&](auto group) {
    constexpr bool kGroup = decltype(group)::value;
    return launch_form<Density, kGroup>(
        rwmh_kernel<Density, kTril, kGroup>, n_consts, C, stream, lanes, params_t, lp, scale,
        consts, n_consts, (uint32_t)seed, (uint32_t)(seed >> 32), n_steps, offset, C,
        out_params, out_lp, out_acc);
  });
}

// The sampling kernel's launch shape for C chains, in the form it takes:
// out[0..5] as csrc/hmc_group.cuh::launch_info (chains a block, lanes a
// chain, ..), out[6] its registers a thread.
template <class Density, bool kTril>
int sample_launch_info(int n_consts, int64_t C, int64_t* out) {
  return in_form<Density>(n_consts, [&](auto group) {
    constexpr bool kGroup = decltype(group)::value;
    const auto kernel = rwmh_sample_kernel<Density, kTril, kGroup>;
    int err;
    if constexpr (kGroup)
      err = group_launch_info<Density, RwmhShape<Density>>(kernel, n_consts, C, out);
    else
      err = launch_info(kernel, kBlock, 1, n_consts * sizeof(float), C, out);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = (int)cudaFuncGetAttributes(&attr, kernel);
    out[6] = err == cudaSuccess ? attr.numRegs : 0;
    return err;
  });
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
                    void* accs, int32_t* lanes, void* stream) {
#define X(T)                                                                \
  if (amh::matches<T>(density, d))                                          \
    return (tril ? amh::launch_sample<T, true> : amh::launch_sample<T, false>)( \
        (const float*)params_t, (const float*)lp, (const float*)scale,      \
        (const float*)consts, n_consts, seed, burn, thin, n_samples, offset, \
        C, (float*)samples, (float*)lps, (float*)accs, lanes, (cudaStream_t)stream);
  AMH_RWMH_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

int amh_rwmh(const char* density, int32_t d, int32_t tril, const void* params_t,
             const void* lp, const void* scale, const void* consts,
             int32_t n_consts, uint64_t seed, int64_t n_steps, uint64_t offset,
             int64_t C, void* out_params, void* out_lp, void* out_acc,
             int32_t* lanes, void* stream) {
#define X(T)                                                                \
  if (amh::matches<T>(density, d))                                          \
    return (tril ? amh::launch_steps<T, true> : amh::launch_steps<T, false>)( \
        (const float*)params_t, (const float*)lp, (const float*)scale,      \
        (const float*)consts, n_consts, seed, n_steps, offset, C,           \
        (float*)out_params, (float*)out_lp, (float*)out_acc, lanes,         \
        (cudaStream_t)stream);
  AMH_RWMH_DENSITIES(X)
#undef X
  return amh::kNoKernel;
}

// The sampling kernel's launch shape and registers for C chains (out: 7
// int64; rwmh_kernel launches the same shape).
int amh_rwmh_info(const char* density, int32_t d, int32_t tril, int32_t n_consts, int64_t C,
                  int64_t* out) {
#define X(T)                                                                        \
  if (amh::matches<T>(density, d))                                                  \
    return (tril ? amh::sample_launch_info<T, true> : amh::sample_launch_info<T, false>)( \
        n_consts, C, out);
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
