// What every kernel of csrc/ shares: the per-step noise, the target
// densities as device functors, and the registry of compiled (density, d)
// pairs.
//
// Densities. A CUDA kernel cannot trace a PyTorch density, so each target
// the fused engine runs is a functor chosen at compile time:
//   kName          the model's `cuda_density` tag (models/targets.py),
//   kDim           the dimension it is instantiated for,
//   logp           log density of one chain's x, reading `consts` (the
//                  model's tile_consts, flattened, in shared memory),
//   value_and_grad (where a gradient kernel needs it) the same log density
//                  and its gradient in one pass.
// Each does the same algebra as its plain twin in models/targets.py, in
// float32, so that with --fmad=false the two differ only in the last ulp of
// logf and in the order of a sum over observations.
//
// Registry. Each kernel file lists the densities it instantiates in one
// X-macro; that list dispatches the C entry point (kNoKernel for a pair it
// lacks) and is exported as text by amh_pairs_<kernel>() so that Python
// reads, and never restates, which pairs exist.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>

#include "philox.cuh"

namespace amh {

constexpr float kTwoPi = 6.283185307179586f;
constexpr double kHalfLog2Pi = 0.91893853320467274178;
constexpr int kNoKernel = -1;

// Noise of absolute step j for chain c: D normals (Box-Muller pairs) and
// log(u) of one uniform. Words 2p and 2p+1 feed pair p, word 2P the uniform;
// sub-block s of the counter gives words 4s..4s+3 (ops/rwmh.py::step_noise).
template <int D>
__device__ __forceinline__ void step_noise(uint64_t j, uint32_t c, uint32_t k0,
                                           uint32_t k1, float (&z)[D],
                                           float& logu) {
  constexpr int P = (D + 1) / 2;
  constexpr int W = 2 * P + 1;
  constexpr int S = (W + 3) / 4;
  uint32_t w[4 * S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const Words4 r = philox4x32_10((uint32_t)j, c, (uint32_t)s,
                                   (uint32_t)(j >> 32), k0, k1);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[4 * s + i] = r.v[i];
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float u1 = uniform_from_bits(w[2 * p]);
    const float u2 = uniform_from_bits(w[2 * p + 1]);
    const float r = sqrtf(-2.0f * logf(u1));
    float sn, cs;
    sincosf(kTwoPi * u2, &sn, &cs);
    z[2 * p] = r * cs;
    if (2 * p + 1 < D) z[2 * p + 1] = r * sn;
  }
  logu = logf(uniform_from_bits(w[2 * P]));
}

// y = L z for a lower-triangular L (row-major D x D, zeros above the
// diagonal), by column accumulation: the plain versions' order.
template <int D>
__device__ __forceinline__ void tril_matvec(const float* L, const float (&z)[D],
                                            float (&y)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = L[i * D] * z[0];
#pragma unroll
    for (int k = 1; k < D; ++k) acc = acc + L[i * D + k] * z[k];
    y[i] = acc;
  }
}

__device__ __forceinline__ void load_consts(float* sh, const float* consts,
                                            int n_consts) {
  for (int i = threadIdx.x; i < n_consts; i += blockDim.x) sh[i] = consts[i];
  __syncthreads();
}

// The constants go to dynamic shared memory. Above the 48 KB a launch gets
// by default, the kernel must be allowed more first (up to the 227 KB of an
// H100 block; ops/_build.py refuses larger sets before any launch). Call
// before every launch of `kernel` with `bytes` of dynamic shared memory.
template <class Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// HG14 dual averaging of log step sizes on the accept indicator
// (advancedmh_tpu/ops/pallas_adapt.py; ops/hmc_adapt.py::dual_average_step
// is the plain version): t^-kappa is expf(-kappa * logf(t)).
struct DualAveraging {
  float target, t0, kappa, gamma, mu, log_eps0;
};

__device__ __forceinline__ void dual_average(const DualAveraging& k, float t,
                                             float a, float& log_eps,
                                             float& log_eps_bar, float& h_bar) {
  const float w = 1.0f / (t + k.t0);
  h_bar = (1.0f - w) * h_bar + w * (k.target - a);
  log_eps = k.mu - sqrtf(t) / k.gamma * h_bar;
  const float eta = expf(-k.kappa * logf(t));
  log_eps_bar = eta * log_eps + (1.0f - eta) * log_eps_bar;
}

// ---- densities ---------------------------------------------------------

// models/targets.py::gaussian_mean_scale_tile: x = (mu, sigma), consts = the
// n observations. One reciprocal per chain; -inf where sigma < 0.
struct GaussianMeanScale {
  static constexpr const char* kName = "gaussian_mean_scale";
  static constexpr int kDim = 2;

  __device__ static float logp(const float* x, const float* obs, int n) {
    const float mu = x[0];
    const float sigma = x[1];
    const float inv = 1.0f / fmaxf(sigma, 0.1f);
    float s = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float z = (obs[i] - mu) * inv;
      s = s + -0.5f * z * z;
    }
    const float lp = (s + (float)n * logf(inv)) - (float)((double)n * kHalfLog2Pi);
    return sigma >= 0.0f ? lp : -INFINITY;
  }

  // The gradient JAX's reverse mode gives for the tile density
  // (models/targets.py::gaussian_mean_scale_tile_value_and_grad): with
  // m = max(sigma, 0.1), inv = 1/m, r_i = obs_i - mu, z_i = r_i inv,
  //   d/dmu    = inv * sum z_i,
  //   d/dinv   = n * (1/inv) - sum z_i r_i,
  //   d/dsigma = (-d/dinv) / (m m) * w,  w = 1 (sigma > 0.1), 0.5 (= 0.1:
  //              max splits the cotangent), 0 (< 0.1);
  // both components 0 where sigma < 0 (the -inf branch carries no gradient).
  __device__ static float value_and_grad(const float* x, const float* obs,
                                         int n, float* g) {
    const float mu = x[0];
    const float sigma = x[1];
    const float m = fmaxf(sigma, 0.1f);
    const float inv = 1.0f / m;
    float s = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float r = obs[i] - mu;
      const float z = r * inv;
      s = s + -0.5f * z * z;
      s1 = s1 + z;
      s2 = s2 + z * r;
    }
    const float lp = (s + (float)n * logf(inv)) - (float)((double)n * kHalfLog2Pi);
    if (!(sigma >= 0.0f)) {
      g[0] = 0.0f;
      g[1] = 0.0f;
      return -INFINITY;
    }
    const float d_inv = (1.0f / inv) * (float)n - s2;
    const float w = sigma > 0.1f ? 1.0f : (sigma == 0.1f ? 0.5f : 0.0f);
    g[0] = inv * s1;
    g[1] = (-d_inv) / (m * m) * w;
    return lp;
  }
};

// models/targets.py::correlated_gaussian_tile: zero-mean Gaussian with
// precision P; consts = P (row-major D x D, symmetric) then the log
// normalising constant c. lp = -0.5 x'Px + c, gradient -P x.
template <int D>
struct CorrelatedGaussian {
  static constexpr const char* kName = "correlated_gaussian";
  static constexpr int kDim = D;

  __device__ static float value_and_grad(const float* x, const float* pc, int,
                                         float* g) {
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float px = pc[i * D] * x[0];
#pragma unroll
      for (int j = 1; j < D; ++j) px = px + pc[i * D + j] * x[j];
      q = i == 0 ? x[0] * px : q + x[i] * px;
      g[i] = -px;
    }
    return -0.5f * q + pc[D * D];
  }

  __device__ static float logp(const float* x, const float* pc, int n) {
    float g[D];
    return value_and_grad(x, pc, n, g);
  }
};

// models/targets.py::logistic_regression_tile: Bayesian logistic regression
// with D coefficients b; consts = X (n x D, row-major), y (n), then
// inv_var = 1/prior_scale^2, so n = (n_consts - 1) / (D + 1). Per
// observation z = X_i . b (coordinates in order), the term
// y z - softplus(z) with softplus(z) = max(z, 0) + log1p(exp(-|z|)), and for
// the gradient r = y - softplus'(z) with softplus' as JAX's reverse mode
// gives it: h - s e/(1 + e), e = exp(-|z|), h = 1, 1/2, 0 for z >, =, < 0,
// s = +1 for z >= 0 and -1 below (0 at z = 0). The log-likelihood terms go
// into 8 interleaved partial sums (observation i into partial i mod 8, then
// the partials in order), which the compiler can overlap; the gradient
// g_j = sum_i X_ij r_i - inv_var b_j accumulates over i in order. One
// thread holds b, g and the 8 partials; X and y are read from shared memory
// at the same address by every thread of a warp (a broadcast).
template <int D>
struct LogisticRegression {
  static constexpr const char* kName = "logistic_regression";
  static constexpr int kDim = D;
  static constexpr int kPartials = 8;

  template <bool kGrad>
  __device__ __forceinline__ static float eval(const float* b, const float* c,
                                               int n_consts, float* g) {
    const int n = (n_consts - 1) / (D + 1);
    const float* X = c;
    const float* y = c + n * D;
    const float inv_var = c[n * (D + 1)];
    float part[kPartials];
#pragma unroll
    for (int m = 0; m < kPartials; ++m) part[m] = 0.0f;
    if (kGrad) {
#pragma unroll
      for (int j = 0; j < D; ++j) g[j] = 0.0f;
    }
    for (int i0 = 0; i0 < n; i0 += kPartials) {
#pragma unroll
      for (int m = 0; m < kPartials; ++m) {
        const int i = i0 + m;
        if (i < n) {
          const float* xi = X + i * D;
          float z = xi[0] * b[0];
#pragma unroll
          for (int j = 1; j < D; ++j) z = z + xi[j] * b[j];
          const float e = expf(-fabsf(z));
          part[m] = part[m] + (y[i] * z - (fmaxf(z, 0.0f) + log1pf(e)));
          if (kGrad) {
            const float h = z > 0.0f ? 1.0f : (z == 0.0f ? 0.5f : 0.0f);
            const float s = z >= 0.0f ? 1.0f : -1.0f;
            const float r = y[i] - (h - s * (e / (1.0f + e)));
#pragma unroll
            for (int j = 0; j < D; ++j) g[j] = g[j] + xi[j] * r;
          }
        }
      }
    }
    float ll = part[0];
#pragma unroll
    for (int m = 1; m < kPartials; ++m) ll = ll + part[m];
    float bb = b[0] * b[0];
#pragma unroll
    for (int j = 1; j < D; ++j) bb = bb + b[j] * b[j];
    if (kGrad) {
#pragma unroll
      for (int j = 0; j < D; ++j) g[j] = g[j] - b[j] * inv_var;
    }
    return ll - (0.5f * inv_var) * bb;
  }

  __device__ static float logp(const float* b, const float* c, int n_consts) {
    return eval<false>(b, c, n_consts, nullptr);
  }

  __device__ static float value_and_grad(const float* b, const float* c,
                                         int n_consts, float* g) {
    return eval<true>(b, c, n_consts, g);
  }
};

// models/targets.py::neal_funnel_tile_value_and_grad: Neal's funnel in D
// dimensions, x = (v, x_1..x_{D-1}), no constants:
//   lp = ((-v) v)/18 - (D-1)/2 v - (e/2) S + c,  e = exp(-v), S = sum x_i^2
// (S summed in order), c = -D log(2 pi)/2 - log 3 in float64; the gradient as
// JAX's reverse mode gives the tile density: with a = (-v)(1/18),
// d/dv = (a + a - (D-1)/2) + (S/2) e and d/dx_i = (-e/2) x_i + (-e/2) x_i.
// For v < -88 e overflows to inf and inf * 0 is NaN, as in JAX.
template <int D>
struct NealFunnel {
  static constexpr const char* kName = "neal_funnel";
  static constexpr int kDim = D;

  template <bool kGrad>
  __device__ __forceinline__ static float eval(const float* x, float* g) {
    constexpr float kHalfDm1 = 0.5f * (float)(D - 1);
    constexpr float kConst =
        (float)(-(double)D * 0.91893853320467274178 - 1.0986122886681098);
    const float v = x[0];
    float sq = x[1] * x[1];
#pragma unroll
    for (int i = 2; i < D; ++i) sq = sq + x[i] * x[i];
    const float e = expf(-v);
    const float he = 0.5f * e;
    const float lp = ((-v) * v / 18.0f - kHalfDm1 * v) - he * sq + kConst;
    if (kGrad) {
      const float a = (-v) * (1.0f / 18.0f);
      g[0] = (a + a - kHalfDm1) + (0.5f * sq) * e;
#pragma unroll
      for (int i = 1; i < D; ++i) {
        const float t = (-he) * x[i];
        g[i] = t + t;
      }
    }
    return lp;
  }

  __device__ static float logp(const float* x, const float*, int) {
    return eval<false>(x, nullptr);
  }

  __device__ static float value_and_grad(const float* x, const float*, int,
                                         float* g) {
    return eval<true>(x, g);
  }
};

// models/targets.py::emcee_demo_tile: x = (s, m); s ~ InverseGamma(2, 3),
// m ~ N(0, sqrt s), observations 1.5 and 2.0 from N(m, sqrt s). Out of the
// support (s <= 0) the value is -1e30, not -inf, as in the JAX model.
struct EmceeDemo {
  static constexpr const char* kName = "emcee_demo";
  static constexpr int kDim = 2;

  __device__ static float logp(const float* x, const float*, int) {
    const float s = x[0];
    const float m = x[1];
    const float safe = fmaxf(s, 1e-6f);
    const float log_s = logf(safe);
    const float inv_s = 1.0f / safe;
    const float a = 1.5f - m;
    const float b = 2.0f - m;
    const float quad = m * m + a * a + b * b;
    const float lp = (float)(2.0 * 1.0986122886681098) - 3.0f * log_s -
                     3.0f * inv_s - 1.5f * log_s -
                     (float)(3.0 * kHalfLog2Pi) - 0.5f * quad * inv_s;
    return s > 0.0f ? lp : -1e30f;
  }
};

// ---- registry -----------------------------------------------------------

template <class T>
inline bool matches(const char* name, int d) {
  return name != nullptr && d == T::kDim && std::strcmp(name, T::kName) == 0;
}

template <class T>
inline std::string pair_text() {
  return std::string(T::kName) + ":" + std::to_string(T::kDim) + " ";
}

}  // namespace amh
