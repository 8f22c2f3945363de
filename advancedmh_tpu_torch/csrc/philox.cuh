// Philox4x32-10 counter-based generator (Salmon, Moraes, Dror & Shaw, SC'11,
// "Parallel random numbers: as easy as 1, 2, 3"), written out by hand.
//
// It replaces the TPU hardware PRNG (`pltpu.prng_random_bits`) of
// advancedmh_tpu/ops/pallas_mh.py, which has no CUDA counterpart. The words
// for a (counter, key) pair are a pure function of both, so a kernel draws
// the noise of step j of chain c without any generator state:
//   key     = the two 32-bit words of the 64-bit seed,
//   counter = (low word of j, c, sub-block, high word of j).
// `ops/rwmh.py::philox4x32_reference` gives the same bits in plain PyTorch.
#pragma once

#include <cstdint>

namespace amh {

struct Words4 {
  uint32_t v[4];
};

__device__ __forceinline__ Words4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                uint32_t c2, uint32_t c3,
                                                uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {  // key schedule: bump by the Weyl constants between rounds
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0;
    const uint32_t n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  Words4 out = {{c0, c1, c2, c3}};
  return out;
}

// 32 random bits -> float32 uniform strictly inside (0, 1): the low 23 bits
// fill the mantissa, plus half a step (≙ pallas_mh.py::_uniform_from_bits).
// Both terms and the sum are exact in float32.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return (float)(bits & 0x7FFFFFu) * 1.1920928955078125e-07f  // 2^-23
         + 5.9604644775390625e-08f;                            // 2^-24
}

}  // namespace amh
