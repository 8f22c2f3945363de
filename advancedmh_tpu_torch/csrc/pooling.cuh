// Deterministic cross-chain sums for the ChEES warmup kernel
// (csrc/chees.cu), which pools statistics over a tile of chains on every
// step. The plain version is ops/pooling.py. (csrc/meads.cu runs a tile in
// one thread-block cluster instead.)
//
// A tile spans several blocks of kPoolBlock threads, so a sum over it needs
// the whole grid: the kernels are launched cooperatively (all blocks
// co-resident, launch_cooperative below) and wait at grid.sync(). A sum of a
// per-thread value is taken in a fixed order, never with float atomics,
// whose order changes from run to run:
//   1. in each block, a halving tree over its threads in shared memory
//      (block_tree);
//   2. each block stores its partial at its own index in device memory;
//   3. after the grid barrier every block of the tile adds the tile's
//      partials in block order (tile_totals), so every block holds the same
//      totals and computes the same tile statistics from them.
// Threads past the end of a tile add 0. Partials that other blocks wrote are
// read with __ldcg (L2, not the incoherent L1).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace amh {

constexpr int kPoolBlock = 64;

// Floats of dynamic shared memory before the kernel's own scratch: the
// density constants, rounded up to 16 bytes.
__host__ __device__ inline int consts_floats(int n_consts) {
  return (n_consts + 3) & ~3;
}

// The Q values of each thread lie at sh[q * kPoolBlock + thread]. After the
// call sh[q * kPoolBlock] holds the block's sum of value q: at each level
// thread i < s adds i + s, s = 32, 16, .., 1 (ops/pooling.py::tree_sum).
__device__ __forceinline__ void block_tree(float* sh, int Q) {
  __syncthreads();
  for (int s = kPoolBlock / 2; s > 0; s >>= 1) {
    for (int it = threadIdx.x; it < Q * s; it += kPoolBlock) {
      const int q = it / s;
      const int i = it - q * s;
      sh[q * kPoolBlock + i] = sh[q * kPoolBlock + i] + sh[q * kPoolBlock + i + s];
    }
    __syncthreads();
  }
}

// The block's Q sums to partials[q * nb + block], then a block barrier (the
// caller may reuse sh).
__device__ __forceinline__ void store_partials(const float* sh, int Q,
                                               float* partials, int64_t nb) {
  for (int q = threadIdx.x; q < Q; q += kPoolBlock)
    __stcg(partials + q * nb + blockIdx.x, sh[q * kPoolBlock]);
  __syncthreads();
}

// out[q] = the tile's partials of value q, blocks first..first+count-1 added
// in order; then a block barrier.
__device__ __forceinline__ void tile_totals(const float* partials, int Q,
                                            int64_t nb, int64_t first,
                                            int64_t count, float* out) {
  for (int q = threadIdx.x; q < Q; q += kPoolBlock) {
    const float* row = partials + q * nb + first;
    float acc = __ldcg(row);
    for (int64_t b = 1; b < count; ++b) acc = acc + __ldcg(row + b);
    out[q] = acc;
  }
  __syncthreads();
}

// The tile of a block. Tiles hold `tile_items` threads' items (chains, or
// fold positions), the last one `last_items` if that is not 0; each takes
// ceil(items / kPoolBlock) blocks of its own, in tile order.
struct PoolTile {
  int64_t tile;         // index of the tile
  int64_t first_block;  // its first block
  int64_t n_blocks;     // its blocks
  int64_t n_items;      // its items
  int64_t item;         // this thread's item in the tile (valid if < n_items)
};

__device__ __forceinline__ PoolTile pool_tile(int64_t n_full, int64_t tile_items,
                                              int64_t last_items) {
  const int64_t bpt = (tile_items + kPoolBlock - 1) / kPoolBlock;
  PoolTile t;
  t.tile = (int64_t)blockIdx.x / bpt;
  if (t.tile < n_full) {
    t.first_block = t.tile * bpt;
    t.n_blocks = bpt;
    t.n_items = tile_items;
  } else {
    t.tile = n_full;
    t.first_block = n_full * bpt;
    t.n_blocks = (last_items + kPoolBlock - 1) / kPoolBlock;
    t.n_items = last_items;
  }
  t.item = ((int64_t)blockIdx.x - t.first_block) * kPoolBlock + threadIdx.x;
  return t;
}

__host__ __device__ inline int64_t pool_blocks(int64_t n_full, int64_t tile_items,
                                               int64_t last_items) {
  return n_full * ((tile_items + kPoolBlock - 1) / kPoolBlock) +
         (last_items + kPoolBlock - 1) / kPoolBlock;
}

// Launch `kernel` cooperatively with n_blocks of kPoolBlock threads and
// `smem` bytes of dynamic shared memory. A grid that cannot be co-resident
// is an error (cudaErrorCooperativeLaunchTooLarge), never a silent
// fallback.
template <class Kernel>
int launch_cooperative(Kernel kernel, int64_t n_blocks, size_t smem, void** args,
                       cudaStream_t stream) {
  int dev = 0, coop = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_shared(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPoolBlock,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  if (!coop || n_blocks < 1 || n_blocks > (int64_t)per_sm * n_sm)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)n_blocks),
                                    dim3(kPoolBlock), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace amh
