// In-bucket scatter-add shared by mttkrp.cu and cg_matvec.cu.
//
// Replaces src/repro/kernels/tile.py:scatter_rows, the reference's in-kernel
// primitive (one-hot MXU product or segmented cumsum over a monotone key).
//
// A CTA owns one bucket's (block_rows, R) output rows and accumulates them in
// shared memory; no other CTA writes those rows, so no global atomics are
// needed. Each lane holds one bucket slot with key = local_row for a valid
// slot and key = block_rows (matches no output row) otherwise, the
// reference's key where(valid, local_row, block_rows): padding slots carry
// local_row 0, so keying on local_row alone would scatter them into row 0.
//
// Bucket slots are sorted by row, so a warp's 32 slots nearly always share
// one key. Such a warp sums its 32 values with shuffles and one lane adds the
// sum: one shared-memory atomic per warp and column. A warp that straddles a
// row boundary falls back to one shared atomic per lane. The atomics make the
// order of the sum, and so its last bits, vary from run to run.
//
// Every lane of the warp must call these together (the loop over the
// capacity axis is uniform across the CTA and blockDim.x is a multiple of 32).
#pragma once

#include "common.cuh"

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ void scatter_rows_zero(float* acc, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
}

__device__ __forceinline__ bool scatter_rows_uniform(int key) {
  return __all_sync(FULL_MASK, key == __shfl_sync(FULL_MASK, key, 0));
}

// acc[key, r] += v over the warp's lanes (`uniform` from scatter_rows_uniform)
__device__ __forceinline__ void scatter_rows_add(float* acc, int key,
                                                 int block_rows, int R, int r,
                                                 float v, bool uniform) {
  if (uniform) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(FULL_MASK, v, off);
    }
    if ((threadIdx.x & 31) == 0 && key < block_rows) {
      atomicAdd(&acc[key * R + r], v);
    }
  } else if (key < block_rows) {
    atomicAdd(&acc[key * R + r], v);
  }
}

// Copy the bucket's rows to out rows [b*block_rows, (b+1)*block_rows).
__device__ __forceinline__ void scatter_rows_store(const float* acc,
                                                   float* __restrict__ out,
                                                   long long b,
                                                   int block_rows, int R) {
  __syncthreads();
  const int n = block_rows * R;
  float* dst = out + b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = acc[i];
}
