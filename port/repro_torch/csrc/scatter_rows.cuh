// In-bucket scatter-add of the bucketed kernels (bucket_rows.cuh).
//
// Replaces src/repro/kernels/tile.py:scatter_rows, the reference's in-kernel
// primitive (one-hot MXU product or segmented cumsum over a monotone key).
//
// A CTA owns one bucket's block_rows output rows and accumulates them in
// shared memory (row stride RS floats); no other CTA writes those rows, so
// no global atomics are needed. The key of a slot is local_row for a valid
// slot and block_rows (matches no output row) otherwise, the reference's
// where(valid, local_row, block_rows): padding slots carry local_row 0, so
// keying on local_row alone would scatter them into row 0.
//
// Running sums: each thread keeps the sum of its own slots' contributions in
// registers (RowSum::acc) together with the row they belong to (RowSum::row)
// and adds it to the shared row only when its key changes, and once at the
// end. A bucket's slots are sorted by row and a thread walks them in slot
// order, so it flushes at most block_rows + 1 times per bucket however many
// slots it takes. Keys in any other order give the same sums, with more
// flushes. A flush is warp-wide: when every flushing lane of the warp flushes
// the same row (a row boundary inside the warp's slots, or the end of the
// bucket), the warp sums each column with shuffles and one lane adds it;
// otherwise each flushing lane adds its own. The shared-memory atomics make
// the order of the sum, and so its last bits, vary from run to run.
//
// Every lane of the warp must call RowSum::visit and RowSum::finish together
// (the capacity loop is uniform across the CTA and blockDim.x is a multiple
// of 32).
#pragma once

#include "common.cuh"

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 fma4(float s, float4 a, float4 acc) {
  return make_float4(fmaf(s, a.x, acc.x), fmaf(s, a.y, acc.y),
                     fmaf(s, a.z, acc.z), fmaf(s, a.w, acc.w));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(FULL_MASK, v, off);
  }
  return v;
}

// One thread's running sum over the (rows, RS) shared accumulator `ys`; the
// first nq = RS / 4 of its QMAX float4s are live.
template <int QMAX>
struct RowSum {
  float4 acc[QMAX];
  int row;  // the row acc belongs to, or block_rows before the first slot

  __device__ __forceinline__ void reset(int block_rows) {
    row = block_rows;
#pragma unroll
    for (int q = 0; q < QMAX; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Add acc to shared row `row` in the lanes where `on` holds.
  __device__ __forceinline__ void flush(bool on, float* ys, int RS, int nq) {
    const unsigned m = __ballot_sync(FULL_MASK, on);
    if (m == 0) return;
    const int lead = __ffs(m) - 1;
    const int r0 = __shfl_sync(FULL_MASK, row, lead);
    if (__all_sync(FULL_MASK, !on || row == r0)) {
      const bool lane_lead = (threadIdx.x & 31) == lead;
      float* dst = ys + r0 * RS;
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if (q < nq) {
          const float4 a = on ? acc[q] : make_float4(0.f, 0.f, 0.f, 0.f);
          const float sx = warp_sum(a.x), sy = warp_sum(a.y);
          const float sz = warp_sum(a.z), sw = warp_sum(a.w);
          if (lane_lead) {
            atomicAdd(dst + 4 * q, sx);
            atomicAdd(dst + 4 * q + 1, sy);
            atomicAdd(dst + 4 * q + 2, sz);
            atomicAdd(dst + 4 * q + 3, sw);
          }
        }
      }
    } else if (on) {
      float* dst = ys + row * RS;
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if (q < nq) {
          atomicAdd(dst + 4 * q, acc[q].x);
          atomicAdd(dst + 4 * q + 1, acc[q].y);
          atomicAdd(dst + 4 * q + 2, acc[q].z);
          atomicAdd(dst + 4 * q + 3, acc[q].w);
        }
      }
    }
  }

  // Before a slot with `key` is added: flush and restart on a new row.
  __device__ __forceinline__ void visit(int key, int block_rows, float* ys,
                                        int RS, int nq) {
    const bool change = key < block_rows && key != row;
    flush(change && row < block_rows, ys, RS, nq);
    if (change) {
      row = key;
#pragma unroll
      for (int q = 0; q < QMAX; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void finish(int block_rows, float* ys, int RS,
                                         int nq) {
    flush(row < block_rows, ys, RS, nq);
  }
};
