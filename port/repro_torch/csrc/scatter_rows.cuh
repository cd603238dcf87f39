// In-bucket scatter-add of the bucketed kernels (bucket_rows.cuh).
//
// Replaces src/repro/kernels/tile.py:scatter_rows, the reference's in-kernel
// primitive (one-hot MXU product or segmented cumsum over a monotone key).
//
// A CTA owns one bucket's block_rows output rows; no other CTA writes them,
// so no global atomics are needed. Each warp of the CTA sums into a slab of
// its own in shared memory, (block_rows, RS) values of the accumulator type
// A (float for float and bf16 inputs, double for double inputs or a double
// accumulator, common.cuh), and at the end of the bucket the CTA sums the
// slabs in warp order (bucket_rows.cuh). The key of a slot is local_row for a
// valid slot and block_rows (matches no output row) otherwise, the
// reference's where(valid, local_row, block_rows): padding slots carry
// local_row 0, so keying on local_row alone would scatter them into row 0.
//
// Running sums: each thread keeps the sum of its own slots' contributions in
// registers (RowSum::acc) together with the row they belong to (RowSum::row)
// and adds it to its warp's slab only when its key changes, and once at the
// end. A bucket's slots are sorted by row and a thread walks them in slot
// order, so it flushes at most block_rows + 1 times per bucket however many
// slots it takes. Keys in any other order give the same sums, with more
// flushes. A flush is warp-wide: the warp takes the rows its flushing lanes
// hold one at a time, lowest lane first (one row when the flushing lanes
// share it, as at a row boundary inside the warp's slots or at the end of
// the bucket); for each it sums each column over the lanes flushing that row
// with a butterfly of shuffles, and one lane adds the sum to the slab with a
// plain add. A warp's flushes reach its slab in program order and the
// shuffle tree is fixed, so every sum is taken in one order: two launches on
// the same inputs give bit-identical outputs.
//
// Every lane of the warp must call RowSum::visit and RowSum::finish together
// (the capacity loop is uniform across the CTA and blockDim.x is a multiple
// of 32).
#pragma once

#include "common.cuh"

constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(FULL_MASK, v, off);
  }
  return v;
}

// The warp's sum of each column of v.
__device__ __forceinline__ float4 warp_sum_v(float4 a) {
  const float sx = warp_sum(a.x), sy = warp_sum(a.y);
  const float sz = warp_sum(a.z), sw = warp_sum(a.w);
  return make_float4(sx, sy, sz, sw);
}
__device__ __forceinline__ double2 warp_sum_v(double2 a) {
  const double sx = warp_sum(a.x), sy = warp_sum(a.y);
  return make_double2(sx, sy);
}

// dst[0..W) += v's columns (plain shared-memory adds by one lane).
__device__ __forceinline__ void add_to(float* dst, float4 v) {
  dst[0] += v.x;
  dst[1] += v.y;
  dst[2] += v.z;
  dst[3] += v.w;
}
__device__ __forceinline__ void add_to(double* dst, double2 v) {
  dst[0] += v.x;
  dst[1] += v.y;
}

// One thread's running sum over its warp's (rows, RS) shared slab `ys` of A
// (float or double); the first nq = RS / W of its QMAX register vectors
// (Acc<A>::V, W columns each) are live.
template <int QMAX, typename A>
struct RowSum {
  using V = typename Acc<A>::V;
  static constexpr int W = Acc<A>::W;
  V acc[QMAX];
  int row;  // the row acc belongs to, or block_rows before the first slot

  __device__ __forceinline__ void reset(int block_rows) {
    row = block_rows;
#pragma unroll
    for (int q = 0; q < QMAX; ++q) acc[q] = splat(A(0));
  }

  // Add acc to slab row `row` in the lanes where `on` holds: one row at a
  // time, the lowest flushing lane's first, each summed over its lanes.
  __device__ __forceinline__ void flush(bool on, A* ys, int RS, int nq) {
    unsigned pending = __ballot_sync(FULL_MASK, on);
    if (pending == 0) return;
    const int lane = threadIdx.x & 31;
    while (pending != 0) {
      const int lead = __ffs(pending) - 1;
      const int r0 = __shfl_sync(FULL_MASK, row, lead);
      const bool mine = on && row == r0;
      pending &= ~__ballot_sync(FULL_MASK, mine);
      A* dst = ys + r0 * RS;
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        if (q < nq) {
          const V s = warp_sum_v(mine ? acc[q] : splat(A(0)));
          if (lane == lead) add_to(dst + W * q, s);
        }
      }
    }
    // the next flush's adding lane reads what this one wrote
    __syncwarp();
  }

  // Before a slot with `key` is added: flush and restart on a new row.
  __device__ __forceinline__ void visit(int key, int block_rows, A* ys,
                                        int RS, int nq) {
    const bool change = key < block_rows && key != row;
    flush(change && row < block_rows, ys, RS, nq);
    if (change) {
      row = key;
#pragma unroll
      for (int q = 0; q < QMAX; ++q) acc[q] = splat(A(0));
    }
  }

  __device__ __forceinline__ void finish(int block_rows, A* ys, int RS,
                                         int nq) {
    flush(row < block_rows, ys, RS, nq);
  }
};
