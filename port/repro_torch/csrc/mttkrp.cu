// Bucketed MTTKRP on the card:
//   Y[i, :] = sum_{n: idx[n,mode] = i} v[n] * prod_{d != mode} A_d[idx[n,d], :]
// over CCSR row-block buckets (repro_torch/sparse/ccsr.py).
//
// Replaces src/repro/kernels/mttkrp.py:mttkrp_pallas (body _mttkrp_kernel).
//
// What bounds it: bytes. Each bucket slot is read once: its value (4 B),
// nd int32 indices, local_row (4 B) and valid (1 B), 21 B at nd = 3, and
// the output rows are written once. The gathered factor rows come from L2
// while the factors fit there. The arithmetic, R*(nd-1) multiplies and R
// adds per slot, is far below the fp32 rate.
//
// What the design does about it: one CTA per bucket, so the CTA owns the
// bucket's block_rows output rows and accumulates them in shared memory with
// no global atomics (scatter_rows.cuh). The CTA walks the capacity axis
// blockDim.x slots at a time, one slot per thread, so a warp's loads of
// values, indices, local rows and flags are contiguous; padding slots
// (valid == 0) are skipped without touching the factors. The Khatri-Rao
// product is formed column by column in registers and reduced across the
// warp before it reaches shared memory. Offsets are 64-bit.
#include "scatter_rows.cuh"

namespace {

__global__ void mttkrp_bucketed_kernel(
    const float* __restrict__ values, const int* __restrict__ indices,
    const int* __restrict__ local_row, const unsigned char* __restrict__ valid,
    long long C, int nd, int mode, FactorTable f, int R, int block_rows,
    float* __restrict__ out) {
  extern __shared__ float acc[];
  const long long b = blockIdx.x;
  scatter_rows_zero(acc, block_rows * R);
  for (long long c0 = 0; c0 < C; c0 += blockDim.x) {
    const long long c = c0 + threadIdx.x;
    int key = block_rows;
    float v = 0.f;
    long long row[MAX_ND];
#pragma unroll
    for (int d = 0; d < MAX_ND; ++d) row[d] = 0;
    if (c < C) {
      const long long s = b * C + c;
      if (valid[s]) {
        key = local_row[s];
        v = values[s];
#pragma unroll
        for (int d = 0; d < MAX_ND; ++d) {
          if (d < nd) row[d] = static_cast<long long>(indices[s * nd + d]) * R;
        }
      }
    }
    const bool uniform = scatter_rows_uniform(key);
    for (int r = 0; r < R; ++r) {
      float p = 0.f;
      if (key < block_rows) {
        p = v;
#pragma unroll
        for (int d = 0; d < MAX_ND; ++d) {
          if (d < nd && d != mode && f.p[d] != nullptr) p *= f.p[d][row[d] + r];
        }
      }
      scatter_rows_add(acc, key, block_rows, R, r, p, uniform);
    }
  }
  scatter_rows_store(acc, out, b, block_rows, R);
}

}  // namespace

extern "C" int repro_mttkrp_bucketed_f32(
    const void* values, const void* indices, const void* local_row,
    const void* valid, long long nb, long long C, int nd, int mode,
    void** factors, int R, int block_rows, void* out, int threads,
    void* stream) {
  if (nd < 1 || nd > MAX_ND || threads < 32 || threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  if (nb == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * block_rows * R;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mttkrp_bucketed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  mttkrp_bucketed_kernel<<<static_cast<unsigned>(nb), threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(indices),
      static_cast<const int*>(local_row),
      static_cast<const unsigned char*>(valid), C, nd, mode,
      make_factor_table(factors, nd), R, block_rows, static_cast<float*>(out));
  return cudaGetLastError();
}
