// Fused implicit-CG Gram matvec on the card (paper eq. 3, one pass):
//   KR[n]   = prod_{d != mode} A_d[idx[n,d], :]
//   z[n]    = w[n] * sum_s KR[n,s] * x[idx[n,mode], s]
//   Y[i, :] = sum_{n: idx[n,mode] = i} z[n] * KR[n, :]
// over the CCSR row-block buckets of the Omega pattern (w = bucket values).
//
// Replaces src/repro/kernels/cg_matvec.py:cg_matvec_pallas (body
// _cg_matvec_kernel).
//
// What bounds it: bytes. Each bucket slot is read once: w (4 B), nd int32
// indices, local_row (4 B) and valid (1 B), 21 B at nd = 3, and the output
// rows are written once. At the main path's 80 M slots that is about 1.7 GB,
// about 0.5 ms at the H100's 3.35 TB/s. The gathered rows of the factors and
// of x come from L2 while they fit there.
//
// What the design does about it: one CTA per bucket, which owns the bucket's
// output rows in shared memory (scatter_rows.cuh), so no global atomics. One
// slot per thread, so the slot streams are coalesced. KR[n] is formed once
// per slot, in registers (R is rounded up to a compiled RMAX of 16, 32, 64 or
// 128), and used for both halves: the z dot-product and the scatter. The
// (m, R) intermediate of the two-kernel composition never exists. Padding
// slots are skipped without touching the factors. Offsets are 64-bit.
#include "scatter_rows.cuh"

namespace {

template <int RMAX>
__global__ void cg_matvec_kernel(
    const float* __restrict__ omega, const int* __restrict__ indices,
    const int* __restrict__ local_row, const unsigned char* __restrict__ valid,
    long long C, int nd, int mode, FactorTable f,
    const float* __restrict__ x, int R, int block_rows,
    float* __restrict__ out) {
  extern __shared__ float acc[];
  const long long b = blockIdx.x;
  scatter_rows_zero(acc, block_rows * R);
  for (long long c0 = 0; c0 < C; c0 += blockDim.x) {
    const long long c = c0 + threadIdx.x;
    int key = block_rows;
    float z = 0.f;
    float kr[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) kr[r] = 1.f;
    if (c < C) {
      const long long s = b * C + c;
      if (valid[s]) {
        key = local_row[s];
        const int* ix = indices + s * nd;
#pragma unroll
        for (int d = 0; d < MAX_ND; ++d) {
          if (d < nd && d != mode && f.p[d] != nullptr) {
            const float* a = f.p[d] + static_cast<long long>(ix[d]) * R;
#pragma unroll
            for (int r = 0; r < RMAX; ++r) {
              if (r < R) kr[r] *= a[r];
            }
          }
        }
        const float* xr = x + static_cast<long long>(ix[mode]) * R;
        float dot = 0.f;
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r < R) dot += kr[r] * xr[r];
        }
        z = omega[s] * dot;
      }
    }
    const bool uniform = scatter_rows_uniform(key);
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r < R) {
        const float p = key < block_rows ? z * kr[r] : 0.f;
        scatter_rows_add(acc, key, block_rows, R, r, p, uniform);
      }
    }
  }
  scatter_rows_store(acc, out, b, block_rows, R);
}

template <int RMAX>
cudaError_t launch_rmax(const void* omega, const void* indices,
                        const void* local_row, const void* valid, long long nb,
                        long long C, int nd, int mode, FactorTable f,
                        const void* x, int R, int block_rows, void* out,
                        int threads, cudaStream_t stream) {
  const size_t smem = sizeof(float) * block_rows * R;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cg_matvec_kernel<RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cg_matvec_kernel<RMAX><<<static_cast<unsigned>(nb), threads, smem,
                           stream>>>(
      static_cast<const float*>(omega), static_cast<const int*>(indices),
      static_cast<const int*>(local_row),
      static_cast<const unsigned char*>(valid), C, nd, mode, f,
      static_cast<const float*>(x), R, block_rows, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_cg_matvec_bucketed_f32(
    const void* omega, const void* indices, const void* local_row,
    const void* valid, long long nb, long long C, int nd, int mode,
    void** factors, const void* x, int R, int block_rows, void* out,
    int threads, void* stream) {
  if (nd < 1 || nd > MAX_ND || mode < 0 || mode >= nd || R < 1 ||
      threads < 32 || threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  if (nb == 0) return cudaSuccess;
  const FactorTable f = make_factor_table(factors, nd);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 16) {
    return launch_rmax<16>(omega, indices, local_row, valid, nb, C, nd, mode,
                           f, x, R, block_rows, out, threads, s);
  }
  if (R <= 32) {
    return launch_rmax<32>(omega, indices, local_row, valid, nb, C, nd, mode,
                           f, x, R, block_rows, out, threads, s);
  }
  if (R <= 64) {
    return launch_rmax<64>(omega, indices, local_row, valid, nb, C, nd, mode,
                           f, x, R, block_rows, out, threads, s);
  }
  if (R <= 128) {
    return launch_rmax<128>(omega, indices, local_row, valid, nb, C, nd, mode,
                            f, x, R, block_rows, out, threads, s);
  }
  return cudaErrorInvalidValue;
}
