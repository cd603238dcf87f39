// The one kernel body of the bucketed MTTKRP (mttkrp.cu, FUSED = false) and
// the fused implicit-CG Gram matvec (cg_matvec.cu, FUSED = true), over the
// CCSR row-block buckets of repro_torch/sparse/ccsr.py:
//
//   KR[n]   = prod_{d != mode} A_d[idx[n,d], :]
//   z[n]    = v[n]                                        (MTTKRP)
//   z[n]    = v[n] * sum_s KR[n,s] * x[idx[n,mode], s]    (fused matvec)
//   Y[i, :] = sum_{n: idx[n,mode] = i} z[n] * KR[n, :]
//
// Layout the launcher takes: the factors and x as rows of RS floats, RS a
// multiple of 4 (16 bytes) holding R columns and RS - R zero columns, at
// 16-byte-aligned addresses; the output as (nb * block_rows, R) rows. The
// zero columns add exact zeros, so Y equals the unpadded function's.
//
// One CTA per bucket. It owns the bucket's block_rows output rows in shared
// memory (scatter_rows.cuh), so no global atomics; FUSED also holds the
// bucket's block_rows rows of x there, loaded once before the capacity loop
// (a slot's x row is its key's row). The CTA walks the capacity axis
// SLOTS * blockDim.x slots per step, SLOTS slots per thread at a stride of
// blockDim.x, so every slot stream is read coalesced and each thread has
// SLOTS slots' gathers in flight at once. A slot's factor rows are gathered
// as float4s with the R loop unrolled at compile time (RS / 4 loads per
// row); padding slots carry index 0, so their gathers stay in bounds and
// their key adds them nowhere. Offsets are 64-bit.
#pragma once

#include "scatter_rows.cuh"

namespace {

// Bucket slots a thread takes per step of the capacity loop. Chosen by
// timing the main path's shapes on the H100: 1, 3 and 4 slots were slower
// (PERF.md).
constexpr int SLOTS = 2;

// The explicit minimum of 1 CTA per SM is not the default: nvcc compiles
// the body differently without it, and the MTTKRP then ran 3-5 % slower
// at the main path's shapes on the H100 (PERF.md).
template <int RMAX, bool FUSED>
__global__ void __launch_bounds__(MAX_THREADS, 1) bucket_rows_kernel(
    const float* __restrict__ values, const int* __restrict__ indices,
    const int* __restrict__ local_row, const unsigned char* __restrict__ valid,
    long long C, int nd, int mode, FactorTable f,
    const float* __restrict__ x, long long x_rows, int R, int RS,
    int block_rows, float* __restrict__ out) {
  constexpr int QMAX = RMAX / 4;
  extern __shared__ float4 smem[];
  float* ys = reinterpret_cast<float*>(smem);  // (block_rows, RS) sums
  float* xs = ys + block_rows * RS;            // (block_rows, RS) x rows
  const long long b = blockIdx.x;
  const int nq = RS / 4;
  const int n = block_rows * RS;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    ys[i] = 0.f;
    if (FUSED) {
      const long long row = b * block_rows + i / RS;
      xs[i] = row < x_rows ? x[row * RS + i % RS] : 0.f;
    }
  }
  __syncthreads();

  RowSum<QMAX> sum;
  sum.reset(block_rows);
  const long long step = static_cast<long long>(SLOTS) * blockDim.x;
  for (long long c0 = 0; c0 < C; c0 += step) {
    int key[SLOTS];
    float w[SLOTS];
    int ix[SLOTS][MAX_ND];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const long long c = c0 + s * blockDim.x + threadIdx.x;
      const bool in = c < C;
      const long long slot = b * C + c;
      const int lr = in ? local_row[slot] : 0;
      const bool ok = in && valid[slot];
      key[s] = ok ? lr : block_rows;
      w[s] = in ? values[slot] : 0.f;
#pragma unroll
      for (int d = 0; d < MAX_ND; ++d) {
        ix[s][d] = in && d < nd ? indices[slot * nd + d] : 0;
      }
    }
    float4 kr[SLOTS][QMAX];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const float k0 = FUSED ? 1.f : w[s];
#pragma unroll
      for (int q = 0; q < QMAX; ++q) kr[s][q] = make_float4(k0, k0, k0, k0);
    }
#pragma unroll
    for (int d = 0; d < MAX_ND; ++d) {
      if (d < nd && d != mode && f.p[d] != nullptr) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const float4* a = reinterpret_cast<const float4*>(
              f.p[d] + static_cast<long long>(ix[s][d]) * RS);
#pragma unroll
          for (int q = 0; q < QMAX; ++q) {
            if (q < nq) kr[s][q] = kr[s][q] * __ldg(a + q);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      sum.visit(key[s], block_rows, ys, RS, nq);
      if (key[s] < block_rows) {
        float z = 1.f;
        if (FUSED) {
          const float4* xr = reinterpret_cast<const float4*>(xs + key[s] * RS);
          float dot = 0.f;
#pragma unroll
          for (int q = 0; q < QMAX; ++q) {
            if (q < nq) {
              const float4 xv = xr[q];
              dot = fmaf(kr[s][q].x, xv.x, dot);
              dot = fmaf(kr[s][q].y, xv.y, dot);
              dot = fmaf(kr[s][q].z, xv.z, dot);
              dot = fmaf(kr[s][q].w, xv.w, dot);
            }
          }
          z = w[s] * dot;
        }
#pragma unroll
        for (int q = 0; q < QMAX; ++q) {
          if (q < nq) sum.acc[q] = fma4(z, kr[s][q], sum.acc[q]);
        }
      }
    }
  }
  sum.finish(block_rows, ys, RS, nq);
  __syncthreads();
  float* dst = out + b * block_rows * R;
  for (int i = threadIdx.x; i < block_rows * R; i += blockDim.x) {
    dst[i] = ys[(i / R) * RS + i % R];
  }
}

template <int RMAX, bool FUSED>
cudaError_t launch_rmax(const void* values, const void* indices,
                        const void* local_row, const void* valid,
                        long long nb, long long C, int nd, int mode,
                        const FactorTable& f, const void* x, long long x_rows,
                        int R, int RS, int block_rows, void* out, int threads,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * block_rows * RS * (FUSED ? 2 : 1);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bucket_rows_kernel<RMAX, FUSED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  bucket_rows_kernel<RMAX, FUSED>
      <<<static_cast<unsigned>(nb), threads, smem, stream>>>(
          static_cast<const float*>(values), static_cast<const int*>(indices),
          static_cast<const int*>(local_row),
          static_cast<const unsigned char*>(valid), C, nd, mode, f,
          static_cast<const float*>(x), x_rows, R, RS, block_rows,
          static_cast<float*>(out));
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

// Checks the arguments, then launches bucket_rows_kernel compiled for the
// least RMAX of 16, 32, 64 and 128 that holds RS. `x` is read only when
// FUSED. Returns cudaErrorInvalidValue for what the kernel does not take.
template <bool FUSED>
cudaError_t launch_bucket_rows(const void* values, const void* indices,
                               const void* local_row, const void* valid,
                               long long nb, long long C, int nd, int mode,
                               void* const* factors, const void* x,
                               long long x_rows, int R, int RS,
                               int block_rows, void* out, int threads,
                               void* stream) {
  if (nd < 1 || nd > MAX_ND || mode < 0 || mode >= nd || R < 1 || RS < R ||
      RS % 4 != 0 || RS > 128 || block_rows < 1 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || nb >= (1LL << 31) ||
      (FUSED && (x == nullptr || !aligned16(x)))) {
    return cudaErrorInvalidValue;
  }
  const FactorTable f = make_factor_table(factors, nd);
  for (int d = 0; d < nd; ++d) {
    if (f.p[d] != nullptr && !aligned16(f.p[d])) return cudaErrorInvalidValue;
  }
  if (nb == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (RS <= 16) {
    return launch_rmax<16, FUSED>(values, indices, local_row, valid, nb, C,
                                  nd, mode, f, x, x_rows, R, RS, block_rows,
                                  out, threads, s);
  }
  if (RS <= 32) {
    return launch_rmax<32, FUSED>(values, indices, local_row, valid, nb, C,
                                  nd, mode, f, x, x_rows, R, RS, block_rows,
                                  out, threads, s);
  }
  if (RS <= 64) {
    return launch_rmax<64, FUSED>(values, indices, local_row, valid, nb, C,
                                  nd, mode, f, x, x_rows, R, RS, block_rows,
                                  out, threads, s);
  }
  return launch_rmax<128, FUSED>(values, indices, local_row, valid, nb, C, nd,
                                 mode, f, x, x_rows, R, RS, block_rows, out,
                                 threads, s);
}

}  // namespace
