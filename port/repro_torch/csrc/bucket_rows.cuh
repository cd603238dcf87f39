// The one kernel body of the bucketed MTTKRP (mttkrp.cu, FUSED = false) and
// the fused implicit-CG Gram matvec (cg_matvec.cu, FUSED = true), over the
// CCSR row-block buckets of repro_torch/sparse/ccsr.py:
//
//   KR[n]   = prod_{d != mode} A_d[idx[n,d], :]
//   z[n]    = v[n]                                        (MTTKRP)
//   z[n]    = v[n] * sum_s KR[n,s] * x[idx[n,mode], s]    (fused matvec)
//   Y[i, :] = sum_{n: idx[n,mode] = i} z[n] * KR[n, :]
//
// Element types: T is float, __nv_bfloat16 or double (common.cuh),
// instantiated by mttkrp.cu / cg_matvec.cu (float), mttkrp_bf16.cu /
// cg_matvec_bf16.cu (bf16) and mttkrp_f64.cu / cg_matvec_f64.cu (double);
// S, the accumulator, is the compute type C = Acc<T>::type (float for float
// and bf16, double for double) except in mttkrp_f32_acc64.cu,
// mttkrp_bf16_acc64.cu, cg_matvec_f32_acc64.cu and cg_matvec_bf16_acc64.cu,
// which sum float and bf16 inputs in double. Values, factor rows and x are
// read as T and converted in registers to C; KR is formed in C, and so is
// kr * x in the fused matvec. With S = C, z, the dot product, every sum and
// the shared slabs are C, as before. With S = double the reference's cast
// placement holds: the MTTKRP's product KR * v is rounded to C and cast to
// double; the fused matvec's dot sums each product kr * x, rounded to C, in
// double, z = w * dot in double, and z * KR in double; the running sums and
// the slabs are double. x's shared rows stay in C. The output is written as
// T.
//
// Layout the launcher takes: the factors and x as rows of RS elements of T,
// RS a multiple of Elem<T>::VEC (16 bytes) holding R columns and RS - R zero
// columns, at 16-byte-aligned addresses; the output as (nb * block_rows, R)
// rows of T. The zero columns add exact zeros, so Y equals the unpadded
// function's.
//
// One CTA per bucket. It owns the bucket's block_rows output rows: each warp
// sums into its own shared slab of them and the CTA adds the slabs in warp
// order at the end (scatter_rows.cuh), so no atomics and the same sums every
// run; FUSED also holds the bucket's block_rows rows of x in shared memory as
// C, loaded once before the capacity loop (a slot's x row is its key's row).
// The CTA walks the capacity axis SLOTS * blockDim.x slots per step, SLOTS
// slots per thread at a stride of blockDim.x, so every slot stream is read
// coalesced and each thread has SLOTS slots' gathers in flight at once. SLOTS
// and blockDim.x are the launch's tile (KernelTile.per_thread and .threads,
// kernels/tile.py), SLOTS a template depth instantiated for 1, 2 and 4. A
// slot's factor rows are gathered as 16-byte vectors with the R loop
// unrolled at compile time (RS / VEC loads per row, each one float4 of
// floats, two of bf16 or one double2 of doubles: register vectors of W
// columns, Acc<T>::V, VQ of them per load); padding slots carry index 0, so
// their gathers stay in bounds and their key adds them nowhere. Offsets are
// 64-bit.
#pragma once

#include "scatter_rows.cuh"

namespace {

// The explicit minimum of 1 CTA per SM is not the default: nvcc compiles
// the body differently without it, and the MTTKRP then ran 3-5 % slower
// at the main path's shapes on the H100 (PERF.md).
template <int RMAX, bool FUSED, int SLOTS, typename T,
          typename S = typename Acc<T>::type>
__global__ void __launch_bounds__(MAX_THREADS, 1) bucket_rows_kernel(
    const T* __restrict__ values, const int* __restrict__ indices,
    const int* __restrict__ local_row, const unsigned char* __restrict__ valid,
    long long C, int nd, int mode, FactorTable<T> f,
    const T* __restrict__ x, long long x_rows, int R, int RS,
    int block_rows, T* __restrict__ out) {
  using A = typename Acc<T>::type;       // compute type
  using V = typename Acc<T>::V;
  constexpr int W = Acc<T>::W;           // columns of one register vector
  constexpr int QMAX = RMAX / W;
  constexpr int VQ = Elem<T>::VEC / W;   // register vectors of one load
  // accumulator vectors of one compute vector: 2 when S widens float to
  // double, else 1
  constexpr bool WIDE = sizeof(S) > sizeof(A);
  constexpr int WS = Acc<S>::W;
  constexpr int K = W / WS;
  extern __shared__ float4 smem[];
  const int warps = blockDim.x >> 5;
  const int n = block_rows * RS;
  S* slabs = reinterpret_cast<S*>(smem);  // (warps, block_rows, RS) sums
  A* xs = reinterpret_cast<A*>(slabs + warps * n);  // (block_rows, RS) x
  S* ys = slabs + (threadIdx.x >> 5) * n;  // this warp's slab
  const long long b = blockIdx.x;
  const int nq = RS / W;
  const int nqs = RS / WS;
  for (int i = threadIdx.x; i < warps * n; i += blockDim.x) slabs[i] = S(0);
  if (FUSED) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const long long row = b * block_rows + i / RS;
      xs[i] = row < x_rows ? to_acc(x[row * RS + i % RS]) : A(0);
    }
  }
  __syncthreads();

  RowSum<QMAX * K, S> sum;
  sum.reset(block_rows);
  const long long step = static_cast<long long>(SLOTS) * blockDim.x;
  for (long long c0 = 0; c0 < C; c0 += step) {
    int key[SLOTS];
    A w[SLOTS];
    int ix[SLOTS][MAX_ND];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const long long c = c0 + s * blockDim.x + threadIdx.x;
      const bool in = c < C;
      const long long slot = b * C + c;
      const int lr = in ? local_row[slot] : 0;
      const bool ok = in && valid[slot];
      key[s] = ok ? lr : block_rows;
      w[s] = in ? to_acc(values[slot]) : A(0);
#pragma unroll
      for (int d = 0; d < MAX_ND; ++d) {
        ix[s][d] = in && d < nd ? indices[slot * nd + d] : 0;
      }
    }
    V kr[SLOTS][QMAX];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      // the MTTKRP's value leads the chain in C's own sums; a double
      // accumulator takes the reference's order, (prod of rows) * v
      const A k0 = (FUSED || WIDE) ? A(1) : w[s];
#pragma unroll
      for (int q = 0; q < QMAX; ++q) kr[s][q] = splat(k0);
    }
#pragma unroll
    for (int d = 0; d < MAX_ND; ++d) {
      if (d < nd && d != mode && f.p[d] != nullptr) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const T* a = f.p[d] + static_cast<long long>(ix[s][d]) * RS;
#pragma unroll
          for (int q = 0; q < QMAX; q += VQ) {
            if (q < nq) {
              V v[VQ];
              load_vec(a + W * q, v);
#pragma unroll
              for (int k = 0; k < VQ; ++k) kr[s][q + k] = kr[s][q + k] * v[k];
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      sum.visit(key[s], block_rows, ys, RS, nqs);
      if (key[s] < block_rows) {
        if constexpr (WIDE) {
          S z = S(1);
          if (FUSED) {
            const V* xr = reinterpret_cast<const V*>(xs + key[s] * RS);
            S dot = S(0);
#pragma unroll
            for (int q = 0; q < QMAX; ++q) {
              if (q < nq) dot = dot_wide(kr[s][q], xr[q], dot);
            }
            z = static_cast<S>(w[s]) * dot;
          }
#pragma unroll
          for (int q = 0; q < QMAX; ++q) {
            if (q < nq) {
              typename Acc<S>::V lo, hi;
              if (FUSED) {
                widen(kr[s][q], lo, hi);
                sum.acc[2 * q] = fma_v(z, lo, sum.acc[2 * q]);
                sum.acc[2 * q + 1] = fma_v(z, hi, sum.acc[2 * q + 1]);
              } else {
                widen(kr[s][q] * splat(w[s]), lo, hi);
                sum.acc[2 * q] = add_v(sum.acc[2 * q], lo);
                sum.acc[2 * q + 1] = add_v(sum.acc[2 * q + 1], hi);
              }
            }
          }
        } else {
          A z = A(1);
          if (FUSED) {
            const V* xr = reinterpret_cast<const V*>(xs + key[s] * RS);
            A dot = A(0);
#pragma unroll
            for (int q = 0; q < QMAX; ++q) {
              if (q < nq) dot = dot_v(kr[s][q], xr[q], dot);
            }
            z = w[s] * dot;
          }
#pragma unroll
          for (int q = 0; q < QMAX; ++q) {
            if (q < nq) sum.acc[q] = fma_v(z, kr[s][q], sum.acc[q]);
          }
        }
      }
    }
  }
  sum.finish(block_rows, ys, RS, nqs);
  __syncthreads();
  T* dst = out + b * block_rows * R;
  for (int i = threadIdx.x; i < block_rows * R; i += blockDim.x) {
    const int j = (i / R) * RS + i % R;
    S y = slabs[j];
    for (int wp = 1; wp < warps; ++wp) y += slabs[wp * n + j];
    store_elem(dst + i, y);
  }
}

// Dynamic shared memory of one CTA: a slab of (block_rows, RS) sums in S per
// warp, and FUSED the bucket's (block_rows, RS) rows of x in the compute type
// (kernels/footprint.py dynamic_smem_bytes prices the same).
template <bool FUSED, typename T, typename S>
size_t bucket_smem(int threads, int block_rows, int RS) {
  const size_t n = static_cast<size_t>(block_rows) * RS;
  return sizeof(S) * (threads / 32) * n +
         (FUSED ? sizeof(typename Acc<T>::type) * n : 0);
}

template <int RMAX, bool FUSED, int SLOTS, typename T, typename S>
cudaError_t launch_tile(const void* values, const void* indices,
                        const void* local_row, const void* valid,
                        long long nb, long long C, int nd, int mode,
                        const FactorTable<T>& f, const void* x,
                        long long x_rows,
                        int R, int RS, int block_rows, void* out, int threads,
                        cudaStream_t stream) {
  const size_t smem = bucket_smem<FUSED, T, S>(threads, block_rows, RS);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bucket_rows_kernel<RMAX, FUSED, SLOTS, T, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  bucket_rows_kernel<RMAX, FUSED, SLOTS, T, S>
      <<<static_cast<unsigned>(nb), threads, smem, stream>>>(
          static_cast<const T*>(values), static_cast<const int*>(indices),
          static_cast<const int*>(local_row),
          static_cast<const unsigned char*>(valid), C, nd, mode, f,
          static_cast<const T*>(x), x_rows, R, RS, block_rows,
          static_cast<T*>(out));
  return cudaGetLastError();
}

// The instantiation for the tile's per-thread depth (1, 2 or 4, checked by
// the caller).
template <int RMAX, bool FUSED, typename T, typename S>
cudaError_t launch_rmax(const void* values, const void* indices,
                        const void* local_row, const void* valid,
                        long long nb, long long C, int nd, int mode,
                        const FactorTable<T>& f, const void* x,
                        long long x_rows,
                        int R, int RS, int block_rows, void* out, int threads,
                        int per_thread, cudaStream_t stream) {
  switch (per_thread) {
    case 1:
      return launch_tile<RMAX, FUSED, 1, T, S>(
          values, indices, local_row, valid, nb, C, nd, mode, f, x, x_rows,
          R, RS, block_rows, out, threads, stream);
    case 2:
      return launch_tile<RMAX, FUSED, 2, T, S>(
          values, indices, local_row, valid, nb, C, nd, mode, f, x, x_rows,
          R, RS, block_rows, out, threads, stream);
    default:
      return launch_tile<RMAX, FUSED, 4, T, S>(
          values, indices, local_row, valid, nb, C, nd, mode, f, x, x_rows,
          R, RS, block_rows, out, threads, stream);
  }
}

// Checks the arguments, then launches bucket_rows_kernel compiled for the
// least RMAX of 16, 32, 64 and 128 that holds RS and for the tile's
// per-thread depth, on operands of T summed in S. `x` is read only when
// FUSED. Returns cudaErrorInvalidValue for what the kernel does not take.
template <bool FUSED, typename T, typename S = typename Acc<T>::type>
cudaError_t launch_bucket_rows(const void* values, const void* indices,
                               const void* local_row, const void* valid,
                               long long nb, long long C, int nd, int mode,
                               void* const* factors, const void* x,
                               long long x_rows, int R, int RS,
                               int block_rows, void* out, int threads,
                               int per_thread, void* stream) {
  if (nd < 1 || nd > MAX_ND || mode < 0 || mode >= nd || R < 1 || RS < R ||
      RS % Elem<T>::VEC != 0 || RS > 128 || block_rows < 1 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 ||
      !valid_depth(per_thread) || nb >= (1LL << 31) ||
      (FUSED && (x == nullptr || !aligned16(x)))) {
    return cudaErrorInvalidValue;
  }
  const FactorTable<T> f = make_factor_table<T>(factors, nd);
  for (int d = 0; d < nd; ++d) {
    if (f.p[d] != nullptr && !aligned16(f.p[d])) return cudaErrorInvalidValue;
  }
  if (nb == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (RS <= 16) {
    return launch_rmax<16, FUSED, T, S>(values, indices, local_row, valid,
                                        nb, C, nd, mode, f, x, x_rows, R, RS,
                                        block_rows, out, threads, per_thread,
                                        s);
  }
  if (RS <= 32) {
    return launch_rmax<32, FUSED, T, S>(values, indices, local_row, valid,
                                        nb, C, nd, mode, f, x, x_rows, R, RS,
                                        block_rows, out, threads, per_thread,
                                        s);
  }
  if (RS <= 64) {
    return launch_rmax<64, FUSED, T, S>(values, indices, local_row, valid,
                                        nb, C, nd, mode, f, x, x_rows, R, RS,
                                        block_rows, out, threads, per_thread,
                                        s);
  }
  return launch_rmax<128, FUSED, T, S>(values, indices, local_row, valid, nb,
                                       C, nd, mode, f, x, x_rows, R, RS,
                                       block_rows, out, threads, per_thread,
                                       s);
}

template <int RMAX, bool FUSED, typename T, typename S>
const void* bucket_rows_entry(int per_thread) {
  switch (per_thread) {
    case 1:
      return reinterpret_cast<const void*>(
          bucket_rows_kernel<RMAX, FUSED, 1, T, S>);
    case 2:
      return reinterpret_cast<const void*>(
          bucket_rows_kernel<RMAX, FUSED, 2, T, S>);
    case 4:
      return reinterpret_cast<const void*>(
          bucket_rows_kernel<RMAX, FUSED, 4, T, S>);
    default:
      return nullptr;
  }
}

// func_attributes (common.cuh) of bucket_rows_kernel<rmax, FUSED,
// per_thread, T, S>; an instantiation that does not exist is
// cudaErrorInvalidValue.
template <bool FUSED, typename T, typename S = typename Acc<T>::type>
cudaError_t bucket_rows_attributes(int rmax, int per_thread, int threads,
                                   long long smem, int* out) {
  const void* fn = nullptr;
  switch (rmax) {
    case 16: fn = bucket_rows_entry<16, FUSED, T, S>(per_thread); break;
    case 32: fn = bucket_rows_entry<32, FUSED, T, S>(per_thread); break;
    case 64: fn = bucket_rows_entry<64, FUSED, T, S>(per_thread); break;
    case 128: fn = bucket_rows_entry<128, FUSED, T, S>(per_thread); break;
    default: break;
  }
  return func_attributes(fn, threads, smem, out);
}

}  // namespace
