// TTTP on the card over padded COO:
//   out[n] = valid[n] ? values[n] * sum_r prod_{d present} A_d[idx[n,d], r] : 0
//
// Replaces src/repro/kernels/tttp.py:tttp_pallas (body _tttp_kernel). The
// kernel template, instantiated per element type by tttp.cu (float),
// tttp_bf16.cu (__nv_bfloat16) and tttp_f64.cu (double), and with a double
// accumulator S over float and bf16 inputs by tttp_f32_acc64.cu and
// tttp_bf16_acc64.cu, one nvcc process each.
//
// What bounds it: bytes. Per nonzero it reads one value, one valid byte and
// nd int32 indices and writes one value, (2 * e + 1 + 4*nd) bytes of HBM
// traffic for an element of e bytes (4 float, 2 bf16, 8 double), against
// R*n_present multiply-adds. The gathered factor rows come from L2 while the
// factors fit there (a factor of 20000 rows of 12 floats is 1 MB; L2 holds
// 50 MB): a 48-byte float row spans two 32-byte sectors, so at the main
// path's size the gathers move about 15 GB of L2 sectors per call, nine
// times the HBM bytes above, and that traffic is what the kernel works
// against. A bf16 row of R = 10 padded to 16 values is 32 bytes, one aligned
// sector: half the sectors. A double row of R = 10 is 80 bytes, three
// sectors at most row offsets.
//
// What the design does about it: the factors arrive as rows of RS elements,
// RS a multiple of Elem<T>::VEC (16 bytes), at 16-byte-aligned addresses
// (zero-padded copies), so a row is read as 16-byte vector loads, not R
// scalar loads. A float load is one float4; a bf16 load is converted to two
// float4s in registers and every product and sum is taken in float; a
// double load is one double2 and every product and sum is double (the
// register vectors V of W columns, Acc<T> in common.cuh). With a double
// accumulator over float or bf16 inputs the products stay float and each
// column of a product is cast to double before it is summed; the sum over R
// and values[n] * sum are double, and the result is rounded once to T (the
// reference's accum_dtype "float64"). Each thread takes
// NZ nonzeros per step at a stride of blockDim.x, so every value, valid,
// index and output stream is read coalesced, and it issues all of the
// step's index loads, then all of its row loads for QB register vectors,
// before the products: NZ * n_present * QB / VQ loads in flight per thread.
// R is walked QB vectors at a time into one scalar sum per nonzero, so there
// is no bound on R and no register array over it; the columns past R in the
// last vector are masked. A padding slot (valid false) issues no gathers and
// writes 0. No shared memory and no atomics, so the result does not depend
// on scheduling. Offsets are 64-bit.
#pragma once

#include "common.cuh"

namespace {

// register vectors of a row gathered per pass over R (16 float columns, 8
// double ones)
constexpr int QB = 4;

// The present factors only, with the index column each is gathered by, so
// the kernel's loop over them has no run-time test and every load of a pass
// can be issued before the first product.
template <typename T>
struct PresentFactors {
  const T* p[MAX_ND];
  int col[MAX_ND];
};

// NZ, the nonzeros a thread takes per step, is the launch's tile
// (KernelTile.per_thread in kernels/tile.py), instantiated for 1, 2 and 4.
template <int NP, int NZ, typename T, typename S = typename Acc<T>::type>
__global__ void __launch_bounds__(MAX_THREADS) tttp_kernel(
    const T* __restrict__ values, const int* __restrict__ indices,
    const unsigned char* __restrict__ valid, long long m, int nd,
    PresentFactors<T> f, int R, int RS, T* __restrict__ out) {
  using A = typename Acc<T>::type;
  using V = typename Acc<T>::V;
  constexpr int W = Acc<T>::W;
  // register vectors of a load, and of R rounded up to whole loads
  constexpr int VQ = Elem<T>::VEC / W;
  const int nq = (R + Elem<T>::VEC - 1) / Elem<T>::VEC * VQ;
  const long long step = static_cast<long long>(NZ) * blockDim.x;
  for (long long n0 = blockIdx.x * step + threadIdx.x; n0 < m;
       n0 += gridDim.x * step) {
    bool ok[NZ];
    long long row[NZ][NP];
#pragma unroll
    for (int s = 0; s < NZ; ++s) {
      const long long n = n0 + s * blockDim.x;
      ok[s] = n < m && valid[n];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int i = ok[s] ? indices[n * nd + f.col[j]] : 0;
        row[s][j] = static_cast<long long>(i) * RS;
      }
    }
    S acc[NZ];
#pragma unroll
    for (int s = 0; s < NZ; ++s) acc[s] = S(0);
    for (int q0 = 0; q0 < nq; q0 += QB) {
      V p[NZ][QB];
#pragma unroll
      for (int s = 0; s < NZ; ++s) {
#pragma unroll
        for (int q = 0; q < QB; ++q) p[s][q] = splat(A(1));
      }
#pragma unroll
      for (int j = 0; j < NP; ++j) {
#pragma unroll
        for (int s = 0; s < NZ; ++s) {
          const T* a = f.p[j] + row[s][j] + W * q0;
#pragma unroll
          for (int q = 0; q < QB; q += VQ) {
            if (ok[s] && q0 + q < nq) {
              V v[VQ];
              load_vec(a + W * q, v);
#pragma unroll
              for (int k = 0; k < VQ; ++k) p[s][q + k] = p[s][q + k] * v[k];
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < NZ; ++s) {
#pragma unroll
        for (int q = 0; q < QB; ++q) {
          const int left = R - W * (q0 + q);  // columns of this vector < R
          if (left > 0) {
            if constexpr (sizeof(S) > sizeof(A)) {
              acc[s] += sum_first_wide(p[s][q], left);
            } else {
              acc[s] += sum_first(p[s][q], left);
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NZ; ++s) {
      const long long n = n0 + s * blockDim.x;
      if (n < m) {
        store_elem(out + n, ok[s] ? static_cast<S>(to_acc(values[n])) * acc[s]
                                  : S(0));
      }
    }
  }
}

template <int NP, int NZ, typename T, typename S>
cudaError_t launch_nz(const T* values, const int* indices,
                      const unsigned char* valid, long long m, int nd,
                      const PresentFactors<T>& f, int R, int RS, T* out,
                      int threads, cudaStream_t stream) {
  const long long step = static_cast<long long>(NZ) * threads;
  long long blocks = (m + step - 1) / step;
  if (blocks > MAX_GRID) blocks = MAX_GRID;
  tttp_kernel<NP, NZ, T, S><<<static_cast<unsigned>(blocks), threads, 0,
                               stream>>>(
      values, indices, valid, m, nd, f, R, RS, out);
  return cudaGetLastError();
}

// The instantiation for the tile's per-thread depth (1, 2 or 4, checked by
// the caller).
template <int NP, typename T, typename S>
cudaError_t launch_np(const T* values, const int* indices,
                      const unsigned char* valid, long long m, int nd,
                      const PresentFactors<T>& f, int R, int RS, T* out,
                      int threads, int per_thread, cudaStream_t stream) {
  switch (per_thread) {
    case 1:
      return launch_nz<NP, 1, T, S>(values, indices, valid, m, nd, f, R,
                                    RS, out, threads, stream);
    case 2:
      return launch_nz<NP, 2, T, S>(values, indices, valid, m, nd, f, R,
                                    RS, out, threads, stream);
    default:
      return launch_nz<NP, 4, T, S>(values, indices, valid, m, nd, f, R,
                                    RS, out, threads, stream);
  }
}

template <int NP, typename T, typename S>
const void* tttp_entry(int per_thread) {
  switch (per_thread) {
    case 1: return reinterpret_cast<const void*>(tttp_kernel<NP, 1, T, S>);
    case 2: return reinterpret_cast<const void*>(tttp_kernel<NP, 2, T, S>);
    case 4: return reinterpret_cast<const void*>(tttp_kernel<NP, 4, T, S>);
    default: return nullptr;
  }
}

// The launcher of tttp.cu, tttp_bf16.cu, tttp_f64.cu and the *_acc64.cu
// twins. values, the factor rows and out are of T, the sums of S. factors:
// nd pointers (NULL for an absent factor, at least one present), each to
// rows of RS elements whose first R columns are the factor's, 16-byte
// aligned, with RS a multiple of VEC and at least R rounded up to VEC.
template <typename T, typename S = typename Acc<T>::type>
int launch_tttp(const void* values, const void* indices, const void* valid,
                long long m, int nd, void** factors, int R, int RS, void* out,
                int threads, int per_thread, void* stream) {
  constexpr int VEC = Elem<T>::VEC;
  if (nd < 1 || nd > MAX_ND || R < 1 || RS % VEC != 0 ||
      RS < (R + VEC - 1) / VEC * VEC ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      !valid_depth(per_thread)) {
    return cudaErrorInvalidValue;
  }
  PresentFactors<T> f;
  int np = 0;
  for (int d = 0; d < nd; ++d) {
    if (factors[d] == nullptr) continue;
    if (!aligned16(factors[d])) return cudaErrorInvalidValue;
    f.p[np] = static_cast<const T*>(factors[d]);
    f.col[np++] = d;
  }
  for (int j = np; j < MAX_ND; ++j) {
    f.p[j] = nullptr;
    f.col[j] = 0;
  }
  if (np == 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const auto* v = static_cast<const T*>(values);
  const auto* ix = static_cast<const int*>(indices);
  const auto* ok = static_cast<const unsigned char*>(valid);
  auto* o = static_cast<T*>(out);
  const int p = per_thread;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (np) {
    case 1:
      return launch_np<1, T, S>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 2:
      return launch_np<2, T, S>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 3:
      return launch_np<3, T, S>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 4:
      return launch_np<4, T, S>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 5:
      return launch_np<5, T, S>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 6:
      return launch_np<6, T, S>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 7:
      return launch_np<7, T, S>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    default:
      return launch_np<8, T, S>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
  }
}

// tttp_kernel<np, per_thread, T, S>'s attributes, for repro_kernel_attributes
// (attributes.cu); an instantiation that does not exist is
// cudaErrorInvalidValue.
template <typename T, typename S = typename Acc<T>::type>
cudaError_t tttp_attributes_of(int np, int per_thread, int threads,
                               long long smem, int* out) {
  const void* fn = nullptr;
  switch (np) {
    case 1: fn = tttp_entry<1, T, S>(per_thread); break;
    case 2: fn = tttp_entry<2, T, S>(per_thread); break;
    case 3: fn = tttp_entry<3, T, S>(per_thread); break;
    case 4: fn = tttp_entry<4, T, S>(per_thread); break;
    case 5: fn = tttp_entry<5, T, S>(per_thread); break;
    case 6: fn = tttp_entry<6, T, S>(per_thread); break;
    case 7: fn = tttp_entry<7, T, S>(per_thread); break;
    case 8: fn = tttp_entry<8, T, S>(per_thread); break;
    default: break;
  }
  return func_attributes(fn, threads, smem, out);
}

}  // namespace
