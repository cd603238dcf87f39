// TTTP on the card over padded COO:
//   out[n] = valid[n] ? values[n] * sum_r prod_{d present} A_d[idx[n,d], r] : 0
//
// Replaces src/repro/kernels/tttp.py:tttp_pallas (body _tttp_kernel).
//
// What bounds it: bytes. Per nonzero it reads one float value, one valid
// byte and nd int32 indices and writes one float, (9 + 4*nd) bytes of HBM
// traffic, against R*n_present multiply-adds. The gathered factor rows come
// from L2 while the factors fit there (a factor of 20000 rows of 12 floats
// is 1 MB; L2 holds 50 MB): a 48-byte row spans two 32-byte sectors, so at
// the main path's size the gathers move about 15 GB of L2 sectors per call,
// nine times the HBM bytes above, and that traffic is what the kernel works
// against.
//
// What the design does about it: the factors arrive as rows of RS floats,
// RS a multiple of 4, at 16-byte-aligned addresses (zero-padded copies, or
// a column slice of one at a column that is a multiple of 4), so a row is
// read as float4 loads, R / 4 of them, not R scalar loads. Each thread takes
// NZ nonzeros per step at a stride of blockDim.x, so every value, valid,
// index and output stream is read coalesced, and it issues all of the
// step's index loads, then all of its row loads for QB float4 columns, before
// the products: NZ * n_present * QB loads in flight per thread. R is walked
// QB float4s at a time into one scalar sum per nonzero, so there is no bound
// on R and no register array over it; the columns past R in the last float4
// are masked. A padding slot (valid false) issues no gathers and writes 0.
// No shared memory and no atomics, so the result does not depend on
// scheduling. Offsets are 64-bit.
#include "common.cuh"

namespace {

// float4 columns of a row gathered per pass over R (16 columns)
constexpr int QB = 4;

// The present factors only, with the index column each is gathered by, so
// the kernel's loop over them has no run-time test and every load of a pass
// can be issued before the first product.
struct PresentFactors {
  const float* p[MAX_ND];
  int col[MAX_ND];
};

// NZ, the nonzeros a thread takes per step, is the launch's tile
// (KernelTile.per_thread in kernels/tile.py), instantiated for 1, 2 and 4.
template <int NP, int NZ>
__global__ void __launch_bounds__(MAX_THREADS) tttp_kernel(
    const float* __restrict__ values, const int* __restrict__ indices,
    const unsigned char* __restrict__ valid, long long m, int nd,
    PresentFactors f, int R, int RS, float* __restrict__ out) {
  const int nq = (R + 3) / 4;
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
    float acc[NZ];
#pragma unroll
    for (int s = 0; s < NZ; ++s) acc[s] = 0.f;
    for (int q0 = 0; q0 < nq; q0 += QB) {
      float4 p[NZ][QB];
#pragma unroll
      for (int s = 0; s < NZ; ++s) {
#pragma unroll
        for (int q = 0; q < QB; ++q) p[s][q] = make_float4(1.f, 1.f, 1.f, 1.f);
      }
#pragma unroll
      for (int j = 0; j < NP; ++j) {
#pragma unroll
        for (int s = 0; s < NZ; ++s) {
          const float4* a =
              reinterpret_cast<const float4*>(f.p[j] + row[s][j]) + q0;
#pragma unroll
          for (int q = 0; q < QB; ++q) {
            if (ok[s] && q0 + q < nq) p[s][q] = p[s][q] * __ldg(a + q);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < NZ; ++s) {
#pragma unroll
        for (int q = 0; q < QB; ++q) {
          const int left = R - 4 * (q0 + q);  // columns of this float4 < R
          if (left > 0) {
            float4 v = p[s][q];
            if (left < 4) v.w = 0.f;
            if (left < 3) v.z = 0.f;
            if (left < 2) v.y = 0.f;
            acc[s] += (v.x + v.y) + (v.z + v.w);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NZ; ++s) {
      const long long n = n0 + s * blockDim.x;
      if (n < m) out[n] = ok[s] ? values[n] * acc[s] : 0.f;
    }
  }
}

template <int NP, int NZ>
cudaError_t launch_nz(const float* values, const int* indices,
                      const unsigned char* valid, long long m, int nd,
                      const PresentFactors& f, int R, int RS, float* out,
                      int threads, cudaStream_t stream) {
  const long long step = static_cast<long long>(NZ) * threads;
  long long blocks = (m + step - 1) / step;
  if (blocks > MAX_GRID) blocks = MAX_GRID;
  tttp_kernel<NP, NZ><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      values, indices, valid, m, nd, f, R, RS, out);
  return cudaGetLastError();
}

// The instantiation for the tile's per-thread depth (1, 2 or 4, checked by
// the caller).
template <int NP>
cudaError_t launch_np(const float* values, const int* indices,
                      const unsigned char* valid, long long m, int nd,
                      const PresentFactors& f, int R, int RS, float* out,
                      int threads, int per_thread, cudaStream_t stream) {
  switch (per_thread) {
    case 1:
      return launch_nz<NP, 1>(values, indices, valid, m, nd, f, R, RS, out,
                              threads, stream);
    case 2:
      return launch_nz<NP, 2>(values, indices, valid, m, nd, f, R, RS, out,
                              threads, stream);
    default:
      return launch_nz<NP, 4>(values, indices, valid, m, nd, f, R, RS, out,
                              threads, stream);
  }
}

template <int NP>
const void* tttp_entry(int per_thread) {
  switch (per_thread) {
    case 1: return reinterpret_cast<const void*>(tttp_kernel<NP, 1>);
    case 2: return reinterpret_cast<const void*>(tttp_kernel<NP, 2>);
    case 4: return reinterpret_cast<const void*>(tttp_kernel<NP, 4>);
    default: return nullptr;
  }
}

}  // namespace

// factors: nd pointers (NULL for an absent factor, at least one present),
// each to rows of RS floats whose first R columns are the factor's, 16-byte
// aligned, with RS a multiple of 4 and at least R rounded up to 4.
extern "C" int repro_tttp_f32(const void* values, const void* indices,
                              const void* valid, long long m, int nd,
                              void** factors, int R, int RS, void* out,
                              int threads, int per_thread, void* stream) {
  if (nd < 1 || nd > MAX_ND || R < 1 || RS % 4 != 0 || RS < (R + 3) / 4 * 4 ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      !valid_depth(per_thread)) {
    return cudaErrorInvalidValue;
  }
  PresentFactors f;
  int np = 0;
  for (int d = 0; d < nd; ++d) {
    if (factors[d] == nullptr) continue;
    if (!aligned16(factors[d])) return cudaErrorInvalidValue;
    f.p[np] = static_cast<const float*>(factors[d]);
    f.col[np++] = d;
  }
  for (int j = np; j < MAX_ND; ++j) {
    f.p[j] = nullptr;
    f.col[j] = 0;
  }
  if (np == 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const auto* v = static_cast<const float*>(values);
  const auto* ix = static_cast<const int*>(indices);
  const auto* ok = static_cast<const unsigned char*>(valid);
  auto* o = static_cast<float*>(out);
  const int p = per_thread;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (np) {
    case 1: return launch_np<1>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 2: return launch_np<2>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 3: return launch_np<3>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 4: return launch_np<4>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 5: return launch_np<5>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 6: return launch_np<6>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    case 7: return launch_np<7>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
    default: return launch_np<8>(v, ix, ok, m, nd, f, R, RS, o, threads, p, s);
  }
}

// tttp_kernel<np, per_thread>'s attributes, for repro_kernel_attributes
// (attributes.cu); an instantiation that does not exist is
// cudaErrorInvalidValue.
cudaError_t tttp_attributes(int np, int per_thread, int threads,
                            long long smem, int* out) {
  const void* fn = nullptr;
  switch (np) {
    case 1: fn = tttp_entry<1>(per_thread); break;
    case 2: fn = tttp_entry<2>(per_thread); break;
    case 3: fn = tttp_entry<3>(per_thread); break;
    case 4: fn = tttp_entry<4>(per_thread); break;
    case 5: fn = tttp_entry<5>(per_thread); break;
    case 6: fn = tttp_entry<6>(per_thread); break;
    case 7: fn = tttp_entry<7>(per_thread); break;
    case 8: fn = tttp_entry<8>(per_thread); break;
    default: break;
  }
  return func_attributes(fn, threads, smem, out);
}
