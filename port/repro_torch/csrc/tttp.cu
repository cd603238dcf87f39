// TTTP on the card: out[n] = values[n] * sum_r prod_{d present} A_d[idx[n,d], r]
//
// Replaces src/repro/kernels/tttp.py:tttp_pallas (body _tttp_kernel).
//
// What bounds it: bytes. Per nonzero it reads one float value and nd int32
// indices and writes one float, (8 + 4*nd) bytes of HBM traffic, against
// R*n_present multiply-adds. The gathered factor rows (R floats per present
// mode) come from L2 while the factors fit there: at the main path's size a
// factor is 20000 x 10 floats, 800 kB, and L2 holds 50 MB.
//
// What the design does about it: one thread per nonzero in a grid-stride
// loop, so a warp's value, index and output accesses are contiguous and
// coalesced; factor rows are gathered straight from global memory (Hopper
// has no VMEM residency to preserve, so the TPU kernel's R-tiled grid and
// resident factor slices are gone); the Hadamard product and the R-sum stay
// in registers; no shared memory and no atomics, so the result does not
// depend on scheduling. Offsets are 64-bit.
#include "common.cuh"

namespace {

__global__ void tttp_kernel(const float* __restrict__ values,
                            const int* __restrict__ indices, long long m,
                            int nd, FactorTable f, int R,
                            float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long n = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       n < m; n += stride) {
    long long row[MAX_ND];
#pragma unroll
    for (int d = 0; d < MAX_ND; ++d) {
      row[d] = d < nd ? static_cast<long long>(indices[n * nd + d]) * R : 0;
    }
    float acc = 0.f;
    for (int r = 0; r < R; ++r) {
      float p = 1.f;
#pragma unroll
      for (int d = 0; d < MAX_ND; ++d) {
        if (d < nd && f.p[d] != nullptr) p *= f.p[d][row[d] + r];
      }
      acc += p;
    }
    out[n] = values[n] * acc;
  }
}

}  // namespace

extern "C" int repro_tttp_f32(const void* values, const void* indices,
                              long long m, int nd, void** factors, int R,
                              void* out, int threads, void* stream) {
  if (nd < 1 || nd > MAX_ND || threads < 32) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  long long blocks = (m + threads - 1) / threads;
  if (blocks > MAX_GRID) blocks = MAX_GRID;
  tttp_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int*>(indices), m,
      nd, make_factor_table(factors, nd), R, static_cast<float*>(out));
  return cudaGetLastError();
}
