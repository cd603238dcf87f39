// Shared definitions of the port's CUDA kernels (sm_90a).
//
// Factor matrices travel to a kernel as a table of device pointers passed by
// value in the launch parameters: the host launchers receive a host array of
// nd pointers (NULL for an absent factor) and copy it into a FactorTable, so
// a launch needs no device allocation and no copy.
#pragma once

#include <cuda_runtime.h>

constexpr int MAX_ND = 8;             // tensor order the kernels accept
constexpr long long MAX_GRID = 1 << 20;
// threads per CTA the kernels are compiled for (__launch_bounds__); a
// launch takes any multiple of 32 up to this (KernelTile.threads in
// kernels/tile.py)
constexpr int MAX_THREADS = 256;

// The per-thread depths (the bucketed body's SLOTS, TTTP's NZ) every kernel
// is instantiated for: kernels/tile.py PER_THREAD_DEPTHS.
inline bool valid_depth(int d) { return d == 1 || d == 2 || d == 4; }

struct FactorTable {
  const float* p[MAX_ND];  // (I_d, R) row-major, or nullptr
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

inline FactorTable make_factor_table(void* const* ptrs, int nd) {
  FactorTable t;
  for (int d = 0; d < MAX_ND; ++d) {
    t.p[d] = d < nd ? static_cast<const float*>(ptrs[d]) : nullptr;
  }
  return t;
}

// What cudaFuncGetAttributes and the occupancy calculator say of the kernel
// `fn` launched with `threads` threads and `smem` bytes of dynamic shared
// memory, into out[0..4]: numRegs, localSizeBytes, sharedSizeBytes (static),
// maxThreadsPerBlock, and the CTAs of that launch one SM holds at once.
inline cudaError_t func_attributes(const void* fn, int threads, long long smem,
                                   int* out) {
  if (fn == nullptr || threads < 1 || smem < 0) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fn, threads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = blocks;
  return cudaSuccess;
}
