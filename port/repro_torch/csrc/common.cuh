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
// threads per CTA the kernels are compiled for (__launch_bounds__);
// kernels/_build.py THREADS launches them with this many
constexpr int MAX_THREADS = 256;

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
