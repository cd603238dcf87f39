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
// threads per CTA the bucketed kernels are compiled for (__launch_bounds__);
// kernels/_build.py THREADS launches them with this many
constexpr int MAX_THREADS = 256;

struct FactorTable {
  const float* p[MAX_ND];  // (I_d, R) row-major, or nullptr
};

inline FactorTable make_factor_table(void* const* ptrs, int nd) {
  FactorTable t;
  for (int d = 0; d < MAX_ND; ++d) {
    t.p[d] = d < nd ? static_cast<const float*>(ptrs[d]) : nullptr;
  }
  return t;
}
