// Shared definitions of the port's CUDA kernels (sm_90a).
//
// Factor matrices travel to a kernel as a table of device pointers passed by
// value in the launch parameters: the host launchers receive a host array of
// nd pointers (NULL for an absent factor) and copy it into a FactorTable, so
// a launch needs no device allocation and no copy.
//
// Element types and accumulators: every kernel is instantiated for float,
// __nv_bfloat16 and double inputs (the T of its template), each summed in its
// own accumulator, and float and bf16 inputs also in a double accumulator
// (the S of its template). A kernel reads T from device memory and converts
// it in registers to its compute type C = Acc<T>::type: float for float and
// bf16 (the intrinsics for bf16), double for double. The Hadamard chain of
// factor rows, and kr * x in the fused matvec, run in C. With S = C (the
// default) every sum runs in C too. With S = double over float or bf16
// inputs each product is cast to double before it is summed, and the dot
// products, the running row sums and the shared accumulator are double: the
// reference's KernelTile(accum_dtype="float64"), whose Pallas kernels cast
// before each sum. Either way the output is written as T. Rows of every type
// are read as 16-byte vectors: 4 floats, 8 bf16 values or 2 doubles per load
// (Elem<T>::VEC), so a row's padded stride RS is a multiple of VEC.
#pragma once

#include <cuda_bf16.h>
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

template <typename T>
struct FactorTable {
  const T* p[MAX_ND];  // (I_d, RS) row-major, or nullptr
};

// Columns of one 16-byte vector load of a row of T.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int VEC = 4;
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
};
template <>
struct Elem<double> {
  static constexpr int VEC = 2;
};

// The compute type of T (`type`), which is also its default accumulator, and
// the register vector the kernels multiply and sum rows in (`V`, W columns
// of `type`): a float4 for float and bf16 inputs, a double2, one 16-byte
// load, for double. Acc<S>::V is also the register vector of an accumulator
// S (float or double).
template <typename T>
struct Acc {
  using type = float;
  using V = float4;
  static constexpr int W = 4;
};
template <>
struct Acc<double> {
  using type = double;
  using V = double2;
  static constexpr int W = 2;
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ double2 operator*(double2 a, double2 b) {
  return make_double2(a.x * b.x, a.y * b.y);
}

// A register vector with every column `a`.
__device__ __forceinline__ float4 splat(float a) {
  return make_float4(a, a, a, a);
}
__device__ __forceinline__ double2 splat(double a) {
  return make_double2(a, a);
}

// acc + s * a, column by column.
__device__ __forceinline__ float4 fma_v(float s, float4 a, float4 acc) {
  return make_float4(fmaf(s, a.x, acc.x), fmaf(s, a.y, acc.y),
                     fmaf(s, a.z, acc.z), fmaf(s, a.w, acc.w));
}
__device__ __forceinline__ double2 fma_v(double s, double2 a, double2 acc) {
  return make_double2(fma(s, a.x, acc.x), fma(s, a.y, acc.y));
}

// dot + <a, b>, the columns added in order.
__device__ __forceinline__ float dot_v(float4 a, float4 b, float dot) {
  dot = fmaf(a.x, b.x, dot);
  dot = fmaf(a.y, b.y, dot);
  dot = fmaf(a.z, b.z, dot);
  return fmaf(a.w, b.w, dot);
}
__device__ __forceinline__ double dot_v(double2 a, double2 b, double dot) {
  dot = fma(a.x, b.x, dot);
  return fma(a.y, b.y, dot);
}

// v's columns as double2 vectors (lo: x, y; hi: z, w): a float vector of the
// compute type summed in a double accumulator.
__device__ __forceinline__ void widen(float4 v, double2& lo, double2& hi) {
  lo = make_double2(static_cast<double>(v.x), static_cast<double>(v.y));
  hi = make_double2(static_cast<double>(v.z), static_cast<double>(v.w));
}

__device__ __forceinline__ double2 add_v(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float4 add_v(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// dot + <a, b> in double over float vectors: each product rounded to float
// (the compute type), cast to double, then added in column order.
__device__ __forceinline__ double dot_wide(float4 a, float4 b, double dot) {
  dot += static_cast<double>(a.x * b.x);
  dot += static_cast<double>(a.y * b.y);
  dot += static_cast<double>(a.z * b.z);
  return dot + static_cast<double>(a.w * b.w);
}

// The sum of the first `left` columns of v (all of them when left >= W).
__device__ __forceinline__ float sum_first(float4 v, int left) {
  if (left < 4) v.w = 0.f;
  if (left < 3) v.z = 0.f;
  if (left < 2) v.y = 0.f;
  return (v.x + v.y) + (v.z + v.w);
}
__device__ __forceinline__ double sum_first(double2 v, int left) {
  if (left < 2) v.y = 0.0;
  return v.x + v.y;
}
// The same sum in a double accumulator over a float vector: each column cast
// to double before it is added.
__device__ __forceinline__ double sum_first_wide(float4 v, int left) {
  const double x = v.x, y = left > 1 ? v.y : 0.f, z = left > 2 ? v.z : 0.f;
  const double w = left > 3 ? v.w : 0.f;
  return (x + y) + (z + w);
}

template <typename T>
inline FactorTable<T> make_factor_table(void* const* ptrs, int nd) {
  FactorTable<T> t;
  for (int d = 0; d < MAX_ND; ++d) {
    t.p[d] = d < nd ? static_cast<const T*>(ptrs[d]) : nullptr;
  }
  return t;
}

// An element as its accumulator type (Acc<T>::type).
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double to_acc(double v) { return v; }

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_elem(double* p, double v) { *p = v; }
// A double accumulator's result written to a narrower output: rounded to
// float, then (bf16) to bf16, as torch converts a float64 tensor.
__device__ __forceinline__ void store_elem(float* p, double v) {
  *p = static_cast<float>(v);
}
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, double v) {
  *p = __float2bfloat16(static_cast<float>(v));
}

// The two bf16 values packed in a 32-bit word, as floats (the lower half
// holds the lower column).
__device__ __forceinline__ float2 bf16x2_to_float2(unsigned u) {
  return make_float2(
      __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u))),
      __bfloat162float(
          __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16))));
}

// The 16 bytes at p (16-byte aligned, read-only for the kernel's life) as
// register vectors (Acc<T>::V): one float4 for float, two for bf16, one
// double2 for double.
__device__ __forceinline__ void load_vec(const float* p, float4* v) {
  v[0] = __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float4* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const float2 a = bf16x2_to_float2(u.x), b = bf16x2_to_float2(u.y);
  const float2 c = bf16x2_to_float2(u.z), d = bf16x2_to_float2(u.w);
  v[0] = make_float4(a.x, a.y, b.x, b.y);
  v[1] = make_float4(c.x, c.y, d.x, d.y);
}
__device__ __forceinline__ void load_vec(const double* p, double2* v) {
  v[0] = __ldg(reinterpret_cast<const double2*>(p));
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
