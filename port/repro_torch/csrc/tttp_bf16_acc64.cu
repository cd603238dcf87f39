// TTTP on the card, bf16 inputs summed in double: the entry point of
// tttp_kernel<NP, NZ, __nv_bfloat16, double> (tttp.cuh), which replaces
// src/repro/kernels/tttp.py:tttp_pallas under the reference's
// KernelTile(accum_dtype="float64") on bfloat16 operands. Values and factor
// rows are read as bf16 (a row padded to 8 bf16 values, 16 bytes), the Hadamard
// chain is taken in float, each product column is cast to double before the sum
// over R, values[n] times that sum is double, and the output is rounded once to
// bf16. Its own source, so nvcc compiles it beside the other instantiations.
#include "tttp.cuh"

extern "C" int repro_tttp_bf16_acc64(const void* values,
                                     const void* indices, const void* valid,
                                     long long m, int nd, void** factors,
                                     int R, int RS, void* out, int threads,
                                     int per_thread, void* stream) {
  return launch_tttp<__nv_bfloat16, double>(values, indices, valid, m, nd,
                                            factors, R, RS, out, threads,
                                            per_thread, stream);
}

// tttp_kernel<np, per_thread, __nv_bfloat16, double>'s attributes, for
// repro_kernel_attributes (attributes.cu).
cudaError_t tttp_attributes_bf16_acc64(int np, int per_thread,
                                       int threads, long long smem,
                                       int* out) {
  return tttp_attributes_of<__nv_bfloat16, double>(np, per_thread, threads,
                                                   smem, out);
}
