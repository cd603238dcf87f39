// TTTP on the card, bf16 inputs: the entry point of tttp_kernel<NP, NZ,
// __nv_bfloat16> (tttp.cuh), which replaces src/repro/kernels/tttp.py:
// tttp_pallas on bf16 operands. Values and factor rows are read as bf16 (a
// factor row padded to a multiple of 8 values, 16 bytes), the products and
// the sum over R are taken in float, and the output is written in bf16.
// Its own source, so nvcc compiles it beside the float instantiations.
#include "tttp.cuh"

extern "C" int repro_tttp_bf16(const void* values, const void* indices,
                               const void* valid, long long m, int nd,
                               void** factors, int R, int RS, void* out,
                               int threads, int per_thread, void* stream) {
  return launch_tttp<__nv_bfloat16>(values, indices, valid, m, nd, factors,
                                    R, RS, out, threads, per_thread, stream);
}

// tttp_kernel<np, per_thread, __nv_bfloat16>'s attributes, for
// repro_kernel_attributes (attributes.cu).
cudaError_t tttp_attributes_bf16(int np, int per_thread, int threads,
                                 long long smem, int* out) {
  return tttp_attributes_of<__nv_bfloat16>(np, per_thread, threads, smem,
                                           out);
}
