// TTTP on the card, float inputs summed in double: the entry point of
// tttp_kernel<NP, NZ, float, double> (tttp.cuh), which replaces
// src/repro/kernels/tttp.py:tttp_pallas under the reference's
// KernelTile(accum_dtype="float64") on float32 operands. Values and factor rows
// are read as float (a row padded to 4 floats, 16 bytes), the Hadamard chain is
// taken in float, each product column is cast to double before the sum over R,
// values[n] times that sum is double, and the output is rounded once to float.
// Its own source, so nvcc compiles it beside the other instantiations.
#include "tttp.cuh"

extern "C" int repro_tttp_f32_acc64(const void* values, const void* indices,
                                    const void* valid, long long m, int nd,
                                    void** factors, int R, int RS, void* out,
                                    int threads, int per_thread,
                                    void* stream) {
  return launch_tttp<float, double>(values, indices, valid, m, nd, factors, R,
                                  RS, out, threads, per_thread, stream);
}

// tttp_kernel<np, per_thread, float, double>'s attributes, for
// repro_kernel_attributes (attributes.cu).
cudaError_t tttp_attributes_f32_acc64(int np, int per_thread, int threads,
                                      long long smem, int* out) {
  return tttp_attributes_of<float, double>(np, per_thread, threads, smem,
                                         out);
}
