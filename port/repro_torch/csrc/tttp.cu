// TTTP on the card, float inputs: the entry point of tttp_kernel<NP, NZ,
// float> (tttp.cuh), which replaces src/repro/kernels/tttp.py:tttp_pallas.
#include "tttp.cuh"

extern "C" int repro_tttp_f32(const void* values, const void* indices,
                              const void* valid, long long m, int nd,
                              void** factors, int R, int RS, void* out,
                              int threads, int per_thread, void* stream) {
  return launch_tttp<float>(values, indices, valid, m, nd, factors, R, RS,
                            out, threads, per_thread, stream);
}

// tttp_kernel<np, per_thread, float>'s attributes, for
// repro_kernel_attributes (attributes.cu).
cudaError_t tttp_attributes_f32(int np, int per_thread, int threads,
                                long long smem, int* out) {
  return tttp_attributes_of<float>(np, per_thread, threads, smem, out);
}
