// TTTP on the card, double inputs: the entry point of tttp_kernel<NP, NZ,
// double> (tttp.cuh), which replaces src/repro/kernels/tttp.py:tttp_pallas
// on float64 operands (the reference's float64 accumulator). Values and
// factor rows are read as double (a factor row padded to a multiple of 2
// values, 16 bytes), the products and the sum over R are taken in double,
// and the output is written in double. Its own source, so nvcc compiles it
// beside the float and bf16 instantiations.
#include "tttp.cuh"

extern "C" int repro_tttp_f64(const void* values, const void* indices,
                              const void* valid, long long m, int nd,
                              void** factors, int R, int RS, void* out,
                              int threads, int per_thread, void* stream) {
  return launch_tttp<double>(values, indices, valid, m, nd, factors, R, RS,
                             out, threads, per_thread, stream);
}

// tttp_kernel<np, per_thread, double>'s attributes, for
// repro_kernel_attributes (attributes.cu).
cudaError_t tttp_attributes_f64(int np, int per_thread, int threads,
                                long long smem, int* out) {
  return tttp_attributes_of<double>(np, per_thread, threads, smem, out);
}
