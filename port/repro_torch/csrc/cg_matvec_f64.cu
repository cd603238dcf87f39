// The fused implicit-CG Gram matvec on the card, double inputs: the entry
// point of bucket_rows_kernel<RMAX, true, SLOTS, double> (bucket_rows.cuh),
// which replaces src/repro/kernels/cg_matvec.py:cg_matvec_pallas on float64
// operands (cg_matvec.cu has the float entry and the kernel's notes).
// Values, factor rows and x are read as double, rows padded to a multiple
// of 2 values (16 bytes); x's rows, the sums and the shared accumulator are
// double, and the output is written in double. Its own source, so nvcc
// compiles it beside the other instantiations.
#include "bucket_rows.cuh"

extern "C" int repro_cg_matvec_bucketed_f64(
    const void* omega, const void* indices, const void* local_row,
    const void* valid, long long nb, long long C, int nd, int mode,
    void** factors, const void* x, long long x_rows, int R, int RS,
    int block_rows, void* out, int threads, int per_thread, void* stream) {
  return launch_bucket_rows<true, double>(
      omega, indices, local_row, valid, nb, C, nd, mode, factors, x, x_rows,
      R, RS, block_rows, out, threads, per_thread, stream);
}

// bucket_rows_kernel<rmax, true, per_thread, double>'s attributes, for
// repro_kernel_attributes (attributes.cu).
cudaError_t cg_matvec_attributes_f64(int rmax, int per_thread, int threads,
                                     long long smem, int* out) {
  return bucket_rows_attributes<true, double>(rmax, per_thread, threads,
                                              smem, out);
}
