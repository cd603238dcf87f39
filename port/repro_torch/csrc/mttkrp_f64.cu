// Bucketed MTTKRP on the card, double inputs: the entry point of
// bucket_rows_kernel<RMAX, false, SLOTS, double> (bucket_rows.cuh), which
// replaces src/repro/kernels/mttkrp.py:mttkrp_pallas on float64 operands
// (mttkrp.cu has the float entry and the kernel's notes). Values and factor
// rows are read as double, rows padded to a multiple of 2 values (16
// bytes); the sums are double in registers and in the warps' shared slabs
// (scatter_rows.cuh), and the output is written in double.
// Its own source, so nvcc compiles it beside the other instantiations.
#include "bucket_rows.cuh"

extern "C" int repro_mttkrp_bucketed_f64(
    const void* values, const void* indices, const void* local_row,
    const void* valid, long long nb, long long C, int nd, int mode,
    void** factors, const void* x, long long x_rows, int R, int RS,
    int block_rows, void* out, int threads, int per_thread, void* stream) {
  return launch_bucket_rows<false, double>(
      values, indices, local_row, valid, nb, C, nd, mode, factors, x, x_rows,
      R, RS, block_rows, out, threads, per_thread, stream);
}

// bucket_rows_kernel<rmax, false, per_thread, double>'s attributes, for
// repro_kernel_attributes (attributes.cu).
cudaError_t mttkrp_attributes_f64(int rmax, int per_thread, int threads,
                                  long long smem, int* out) {
  return bucket_rows_attributes<false, double>(rmax, per_thread, threads,
                                               smem, out);
}
