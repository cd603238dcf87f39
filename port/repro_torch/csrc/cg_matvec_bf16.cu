// The fused implicit-CG Gram matvec on the card, bf16 inputs: the entry
// point of bucket_rows_kernel<RMAX, true, SLOTS, __nv_bfloat16>
// (bucket_rows.cuh), which replaces src/repro/kernels/cg_matvec.py:
// cg_matvec_pallas on bf16 operands (cg_matvec.cu has the float entry and
// the kernel's notes). Values, factor rows and x are read as bf16, rows
// padded to a multiple of 8 values (16 bytes); the sums are float in
// registers and shared memory, and the output is written in bf16. Its own
// source, so nvcc compiles it beside the float instantiations.
#include "bucket_rows.cuh"

extern "C" int repro_cg_matvec_bucketed_bf16(
    const void* omega, const void* indices, const void* local_row,
    const void* valid, long long nb, long long C, int nd, int mode,
    void** factors, const void* x, long long x_rows, int R, int RS,
    int block_rows, void* out, int threads, int per_thread, void* stream) {
  return launch_bucket_rows<true, __nv_bfloat16>(
      omega, indices, local_row, valid, nb, C, nd, mode, factors, x, x_rows,
      R, RS, block_rows, out, threads, per_thread, stream);
}

// bucket_rows_kernel<rmax, true, per_thread, __nv_bfloat16>'s attributes,
// for repro_kernel_attributes (attributes.cu).
cudaError_t cg_matvec_attributes_bf16(int rmax, int per_thread, int threads,
                                     long long smem, int* out) {
  return bucket_rows_attributes<true, __nv_bfloat16>(rmax, per_thread,
                                                     threads, smem, out);
}
