// Bucketed MTTKRP on the card, bf16 inputs summed in double: the entry point of
// bucket_rows_kernel<RMAX, false, SLOTS, __nv_bfloat16, double>
// (bucket_rows.cuh), which replaces src/repro/kernels/mttkrp.py:mttkrp_pallas
// under the reference's KernelTile(accum_dtype="float64") on bfloat16 operands
// (mttkrp.cu has the float entry and the kernel's notes). Rows are read as
// bf16, padded to 8 bf16 values (16 bytes); the product of a slot's factor rows
// and its value is taken in float and cast to double before it is summed; the
// running sums and the warps' shared slabs are double, and the output is
// rounded once to bf16. Its own source, so nvcc compiles it beside the other
// instantiations.
#include "bucket_rows.cuh"

extern "C" int repro_mttkrp_bucketed_bf16_acc64(
    const void* values, const void* indices, const void* local_row,
    const void* valid, long long nb, long long C, int nd, int mode,
    void** factors, const void* x, long long x_rows, int R, int RS,
    int block_rows, void* out, int threads, int per_thread, void* stream) {
  return launch_bucket_rows<false, __nv_bfloat16, double>(
      values, indices, local_row, valid, nb, C, nd, mode, factors, x, x_rows,
      R, RS, block_rows, out, threads, per_thread, stream);
}

// bucket_rows_kernel<rmax, false, per_thread, __nv_bfloat16, double>'s
// attributes, for repro_kernel_attributes (attributes.cu).
cudaError_t mttkrp_attributes_bf16_acc64(int rmax, int per_thread,
                                         int threads, long long smem,
                                         int* out) {
  return bucket_rows_attributes<false, __nv_bfloat16, double>(rmax, per_thread,
                                                       threads, smem, out);
}
