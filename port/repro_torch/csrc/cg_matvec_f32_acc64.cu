// The fused implicit-CG Gram matvec on the card, float inputs summed in double:
// the entry point of bucket_rows_kernel<RMAX, true, SLOTS, float, double>
// (bucket_rows.cuh), which replaces
// src/repro/kernels/cg_matvec.py:cg_matvec_pallas under the reference's
// KernelTile(accum_dtype="float64") on float32 operands (cg_matvec.cu has the
// float entry and the kernel's notes). Rows are read as float, padded to 4
// floats (16 bytes); KR and kr * x are taken in float, each product kr * x is
// cast to double before the dot sums it, and z = w * dot and z * KR are double;
// the running sums and the warps' shared slabs are double, and the output is
// rounded once to float. Its own source, so nvcc compiles it beside the other
// instantiations.
#include "bucket_rows.cuh"

extern "C" int repro_cg_matvec_bucketed_f32_acc64(
    const void* omega, const void* indices, const void* local_row,
    const void* valid, long long nb, long long C, int nd, int mode,
    void** factors, const void* x, long long x_rows, int R, int RS,
    int block_rows, void* out, int threads, int per_thread, void* stream) {
  return launch_bucket_rows<true, float, double>(
      omega, indices, local_row, valid, nb, C, nd, mode, factors, x, x_rows,
      R, RS, block_rows, out, threads, per_thread, stream);
}

// bucket_rows_kernel<rmax, true, per_thread, float, double>'s
// attributes, for repro_kernel_attributes (attributes.cu).
cudaError_t cg_matvec_attributes_f32_acc64(int rmax, int per_thread,
                                         int threads, long long smem,
                                         int* out) {
  return bucket_rows_attributes<true, float, double>(rmax, per_thread,
                                                       threads, smem, out);
}
