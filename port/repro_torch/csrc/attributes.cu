// What the card says of one kernel instantiation, for the footprint model's
// check (kernels/footprint.py, chip_smoke.py phase 10a).
#include "common.cuh"

// Defined beside each kernel: tttp.cu, mttkrp.cu, cg_matvec.cu (float) and
// their *_bf16.cu twins (__nv_bfloat16).
cudaError_t tttp_attributes_f32(int np, int per_thread, int threads,
                                long long smem, int* out);
cudaError_t tttp_attributes_bf16(int np, int per_thread, int threads,
                                 long long smem, int* out);
cudaError_t mttkrp_attributes_f32(int rmax, int per_thread, int threads,
                                  long long smem, int* out);
cudaError_t mttkrp_attributes_bf16(int rmax, int per_thread, int threads,
                                   long long smem, int* out);
cudaError_t cg_matvec_attributes_f32(int rmax, int per_thread, int threads,
                                     long long smem, int* out);
cudaError_t cg_matvec_attributes_bf16(int rmax, int per_thread, int threads,
                                      long long smem, int* out);

// family 0: tttp_kernel<variant, per_thread, T> (variant = NP, the present
// factors); 1: bucket_rows_kernel<variant, false, per_thread, T> (the
// MTTKRP, variant = RMAX); 2: bucket_rows_kernel<variant, true, per_thread,
// T> (the fused matvec). dtype 0: T = float, 1: T = __nv_bfloat16. Writes
// numRegs, localSizeBytes, sharedSizeBytes and maxThreadsPerBlock of
// cudaFuncGetAttributes, and the CTAs of `threads` threads and `smem` bytes
// of dynamic shared memory one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into out[0..4].
extern "C" int repro_kernel_attributes(int family, int variant,
                                       int per_thread, int threads,
                                       long long smem, int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  switch (family) {
    case 0:
      return bf16 ? tttp_attributes_bf16(variant, per_thread, threads, smem,
                                         out)
                  : tttp_attributes_f32(variant, per_thread, threads, smem,
                                        out);
    case 1:
      return bf16 ? mttkrp_attributes_bf16(variant, per_thread, threads, smem,
                                           out)
                  : mttkrp_attributes_f32(variant, per_thread, threads, smem,
                                          out);
    case 2:
      return bf16 ? cg_matvec_attributes_bf16(variant, per_thread, threads,
                                              smem, out)
                  : cg_matvec_attributes_f32(variant, per_thread, threads,
                                             smem, out);
    default: return cudaErrorInvalidValue;
  }
}
