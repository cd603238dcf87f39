// What the card says of one kernel instantiation, for the footprint model's
// check (kernels/footprint.py, chip_smoke.py phase 10a).
#include "common.cuh"

// Defined beside each kernel (tttp.cu, mttkrp.cu, cg_matvec.cu).
cudaError_t tttp_attributes(int np, int per_thread, int threads,
                            long long smem, int* out);
cudaError_t mttkrp_attributes(int rmax, int per_thread, int threads,
                              long long smem, int* out);
cudaError_t cg_matvec_attributes(int rmax, int per_thread, int threads,
                                 long long smem, int* out);

// family 0: tttp_kernel<variant, per_thread> (variant = NP, the present
// factors); 1: bucket_rows_kernel<variant, false, per_thread> (the MTTKRP,
// variant = RMAX); 2: bucket_rows_kernel<variant, true, per_thread> (the
// fused matvec). Writes numRegs, localSizeBytes, sharedSizeBytes and
// maxThreadsPerBlock of cudaFuncGetAttributes, and the CTAs of `threads`
// threads and `smem` bytes of dynamic shared memory one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into out[0..4].
extern "C" int repro_kernel_attributes(int family, int variant,
                                       int per_thread, int threads,
                                       long long smem, int* out) {
  switch (family) {
    case 0: return tttp_attributes(variant, per_thread, threads, smem, out);
    case 1: return mttkrp_attributes(variant, per_thread, threads, smem, out);
    case 2:
      return cg_matvec_attributes(variant, per_thread, threads, smem, out);
    default: return cudaErrorInvalidValue;
  }
}
