// What the card says of one kernel instantiation, for the footprint model's
// check (kernels/footprint.py, chip_smoke.py phase 10a).
#include "common.cuh"

// Defined beside each kernel: tttp.cu, mttkrp.cu, cg_matvec.cu (float) and
// their *_bf16.cu (__nv_bfloat16), *_f64.cu (double), *_f32_acc64.cu (float
// summed in double) and *_bf16_acc64.cu (__nv_bfloat16 summed in double)
// twins.
cudaError_t tttp_attributes_f32(int np, int per_thread, int threads,
                                long long smem, int* out);
cudaError_t tttp_attributes_bf16(int np, int per_thread, int threads,
                                 long long smem, int* out);
cudaError_t tttp_attributes_f64(int np, int per_thread, int threads,
                                long long smem, int* out);
cudaError_t mttkrp_attributes_f32(int rmax, int per_thread, int threads,
                                  long long smem, int* out);
cudaError_t mttkrp_attributes_bf16(int rmax, int per_thread, int threads,
                                   long long smem, int* out);
cudaError_t mttkrp_attributes_f64(int rmax, int per_thread, int threads,
                                  long long smem, int* out);
cudaError_t cg_matvec_attributes_f32(int rmax, int per_thread, int threads,
                                     long long smem, int* out);
cudaError_t cg_matvec_attributes_bf16(int rmax, int per_thread, int threads,
                                      long long smem, int* out);
cudaError_t cg_matvec_attributes_f64(int rmax, int per_thread, int threads,
                                     long long smem, int* out);
cudaError_t tttp_attributes_f32_acc64(int np, int per_thread, int threads,
                                      long long smem, int* out);
cudaError_t tttp_attributes_bf16_acc64(int np, int per_thread, int threads,
                                       long long smem, int* out);
cudaError_t mttkrp_attributes_f32_acc64(int rmax, int per_thread,
                                        int threads, long long smem,
                                        int* out);
cudaError_t mttkrp_attributes_bf16_acc64(int rmax, int per_thread,
                                         int threads, long long smem,
                                         int* out);
cudaError_t cg_matvec_attributes_f32_acc64(int rmax, int per_thread,
                                           int threads, long long smem,
                                           int* out);
cudaError_t cg_matvec_attributes_bf16_acc64(int rmax, int per_thread,
                                            int threads, long long smem,
                                            int* out);

// family 0: tttp_kernel<variant, per_thread, T> (variant = NP, the present
// factors); 1: bucket_rows_kernel<variant, false, per_thread, T> (the
// MTTKRP, variant = RMAX); 2: bucket_rows_kernel<variant, true, per_thread,
// T> (the fused matvec). dtype 0: T = float, 1: T = __nv_bfloat16, 2: T =
// double, each in its own accumulator; 3: T = float and 4: T =
// __nv_bfloat16 summed in double. Writes numRegs, localSizeBytes, sharedSizeBytes and
// maxThreadsPerBlock of cudaFuncGetAttributes, and the CTAs of `threads`
// threads and `smem` bytes of dynamic shared memory one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into out[0..4].
extern "C" int repro_kernel_attributes(int family, int variant,
                                       int per_thread, int threads,
                                       long long smem, int dtype, int* out) {
  using Fn = cudaError_t (*)(int, int, int, long long, int*);
  // [family][dtype]
  static const Fn table[3][5] = {
      {tttp_attributes_f32, tttp_attributes_bf16, tttp_attributes_f64,
       tttp_attributes_f32_acc64, tttp_attributes_bf16_acc64},
      {mttkrp_attributes_f32, mttkrp_attributes_bf16, mttkrp_attributes_f64,
       mttkrp_attributes_f32_acc64, mttkrp_attributes_bf16_acc64},
      {cg_matvec_attributes_f32, cg_matvec_attributes_bf16,
       cg_matvec_attributes_f64, cg_matvec_attributes_f32_acc64,
       cg_matvec_attributes_bf16_acc64}};
  if (family < 0 || family > 2 || dtype < 0 || dtype > 4) {
    return cudaErrorInvalidValue;
  }
  return table[family][dtype](variant, per_thread, threads, smem, out);
}
