// Bucketed MTTKRP on the card:
//   Y[i, :] = sum_{n: idx[n,mode] = i} v[n] * prod_{d != mode} A_d[idx[n,d], :]
// over CCSR row-block buckets (repro_torch/sparse/ccsr.py).
//
// Replaces src/repro/kernels/mttkrp.py:mttkrp_pallas (body _mttkrp_kernel),
// on float operands here and on bf16 ones in mttkrp_bf16.cu.
//
// What bounds it: bytes. Each bucket slot is read once: its value (4 B),
// nd int32 indices, local_row (4 B) and valid (1 B), 21 B at nd = 3, and
// the output rows are written once: about 1.7 GB at the main path's 81 M
// slots, 0.5 ms at 3.35 TB/s. The arithmetic, R * (nd - 1) multiplies and
// R adds per slot, is far below the fp32 rate. The factor rows it gathers
// come from L2 (a factor of 20000 rows of 12 floats is 1 MB): two 32-byte
// sectors per row and nd - 1 rows per slot, about 10 GB of L2 sector traffic
// per call at the main path's size, six times the HBM bytes above, and that
// traffic, not HBM, is what the kernel works against.
//
// What the design does about it: the body shared with the fused matvec,
// bucket_rows.cuh with FUSED = false (z[n] = v[n], no dot product). One CTA
// per bucket, shared-memory output rows, no global atomics; row gathers as
// 16-byte loads from factors padded to a 16-byte row stride; the tile's
// slots per thread per step (two by default) for loads in flight;
// per-thread running sums flushed to the warp's shared slab of the rows
// only when a thread's row changes, the slabs summed in warp order at the
// end, so the output is the same every run (scatter_rows.cuh).
#include "bucket_rows.cuh"

extern "C" int repro_mttkrp_bucketed_f32(
    const void* values, const void* indices, const void* local_row,
    const void* valid, long long nb, long long C, int nd, int mode,
    void** factors, const void* x, long long x_rows, int R, int RS,
    int block_rows, void* out, int threads, int per_thread, void* stream) {
  return launch_bucket_rows<false, float>(
      values, indices, local_row, valid, nb, C, nd, mode, factors, x, x_rows,
      R, RS, block_rows, out, threads, per_thread, stream);
}

// bucket_rows_kernel<rmax, false, per_thread, float>'s attributes, for
// repro_kernel_attributes (attributes.cu).
cudaError_t mttkrp_attributes_f32(int rmax, int per_thread, int threads,
                                 long long smem, int* out) {
  return bucket_rows_attributes<false, float>(rmax, per_thread, threads,
                                            smem, out);
}
