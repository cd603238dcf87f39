// Fused implicit-CG Gram matvec on the card (paper eq. 3, one pass):
//   KR[n]   = prod_{d != mode} A_d[idx[n,d], :]
//   z[n]    = w[n] * sum_s KR[n,s] * x[idx[n,mode], s]
//   Y[i, :] = sum_{n: idx[n,mode] = i} z[n] * KR[n, :]
// over the CCSR row-block buckets of the Omega pattern (w = bucket values).
//
// Replaces src/repro/kernels/cg_matvec.py:cg_matvec_pallas (body
// _cg_matvec_kernel).
//
// What bounds it: bytes. Each bucket slot is read once: w (4 B), nd int32
// indices, local_row (4 B) and valid (1 B), 21 B at nd = 3, and the output
// rows are written once: about 1.7 GB at the main path's 81 M slots, 0.5 ms
// at 3.35 TB/s. The nd - 1 factor rows a slot gathers come from L2, two
// 32-byte sectors each, about 10 GB of L2 sector traffic per call at that
// size; that traffic, not HBM, is what the kernel works against.
//
// What the design does about it: the body shared with the bucketed MTTKRP,
// bucket_rows.cuh with FUSED = true. KR[n] is formed once per slot in
// registers and feeds both the z dot product and the scatter, so the (m, R)
// intermediate of the two-kernel composition never exists. The factor rows
// are gathered as 16-byte loads from copies padded to a 16-byte row stride;
// the bucket's block_rows rows of x are loaded into shared memory once per
// CTA, not gathered per slot; two slots per thread per step keep loads in
// flight; per-thread running sums reach the CTA's shared output rows only
// when a thread's row changes (scatter_rows.cuh). No global atomics.
#include "bucket_rows.cuh"

extern "C" int repro_cg_matvec_bucketed_f32(
    const void* omega, const void* indices, const void* local_row,
    const void* valid, long long nb, long long C, int nd, int mode,
    void** factors, const void* x, long long x_rows, int R, int RS,
    int block_rows, void* out, int threads, void* stream) {
  return launch_bucket_rows<true>(omega, indices, local_row, valid, nb, C, nd,
                                  mode, factors, x, x_rows, R, RS, block_rows,
                                  out, threads, stream);
}
