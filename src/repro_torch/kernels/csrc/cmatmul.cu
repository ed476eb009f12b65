// Planar complex matmul C = A @ B: a small (M, K) code matrix against a
// wide (K, L) payload.
//
// Replaces the TPU kernel kernels/cmatmul.py::cmatmul in the JAX package:
// the plan's mds_apply, which runs the MDS encode (G, (N, m), against the
// m message shards with the whole batch folded into the payload columns)
// and the unbatched decode (inv(G[subset]), (m, m), against the m
// responder rows).
//
// What bounds it on the H100: bytes.  Per payload column it reads K
// complex values and writes M, doing M*K complex MACs: 8*M*K flops per
// 8*(M + K) bytes, under 3 flops/byte for the (8, 4) encode, far below
// the card's ~20 flops/byte FP32 balance point.  The 2^20-point plan's
// encode of 16 requests reads 128 MiB and writes 256 MiB, about 0.12 ms
// at 3.35 TB/s.  Design: the batched kernel of common.cuh with a batch
// of one -- the left matrix sits in shared memory, read by broadcast,
// each thread owns one payload column and streams its K inputs once per
// block of 8 output rows, consecutive threads on consecutive addresses,
// and the grid tiles L in blocks of 256 columns with 64-bit offsets (L
// reaches 2^22 in that encode).

#include "common.cuh"

// a: (m, k) planes; b: (k, l); c: (m, l).  One launch.
extern "C" int cmatmul_f32(const float* ar, const float* ai, const float* br,
                           const float* bi, float* cr, float* ci, int M,
                           int K, long long L, void* stream) {
  return launch_bcmatmul(ar, ai, 0, br, bi, cr, ci, 1, M, K, L,
                         (cudaStream_t)stream);
}
