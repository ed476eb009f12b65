// Batched planar complex matmul: C[q] = A[q] @ B[q].
//
// Replaces the TPU kernel kernels/cmatmul.py::bcmatmul in the JAX package
// (the per-request decode apply of the service's stage route: every
// request carries its own (m, N) scatter decode matrix, applied to its
// (N, L) worker spectra).
//
// What bounds it on the H100: bytes.  Per payload column the kernel reads
// K complex values and writes M, doing M*K complex MACs -- with M = m and
// K = N that is 8*m*N flops per 8*(m + N) bytes, about 2 flops/byte for
// the service's (4, 8) code, far under the card's ~20 flops/byte FP32
// balance point.  So the design streams B and C exactly once with
// coalesced accesses (one thread per payload column, consecutive threads
// on consecutive addresses) and keeps the small left matrix in shared
// memory, where every warp reads it by broadcast.

#include "common.cuh"

extern "C" int bcmatmul_f32(const float* ar, const float* ai, long long sa,
                            const float* br, const float* bi, float* cr,
                            float* ci, int q, int M, int K, long long L,
                            void* stream) {
  return launch_bcmatmul(ar, ai, sa, br, bi, cr, ci, q, M, K, L,
                         (cudaStream_t)stream);
}
