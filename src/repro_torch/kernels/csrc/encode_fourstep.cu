// Fused MDS encode + four-step worker DFT of the message shards.
//
// Replaces the TPU kernel kernels/fourstep_fft.py::encode_fourstep_fused in
// the JAX package.  For every request q and message shard i (an A x B
// matrix M_i with M_i[a, b] = c_i[a*B + b]):
//
//   T1_i = (F_A @ M_i) * W        column pass: dense DFT over a + twiddle
//   Z_i  = T1_i @ F_B             row pass:    dense DFT over b
//   out[q, k] = sum_i G[k, i] Z_i  encode:     (N, m) generator across shards
//
// and out[q, k, c, d] holds the coded worker spectrum B_k[c + d*A] (the
// reference's scrambled four-step order).  Transforming the m message
// shards and encoding after (the DFT commutes with G) saves N/m of the
// DFT work, as in the reference.
//
// What bounds it on the H100: bytes.  The function needs an FFT of each
// shard (5*L*log2(L) flops) and the encode, against reading the m
// message shards and writing the N coded ones once; for the service's
// s = 2^20, m = 4 (A = B = 512) that is about 0.04 ms of FP32 work
// against 0.12 ms of traffic.  This first port does far more work: its
// two passes are dense DFTs, 8*A*B*(A + B) flops per shard, about 90x an
// FFT's, which makes them FP32 GEMMs.  Design: one register-tiled
// batched complex GEMM (64 x 64 output tile per block, 8-deep K slices
// staged in shared memory, a 4 x 4 complex tile of accumulators per
// thread, conflict-free strided column/row ownership), launched twice;
// the twiddle rides in the column pass's epilogue.  The encode is the
// bytes-bound bcmatmul kernel with G broadcast over the batch (stride
// 0).  Intermediates T1 and Z live in device memory (scratch the wrapper
// allocates): a simple first port, three launches per call.  A radix
// FFT over the A x B tile is the way to its bound.

#include "cgemm.cuh"

// c: (q, m, a, b) message planes; g: (n, m); fa: (a, a); w: (a, b);
// fb: (b, b); t1, z: (q, m, a, b) scratch; out: (q, n, a, b).
// Returns the first nonzero cudaGetLastError() of the three launches.
extern "C" int encode_fourstep_f32(
    const float* cr, const float* ci, const float* gr, const float* gi,
    const float* far, const float* fai, const float* wr, const float* wi,
    const float* fbr, const float* fbi, float* t1r, float* t1i, float* zr,
    float* zi, float* outr, float* outi, int q, int m, int n, int a, int b,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long ab = (long long)a * b;
  // column pass: T1_i = (F_A @ M_i) * W, batch over (q, i)
  int err = launch_cgemm(far, fai, 0, cr, ci, ab, wr, wi, t1r, t1i, q * m, a,
                         b, a, st);
  if (err != 0) return err;
  // row pass: Z_i = T1_i @ F_B
  err = launch_cgemm(t1r, t1i, ab, fbr, fbi, 0, nullptr, nullptr, zr, zi,
                     q * m, a, b, b, st);
  if (err != 0) return err;
  // encode: out[q] = G @ Z[q] over the flattened (a*b) payload
  return launch_bcmatmul(gr, gi, 0, zr, zi, outr, outi, q, n, m, ab, st);
}
