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

#include "common.cuh"

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 8;    // K slice staged per step
constexpr int TM = 4;    // rows per thread   (rows ty + i*16)
constexpr int TN = 4;    // columns per thread (cols tx + j*16)
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

// C[z] = A[z] @ B[z] (* W when wr != nullptr), planar complex,
// A (M, K) at batch stride sa, B (K, N) at batch stride sb, C (M, N)
// contiguous per batch entry.  Grid: (ceil(N/BN), ceil(M/BM), batch).
__global__ void __launch_bounds__(kThreads)
cgemm_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
             long long sa, const float* __restrict__ br,
             const float* __restrict__ bi, long long sb,
             const float* __restrict__ wr, const float* __restrict__ wi,
             float* __restrict__ cr, float* __restrict__ ci, int M, int N,
             int K) {
  __shared__ float asr[BK][BM];
  __shared__ float asi[BK][BM];
  __shared__ float bsr[BK][BN];
  __shared__ float bsi[BK][BN];
  const long long z = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float* Ar = ar + z * sa;
  const float* Ai = ai + z * sa;
  const float* Br = br + z * sb;
  const float* Bi = bi + z * sb;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float accr[TM][TN], acci[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accr[i][j] = acci[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int mm = e / BK, kk = e % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      const bool ok = gm < M && gk < K;
      const long long off = (long long)gm * K + gk;
      asr[kk][mm] = ok ? Ar[off] : 0.f;
      asi[kk][mm] = ok ? Ai[off] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, nn = e % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool ok = gk < K && gn < N;
      const long long off = (long long)gk * N + gn;
      bsr[kk][nn] = ok ? Br[off] : 0.f;
      bsi[kk][nn] = ok ? Bi[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a_r[TM], a_i[TM], b_r[TN], b_i[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a_r[i] = asr[kk][ty + i * (BM / TM)];
        a_i[i] = asi[kk][ty + i * (BM / TM)];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        b_r[j] = bsr[kk][tx + j * (BN / TN)];
        b_i[j] = bsi[kk][tx + j * (BN / TN)];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          cmac(accr[i][j], acci[i][j], a_r[i], a_i[i], b_r[j], b_i[j]);
    }
    __syncthreads();
  }

  float* Cr = cr + z * (long long)M * N;
  float* Ci = ci + z * (long long)M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * (BN / TN);
      if (gm < M && gn < N) {
        float r = accr[i][j], im = acci[i][j];
        const long long off = (long long)gm * N + gn;
        if (wr != nullptr) {
          const float w_r = wr[off], w_i = wi[off];
          const float t = r * w_r - im * w_i;
          im = r * w_i + im * w_r;
          r = t;
        }
        Cr[off] = r;
        Ci[off] = im;
      }
    }
  }
}

int launch_cgemm(const float* ar, const float* ai, long long sa,
                 const float* br, const float* bi, long long sb,
                 const float* wr, const float* wi, float* cr, float* ci,
                 int batch, int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
                  (unsigned)batch);
  cgemm_kernel<<<grid, kThreads, 0, stream>>>(ar, ai, sa, br, bi, sb, wr, wi,
                                              cr, ci, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

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
