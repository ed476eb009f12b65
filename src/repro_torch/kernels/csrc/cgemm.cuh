// Register-tiled batched complex GEMM, with an optional twiddle epilogue.
//
// C[z] = A[z] @ B[z] (* W) on planar complex float32 matrices, FP32 FMA on
// CUDA cores with FP32 accumulation.  Each block computes a 64 x 64 output
// tile, staging 8-deep K slices of A and B in shared memory; each thread
// holds a 4 x 4 complex tile of accumulators, owning rows ty + i*16 and
// columns tx + j*16, so the shared-memory reads of a warp do not conflict.
// A batch stride of 0 shares one matrix across the batch.  The batch is
// grid z, at most 65,535: callers chunk larger batches.
//
// Callers, the dense-DFT passes of the four-step kernels: the column pass
// (F_A @ M, twiddle in the epilogue) and the row pass (T1 @ F_B) of
// encode_fourstep.cu, and fourstep.cu's fourstep_stage1 (a column pass).
// fourstep_stage2, fourstep_streaming and the streaming c2c bucket run the
// Stockham FFTs of fft_rows.cuh and fft_cols.cuh instead.

#pragma once

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
        if (wr != nullptr) {
          const long long woff = (long long)gm * N + gn;
          const float w_r = wr[woff], w_i = wi[woff];
          const float t = r * w_r - im * w_i;
          im = r * w_i + im * w_r;
          r = t;
        }
        const long long off = (long long)gm * N + gn;
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
