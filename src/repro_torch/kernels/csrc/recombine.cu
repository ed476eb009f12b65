// Recombine: out[q, j, l] = sum_k F_m[j, k] * (C[q, k, l] * W[k, l]).
//
// Replaces two TPU kernels of the JAX package's kernels/recombine.py:
// recombine_twiddle_dft_batched (a bucket of q requests, the service's
// stage route) and recombine_twiddle_dft (one request, the dispatch
// layer's recombine_fused: the same entry with q = 1).  Both are the
// master's last stage (paper eq. 24), an elementwise twiddle
// omega_s^{lk} followed by a length-m DFT across the shard axis at every
// payload position l.
//
// What bounds it on the H100: bytes.  Per column it reads m complex inputs
// and m twiddles and writes m outputs for m*m + m complex MACs -- about
// m/3 flops per byte, under the FP32 balance point for every m it
// serves (m <= 64).  Design: one thread per (request, l) column,
// coalesced over l; the m shard values sit in registers (the shard loop
// is unrolled to a compile-time bound MM >= m: at MM = 64 that is 128
// registers of shard values a thread), F_m in shared memory.

#include "common.cuh"

template <int MM>
__global__ void recombine_kernel(const float* __restrict__ cr,
                                 const float* __restrict__ ci,
                                 const float* __restrict__ wr,
                                 const float* __restrict__ wi,
                                 const float* __restrict__ fr,
                                 const float* __restrict__ fi,
                                 float* __restrict__ outr,
                                 float* __restrict__ outi, int m, long long L) {
  __shared__ float sfr[MM * MM];
  __shared__ float sfi[MM * MM];
  for (int t = threadIdx.x; t < m * m; t += blockDim.x) {
    sfr[t] = fr[t];
    sfi[t] = fi[t];
  }
  __syncthreads();
  const long long q = blockIdx.y;
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float tr[MM], ti[MM];
#pragma unroll
  for (int k = 0; k < MM; ++k) {
    if (k < m) {
      const float xr = cr[(q * m + k) * L + l];
      const float xi = ci[(q * m + k) * L + l];
      const float w_r = wr[(long long)k * L + l];
      const float w_i = wi[(long long)k * L + l];
      tr[k] = xr * w_r - xi * w_i;
      ti[k] = xr * w_i + xi * w_r;
    }
  }
#pragma unroll 1
  for (int j = 0; j < m; ++j) {
    float accr = 0.f, acci = 0.f;
#pragma unroll
    for (int k = 0; k < MM; ++k) {
      if (k < m) cmac(accr, acci, sfr[j * m + k], sfi[j * m + k], tr[k], ti[k]);
    }
    outr[(q * m + j) * L + l] = accr;
    outi[(q * m + j) * L + l] = acci;
  }
}

template <int MM>
static int launch(const float* cr, const float* ci, const float* wr,
                  const float* wi, const float* fr, const float* fi,
                  float* outr, float* outi, int q, int m, long long L,
                  cudaStream_t stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((L + threads - 1) / threads), (unsigned)q);
  recombine_kernel<MM><<<grid, threads, 0, stream>>>(cr, ci, wr, wi, fr, fi,
                                                     outr, outi, m, L);
  return (int)cudaGetLastError();
}

// m must be in [1, 64]; the wrapper checks.
extern "C" int recombine_batched_f32(const float* cr, const float* ci,
                                     const float* wr, const float* wi,
                                     const float* fr, const float* fi,
                                     float* outr, float* outi, int q, int m,
                                     long long L, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 4) return launch<4>(cr, ci, wr, wi, fr, fi, outr, outi, q, m, L, st);
  if (m <= 8) return launch<8>(cr, ci, wr, wi, fr, fi, outr, outi, q, m, L, st);
  if (m <= 16)
    return launch<16>(cr, ci, wr, wi, fr, fi, outr, outi, q, m, L, st);
  if (m <= 32)
    return launch<32>(cr, ci, wr, wi, fr, fi, outr, outi, q, m, L, st);
  if (m <= 64)
    return launch<64>(cr, ci, wr, wi, fr, fi, outr, outi, q, m, L, st);
  return (int)cudaErrorInvalidValue;
}
