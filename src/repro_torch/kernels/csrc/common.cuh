// Shared device helpers for the coded-FFT kernels.
//
// Every kernel works on PLANAR complex data: separate float32 real and
// imaginary planes, the layout the JAX package's Pallas kernels use, so
// the ports take the same arrays.  Arithmetic is FP32 on CUDA cores with
// FP32 accumulation (no TF32: the reference tolerances rule it out).
//
// The constant tables and planes (DFT, twiddle, recombine, split and
// pack) come as float, or as bfloat16 under precision="bf16": the FFT and
// bucket kernels take their element type as a template parameter TW and
// widen every entry to float once, as it loads (widen, ldg_f32).  The
// payload, G and the decode stay float, and so does shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A table or plane entry as float.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// *p through the read-only cache, as float.
template <class TW>
__device__ __forceinline__ float ldg_f32(const TW* p) {
  return widen(__ldg(p));
}

// T itself, in a context that does not deduce it: a launcher's optional
// plane pointer (nullptr for none) takes the table's element type.
template <class T>
struct same_type {
  using type = T;
};

// acc += a * b on planar complex scalars.
__device__ __forceinline__ void cmac(float& accr, float& acci, float ar,
                                     float ai, float br, float bi) {
  accr = fmaf(ar, br, accr);
  accr = fmaf(-ai, bi, accr);
  acci = fmaf(ar, bi, acci);
  acci = fmaf(ai, br, acci);
}

// C[q] = A[q] @ B[q] for a batch of planar complex matrices:
// A (M, K) at batch stride `sa` floats (0 = one A shared by the batch),
// B (K, L) and C (M, L) contiguous per request.  M and K are small (a
// code or decode matrix), L is the wide payload.  Grid: (ceil(L/blockDim),
// q); each thread owns one payload column l and walks the output rows in
// register blocks of RB, re-reading its column of B (L1/L2-resident) once
// per block.  A[q] sits in shared memory (2*M*K floats, dynamic).
template <int RB>
__global__ void bcmatmul_kernel(const float* __restrict__ ar,
                                const float* __restrict__ ai, long long sa,
                                const float* __restrict__ br,
                                const float* __restrict__ bi,
                                float* __restrict__ cr, float* __restrict__ ci,
                                int M, int K, long long L) {
  extern __shared__ float sm_a[];
  float* sar = sm_a;
  float* sai = sm_a + M * K;
  const long long q = blockIdx.y;
  const float* aqr = ar + q * sa;
  const float* aqi = ai + q * sa;
  for (int t = threadIdx.x; t < M * K; t += blockDim.x) {
    sar[t] = aqr[t];
    sai[t] = aqi[t];
  }
  __syncthreads();
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const float* bqr = br + q * K * L + l;
  const float* bqi = bi + q * K * L + l;
  float* cqr = cr + q * M * L + l;
  float* cqi = ci + q * M * L + l;
  for (int r0 = 0; r0 < M; r0 += RB) {
    float accr[RB], acci[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) accr[r] = acci[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float xr = bqr[(long long)k * L];
      const float xi = bqi[(long long)k * L];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r0 + r < M) {
          cmac(accr[r], acci[r], sar[(r0 + r) * K + k], sai[(r0 + r) * K + k],
               xr, xi);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r0 + r < M) {
        cqr[(long long)(r0 + r) * L] = accr[r];
        cqi[(long long)(r0 + r) * L] = acci[r];
      }
    }
  }
}

constexpr int kBcmatmulThreads = 256;
constexpr int kBcmatmulRows = 8;
// Dynamic shared memory a launch gets without opting in.
constexpr size_t kSmemDefault = 48 * 1024;

// Launch bcmatmul_kernel on `stream`; returns the first CUDA error.  A
// left matrix over 48 KB (a (64, 128) decode or a (128, 64) generator)
// opts in to the card's larger per-block limit first; the wrappers keep
// it under that limit (cmatmul.check_left_fits).
static inline int launch_bcmatmul(const float* ar, const float* ai,
                                  long long sa, const float* br,
                                  const float* bi, float* cr, float* ci, int q,
                                  int M, int K, long long L,
                                  cudaStream_t stream) {
  const dim3 grid((unsigned)((L + kBcmatmulThreads - 1) / kBcmatmulThreads),
                  (unsigned)q);
  const size_t smem = 2 * (size_t)M * K * sizeof(float);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcmatmul_kernel<kBcmatmulRows>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bcmatmul_kernel<kBcmatmulRows><<<grid, kBcmatmulThreads, smem, stream>>>(
      ar, ai, sa, br, bi, cr, ci, M, K, L);
  return (int)cudaGetLastError();
}
