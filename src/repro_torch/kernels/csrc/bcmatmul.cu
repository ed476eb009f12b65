// Batched planar complex matmul of the decode apply: C[q] = D[q] @ B[q].
//
// Replaces the TPU kernel kernels/cmatmul.py::bcmatmul in the JAX package
// (the per-request decode apply of the service's stage route: every
// request carries its own (m, N) scatter decode matrix D, applied to its
// (N, L) worker spectra B).
//
// What bounds it on the H100: bytes.  Per payload column the product
// reads the live rows of B and writes M outputs, doing M complex MACs per
// live row: with M = m that is about 2 flops a byte for the service's
// (4, 8) code, far under the card's ~20 flops/byte FP32 balance point.
//
// Design.
//
// * Live columns only.  A scatter decode matrix is exactly zero in its
//   N - m straggler columns, so half of B need not be read.  A block
//   stages its rows of D in shared memory, 128 columns at a time, marks
//   each column that is nonzero in either plane on some row it holds,
//   and compacts those columns, in order, into a list (warp ballots and a
//   prefix over the warps); the K loop runs over that list.  A skipped
//   term is 0 * x, so the result is the same for finite x; a straggler's
//   non-finite spectrum is never read (a deliberate difference from the
//   plain product, which turns it into NaN).
// * Two thread maps, chosen on the host from the shape
//   (cmatmul.bcmatmul_map).  Wide (L >= 1024 and M <= 16, the m=4 stage
//   route): a thread owns 4 consecutive payload columns and keeps all M
//   rows' accumulators in registers, so it reads each live row of B once,
//   16 bytes a plane where L and the pointers allow, and writes C once:
//   B and C cross the bus once.  Narrow (small L or large M, the m=64 host
//   path): the grid is (L/64, M/16, q), a block owns a 16 x 64 output
//   tile, stages the live rows of its 64-column B tile in shared memory
//   (64 live rows x 64 x 8 bytes = 32 KB at m=64) and each thread keeps 4
//   outputs of one column in registers, looped over the live k.
//
// FP32 on CUDA cores with FP32 accumulation, the live terms in ascending
// k.  D is staged 16 rows by 128 columns at a time, so this kernel has no
// left-matrix bound of its own; the wrapper still applies
// cmatmul.check_left_fits, the stage route's one bound for all of its
// kernels (common.cuh's launch_bcmatmul, which cmatmul.cu and
// encode_fourstep.cu run, holds the whole left matrix).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;      // columns of D staged per step
constexpr int kRows = 16;        // rows of D a block holds
constexpr int kWideCols = 4;     // payload columns a wide thread owns
constexpr int kNarrowCols = 64;  // payload columns of a narrow tile
constexpr int kNarrowRowsPerThread = kRows / (kThreads / kNarrowCols);

// Stage rows [r0, r0 + nr) (nr <= kRows) and columns [k0, k0 + kc) (kc <=
// kChunk) of the (M, K) planes d into sdr/sdi ([kRows][kChunk], zero past
// nr and kc), and list the chunk's live columns -- nonzero in either
// plane on some staged row -- in ascending order in `live`.  Returns
// their count.  Every thread of the block calls it; it ends at a barrier.
__device__ int stage_live(const float* __restrict__ dr,
                          const float* __restrict__ di, int K, int r0,
                          int nr, int k0, int kc, float* sdr, float* sdi,
                          int* live, int* counts) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool on = false;
  unsigned mask = 0;
  if (tid < kChunk) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float vr = 0.f, vi = 0.f;
      if (r < nr && tid < kc) {
        const long long off = (long long)(r0 + r) * K + k0 + tid;
        vr = dr[off];
        vi = di[off];
      }
      sdr[r * kChunk + tid] = vr;
      sdi[r * kChunk + tid] = vi;
      on = on || vr != 0.f || vi != 0.f;
    }
    mask = __ballot_sync(0xffffffffu, on);
    if (lane == 0) counts[warp] = __popc(mask);
  }
  __syncthreads();
  int total = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kChunk / 32; ++w) {
    const int c = counts[w];
    if (w < warp) before += c;
    total += c;
  }
  if (on) live[before + __popc(mask & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  return total;
}

// Wide map: grid (ceil(L / (kThreads * kWideCols)), q); MR >= M rows of
// accumulators.  vec: L % 4 == 0 and every plane 16-byte aligned.
template <int MR>
__global__ void __launch_bounds__(kThreads)
bcmatmul_wide_kernel(const float* __restrict__ dr,
                     const float* __restrict__ di,
                     const float* __restrict__ br,
                     const float* __restrict__ bi, float* __restrict__ cr,
                     float* __restrict__ ci, int M, int K, long long L,
                     int vec) {
  __shared__ float sdr[kRows * kChunk];
  __shared__ float sdi[kRows * kChunk];
  __shared__ int live[kChunk];
  __shared__ int counts[kChunk / 32];
  const long long q = blockIdx.y;
  const long long l0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kWideCols;
  const int cols = (int)min((long long)kWideCols, L - l0);  // <= 0: idle
  float accr[MR][kWideCols], acci[MR][kWideCols];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int u = 0; u < kWideCols; ++u) accr[r][u] = acci[r][u] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    const int n = stage_live(dr + q * M * K, di + q * M * K, K, 0, M, k0, kc,
                             sdr, sdi, live, counts);
    if (cols > 0) {
      const float* bqr = br + (q * K + k0) * L + l0;
      const float* bqi = bi + (q * K + k0) * L + l0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int k = live[j];
        float xr[kWideCols], xi[kWideCols];
        if (vec) {
          const float4 a = *reinterpret_cast<const float4*>(bqr + k * L);
          const float4 b = *reinterpret_cast<const float4*>(bqi + k * L);
          xr[0] = a.x; xr[1] = a.y; xr[2] = a.z; xr[3] = a.w;
          xi[0] = b.x; xi[1] = b.y; xi[2] = b.z; xi[3] = b.w;
        } else {
#pragma unroll
          for (int u = 0; u < kWideCols; ++u) {
            xr[u] = u < cols ? bqr[k * L + u] : 0.f;
            xi[u] = u < cols ? bqi[k * L + u] : 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          if (r < M) {
            const float a_r = sdr[r * kChunk + k], a_i = sdi[r * kChunk + k];
#pragma unroll
            for (int u = 0; u < kWideCols; ++u)
              cmac(accr[r][u], acci[r][u], a_r, a_i, xr[u], xi[u]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (cols <= 0) return;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r < M) {
      float* cqr = cr + (q * M + r) * L + l0;
      float* cqi = ci + (q * M + r) * L + l0;
      if (vec) {
        *reinterpret_cast<float4*>(cqr) =
            make_float4(accr[r][0], accr[r][1], accr[r][2], accr[r][3]);
        *reinterpret_cast<float4*>(cqi) =
            make_float4(acci[r][0], acci[r][1], acci[r][2], acci[r][3]);
      } else {
#pragma unroll
        for (int u = 0; u < kWideCols; ++u) {
          if (u < cols) {
            cqr[u] = accr[r][u];
            cqi[u] = acci[r][u];
          }
        }
      }
    }
  }
}

// Narrow map: grid (ceil(L / kNarrowCols), ceil(M / kRows), q).  Thread
// (tx, ty) = (tid % 64, tid / 64) owns column tx of the tile and rows
// ty + 4*i.  Dynamic shared memory: the live rows of the B tile,
// 2 * kChunk * kNarrowCols floats.
__global__ void __launch_bounds__(kThreads)
bcmatmul_narrow_kernel(const float* __restrict__ dr,
                       const float* __restrict__ di,
                       const float* __restrict__ br,
                       const float* __restrict__ bi, float* __restrict__ cr,
                       float* __restrict__ ci, int M, int K, long long L) {
  extern __shared__ float sb[];
  __shared__ float sdr[kRows * kChunk];
  __shared__ float sdi[kRows * kChunk];
  __shared__ int live[kChunk];
  __shared__ int counts[kChunk / 32];
  float* sbr = sb;
  float* sbi = sb + kChunk * kNarrowCols;
  const int tid = threadIdx.x;
  const int tx = tid % kNarrowCols, ty = tid / kNarrowCols;
  const long long q = blockIdx.z;
  const int m0 = blockIdx.y * kRows;
  const long long n0 = (long long)blockIdx.x * kNarrowCols;
  float accr[kNarrowRowsPerThread], acci[kNarrowRowsPerThread];
#pragma unroll
  for (int i = 0; i < kNarrowRowsPerThread; ++i) accr[i] = acci[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    const int n = stage_live(dr + q * M * K, di + q * M * K, K, m0,
                             min(kRows, M - m0), k0, kc, sdr, sdi, live,
                             counts);
    for (int e = tid; e < n * kNarrowCols; e += kThreads) {
      const int j = e / kNarrowCols, c = e % kNarrowCols;
      const long long l = n0 + c;
      const long long off = (q * K + k0 + live[j]) * L + l;
      sbr[e] = l < L ? br[off] : 0.f;
      sbi[e] = l < L ? bi[off] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float xr = sbr[j * kNarrowCols + tx];
      const float xi = sbi[j * kNarrowCols + tx];
      const int k = live[j];
#pragma unroll
      for (int i = 0; i < kNarrowRowsPerThread; ++i) {
        const int r = ty + i * (kThreads / kNarrowCols);
        cmac(accr[i], acci[i], sdr[r * kChunk + k], sdi[r * kChunk + k], xr,
             xi);
      }
    }
    __syncthreads();
  }
  const long long l = n0 + tx;
  if (l >= L) return;
#pragma unroll
  for (int i = 0; i < kNarrowRowsPerThread; ++i) {
    const int r = m0 + ty + i * (kThreads / kNarrowCols);
    if (r < M) {
      cr[(q * M + r) * L + l] = accr[i];
      ci[(q * M + r) * L + l] = acci[i];
    }
  }
}

template <int MR>
void launch_wide(const float* dr, const float* di, const float* br,
                 const float* bi, float* cr, float* ci, int q, int M, int K,
                 long long L, int vec, cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kWideCols;
  const dim3 grid((unsigned)((L + per_block - 1) / per_block), (unsigned)q);
  bcmatmul_wide_kernel<MR><<<grid, kThreads, 0, stream>>>(dr, di, br, bi, cr,
                                                         ci, M, K, L, vec);
}

}  // namespace

// d: (q, M, K) decode planes; b: (q, K, L) worker spectra; c: (q, M, L)
// out.  wide: the wide map (M <= 16), else the narrow one; vec (wide
// only): L % 4 == 0 and every plane 16-byte aligned.  One launch; returns
// the first CUDA error.
extern "C" int bcmatmul_f32(const float* dr, const float* di, const float* br,
                            const float* bi, float* cr, float* ci, int q,
                            int M, int K, long long L, int wide, int vec,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (q < 1 || M < 1 || L < 1) return 0;
  if (wide) {
    if (M <= 4)
      launch_wide<4>(dr, di, br, bi, cr, ci, q, M, K, L, vec, st);
    else if (M <= 8)
      launch_wide<8>(dr, di, br, bi, cr, ci, q, M, K, L, vec, st);
    else if (M <= kRows)
      launch_wide<kRows>(dr, di, br, bi, cr, ci, q, M, K, L, vec, st);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  const size_t smem = 2 * (size_t)kChunk * kNarrowCols * sizeof(float);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcmatmul_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((L + kNarrowCols - 1) / kNarrowCols),
                  (unsigned)((M + kRows - 1) / kRows), (unsigned)q);
  bcmatmul_narrow_kernel<<<grid, kThreads, smem, st>>>(dr, di, br, bi, cr,
                                                       ci, M, K, L);
  return (int)cudaGetLastError();
}
