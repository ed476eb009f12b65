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
// serves (m <= 64).  Two designs, chosen by m on the host
// (recombine.recombine_design, from timings of both):
//
//   column -- one thread per (request, l) column, coalesced over l; the m
//             shard values sit in registers (the shard loop is unrolled
//             to a compile-time bound MM >= m), F_m in shared memory.
//             Narrow codes: at m = 4 it runs near its bound.  A wide code
//             leaves it latency-bound: at m = 64 each thread runs m*m
//             dependent MACs on two accumulators, and a short payload
//             (the host path's q = 64, L = 64) gives few threads.
//   tile   -- a block per (request, tile of kTileL positions): the
//             twiddled (m x kTileL) tile is loaded coalesced along l into
//             shared memory, beside F_m transposed (staged from coalesced
//             reads of F); the 32 lanes of a warp take 32 positions l,
//             the warps split the outputs j in pairs (warp w the pairs
//             w, w + W, ...), so a thread computes about MM / W outputs
//             at one l on independent accumulators.  A tile row T[k][.]
//             is one conflict-free read across the warp; a pair of F^T
//             entries is one 16-byte read, broadcast across the warp.
//             The grid is one wave of the card (its SMs times the blocks
//             an SM holds, from the occupancy calculator), spread over
//             the requests; blocks walk their request's tiles at a
//             stride, so a long payload stages F once for many tiles.
//             The product stays dense and FP32 (no TF32).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // column design
constexpr int kTileL = 32;     // tile design: positions a tile, one a lane

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

// Tile design: warps a block, over the outputs j (16 at MM = 64, so a
// block of the host path's m = 64 bucket keeps four warps a scheduler)
template <int MM>
__host__ __device__ constexpr int tile_warps() {
  return MM >= 64 ? 16 : 8;
}

// Pitch, in complex entries, of a row k of F^T in shared memory: the
// warps' 2*JP output columns each, plus two, so the staging's stores
// (consecutive k across a warp) fall two ways a bank, not 32
template <int MM>
__host__ __device__ constexpr int tile_pitch() {
  return 2 * tile_warps<MM>() *
         (((MM + tile_warps<MM>() - 1) / tile_warps<MM>() + 1) / 2) + 2;
}

template <int MM>
__global__ void __launch_bounds__(tile_warps<MM>() * 32)
recombine_tile_kernel(const float* __restrict__ cr,
                      const float* __restrict__ ci,
                      const float* __restrict__ wr,
                      const float* __restrict__ wi,
                      const float* __restrict__ fr,
                      const float* __restrict__ fi, float* __restrict__ outr,
                      float* __restrict__ outi, int m, long long L) {
  constexpr int W = tile_warps<MM>();
  constexpr int JP = ((MM + W - 1) / W + 1) / 2;  // output pairs a thread
  constexpr int P = tile_pitch<MM>();
  // F^T[k][j] = F[j][k] at sf[k*P + j], zero for m <= j < 2*W*JP; pair
  // p = (j / 2) is one 16-byte read, and warp w owns pairs w + W*v; the
  // tile T[k][l] at st[k*kTileL + l]
  extern __shared__ float4 smem4[];
  float2* sf = reinterpret_cast<float2*>(smem4);
  float2* st = sf + m * P;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, w = tid >> 5;
  const long long q = blockIdx.y;
  for (int e = tid; e < m * m; e += nt) {  // coalesced over k
    const int j = e / m, k = e - j * m;
    sf[k * P + j] = make_float2(fr[e], fi[e]);
  }
  const int pad_j = 2 * W * JP - m;
  for (int e = tid; e < m * pad_j; e += nt) {
    const int k = e / pad_j;
    sf[k * P + m + (e - k * pad_j)] = make_float2(0.f, 0.f);
  }
  const long long tiles = (L + kTileL - 1) / kTileL;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long l0 = tile * kTileL;
    for (int e = tid; e < m * kTileL; e += nt) {
      const int k = e / kTileL;
      const long long l = l0 + (e % kTileL);
      float2 v = make_float2(0.f, 0.f);
      if (l < L) {
        const float xr = cr[(q * m + k) * L + l];
        const float xi = ci[(q * m + k) * L + l];
        const float w_r = wr[(long long)k * L + l];
        const float w_i = wi[(long long)k * L + l];
        v = make_float2(xr * w_r - xi * w_i, xr * w_i + xi * w_r);
      }
      st[e] = v;
    }
    __syncthreads();  // F staged (first tile), the tile loaded
    float accr[2 * JP], acci[2 * JP];
#pragma unroll
    for (int u = 0; u < 2 * JP; ++u) accr[u] = acci[u] = 0.f;
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      const float2 t = st[k * kTileL + lane];
      const float4* f = reinterpret_cast<const float4*>(sf + k * P) + w;
#pragma unroll
      for (int v = 0; v < JP; ++v) {
        const float4 ff = f[W * v];  // F[j][k], F[j+1][k], j = 2(w + W v)
        cmac(accr[2 * v], acci[2 * v], ff.x, ff.y, t.x, t.y);
        cmac(accr[2 * v + 1], acci[2 * v + 1], ff.z, ff.w, t.x, t.y);
      }
    }
    const long long l = l0 + lane;
    if (l < L) {
#pragma unroll
      for (int u = 0; u < 2 * JP; ++u) {
        const int j = 2 * (w + W * (u / 2)) + (u & 1);
        if (j < m) {
          outr[(q * m + j) * L + l] = accr[u];
          outi[(q * m + j) * L + l] = acci[u];
        }
      }
    }
    __syncthreads();  // the tile's reads done before the next load
  }
}

template <int MM>
int launch(const float* cr, const float* ci, const float* wr, const float* wi,
           const float* fr, const float* fi, float* outr, float* outi, int q,
           int m, long long L, int tile, cudaStream_t stream) {
  if (q < 1 || L < 1) return 0;
  if (tile) {
    const size_t smem =
        (size_t)m * (tile_pitch<MM>() + kTileL) * sizeof(float2);
    const cudaError_t err = cudaFuncSetAttribute(
        recombine_tile_kernel<MM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    // one wave: as many blocks as the card holds at once, spread over
    // the requests, each walking its request's tiles at a stride, so a
    // long payload stages F once a block and leaves no partial wave
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, recombine_tile_kernel<MM>, tile_warps<MM>() * 32, smem);
    const long long tiles = (L + kTileL - 1) / kTileL;
    long long per_q = (long long)sms * (per_sm > 0 ? per_sm : 1) / q;
    if (per_q < 1) per_q = 1;
    const dim3 grid((unsigned)(tiles < per_q ? tiles : per_q), (unsigned)q);
    recombine_tile_kernel<MM><<<grid, tile_warps<MM>() * 32, smem, stream>>>(
        cr, ci, wr, wi, fr, fi, outr, outi, m, L);
  } else {
    const dim3 grid((unsigned)((L + kThreads - 1) / kThreads), (unsigned)q);
    recombine_kernel<MM><<<grid, kThreads, 0, stream>>>(
        cr, ci, wr, wi, fr, fi, outr, outi, m, L);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// c: (q, m, L) planes; w: (m, L); f: (m, m); out: (q, m, L).  tile: 0 the
// column design, 1 the tile design (recombine.recombine_design picks).
// m must be in [1, 64]; the wrapper checks.
extern "C" int recombine_batched_f32(const float* cr, const float* ci,
                                     const float* wr, const float* wi,
                                     const float* fr, const float* fi,
                                     float* outr, float* outi, int q, int m,
                                     long long L, int tile, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 1) return (int)cudaErrorInvalidValue;
  if (m <= 4)
    return launch<4>(cr, ci, wr, wi, fr, fi, outr, outi, q, m, L, tile, st);
  if (m <= 8)
    return launch<8>(cr, ci, wr, wi, fr, fi, outr, outi, q, m, L, tile, st);
  if (m <= 16)
    return launch<16>(cr, ci, wr, wi, fr, fi, outr, outi, q, m, L, tile, st);
  if (m <= 32)
    return launch<32>(cr, ci, wr, wi, fr, fi, outr, outi, q, m, L, tile, st);
  if (m <= 64)
    return launch<64>(cr, ci, wr, wi, fr, fi, outr, outi, q, m, L, tile, st);
  return (int)cudaErrorInvalidValue;
}
