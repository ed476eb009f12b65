// Fused MDS encode + four-step worker DFT of the message shards.
//
// Replaces the TPU kernel kernels/fourstep_fft.py::encode_fourstep_fused in
// the JAX package.  For every request q and message shard i (an A x B
// matrix M_i with M_i[a, b] = c_i[a*B + b]):
//
//   T1_i = (F_A @ M_i) * W        column pass: A-point DFTs + twiddle
//   Z_i  = T1_i @ F_B             row pass:    B-point DFTs
//   out[q, k] = sum_i G[k, i] Z_i  encode:     (N, m) generator across shards
//
// and out[q, k, c, d] holds the coded worker spectrum B_k[c + d*A] (the
// reference's scrambled four-step order).  Transforming the m message
// shards and encoding after (the DFT commutes with G) saves N/m of the
// DFT work, as in the reference.
//
// What bounds it on the H100: bytes.  The function needs an FFT of each
// shard (5*L*log2(L) flops) and the encode (8*N*m flops a point),
// against reading the m message shards and writing the N coded ones
// once; for the service's s = 2^20, m = 4, N = 8 (A = B = 512, 16
// requests) that is about 0.04 ms of FP32 work against 0.12 ms of
// traffic.
//
// Design: two launches, no dense DFT.
//   1. The column FFT of fft_cols.cuh over the q*m shards (A points down
//      B columns, tiles of TC columns, W folded into its last pass, the
//      plain store): T1 (q, m, A, B) in device memory.
//   2. encode_rows_kernel: one block takes rows c0 .. c0 + C - 1 of all m
//      shards of one request -- for each shard one contiguous run of C*B
//      floats, at stride A*B between shards -- runs the row FFT's passes
//      on those m*C rows in shared memory (fft_rows.cuh's schedule,
//      run_passes), and stores out[q, k, c, d] = sum_i G[k, i] Z_i[c, d]
//      for every k < N: for each k one contiguous run of C*B floats.  G
//      is read through the read-only path, one entry for a whole warp.
//      Z never reaches device memory: at the service shape that saves
//      writing and reading 268 MB, and the G apply's launch.
// C = ceil(2048 / (m*B)), at most A (fourstep_fft.encode_rows_per_block):
// one c a block at m = 4, B = 512 (2048 points), four at m = 64, B = 8.
// The fold holds where m*B is at most 4096 points and the working set
// (fourstep_fft.encode_rows_layout, the one reckoning) fits a block's
// shared memory (fourstep_fft.encode_rows_fold).  Past it -- m = 16 at
// B = 512 -- launch 2 is the plain row FFT of fft_rows.cuh over all
// q*m*A rows of T1 into Z (device scratch) and launch 3 the G apply of
// common.cuh (launch_bcmatmul, G broadcast over the requests).

#include "common.cuh"
#include "fft_cols.cuh"

namespace {

using fft_rows::aligned16;
using fft_rows::pad;

constexpr int kThreads = 256;
// The service's block (m = 4 rows of B = 512, 38 KB of shared memory)
// leaves room for five blocks an SM; registers are capped at 64 a thread
// for four, where the encode's 16 accumulators still fit without spills
constexpr int kMinBlocks = 4;
// Coded rows k one thread sums at once: each Z value read from shared
// memory serves kRowsK products
constexpr int kRowsK = 8;

// t1 (q, m, a, b) -> out (q, n, a, b): the row FFT of p.n = b points over
// the m shards' rows c0 .. c0 + p.rows - 1, then G.  Grid: q * tiles
// blocks, tiles = ceil(a / p.rows).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
encode_rows_kernel(const float* __restrict__ t1r,
                   const float* __restrict__ t1i,
                   const float* __restrict__ gr, const float* __restrict__ gi,
                   const float* __restrict__ twr,
                   const float* __restrict__ twi, float* __restrict__ outr,
                   float* __restrict__ outi, int m, int n, int a, int tiles,
                   fft_rows::Plan p, fft_rows::Layout o) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = p.n;
  const long long q = blockIdx.x / tiles;
  const int c0 = (int)(blockIdx.x - q * tiles) * p.rows;
  const int span = p.rows * b;               // words of one shard's rows
  const int live = min(p.rows, a - c0) * b;  // ... that hold rows c < a
  const long long ab = (long long)a * b;
  const int plane = (int)((o.y - o.x) / 2);
  float* tr = smem + o.tab;
  float* ti = tr + (o.total - o.tab) / 2;
  for (int t = tid; t < b; t += nt) {
    tr[pad(t)] = twr[t];
    ti[pad(t)] = twi[t];
  }
  float* sr = smem + o.x;
  float* si = sr + plane;
  float* dr = smem + o.y;
  float* di = dr + plane;
  // load: shard i's run t1[q, i, c0 .. , :] to words i*span + w; rows
  // past a read as zero
  const float* xr = t1r + q * m * ab + (long long)c0 * b;
  const float* xi = t1i + q * m * ab + (long long)c0 * b;
  if ((b & 3) == 0 && aligned16(t1r, t1i)) {
    const int q4 = span >> 2;
    for (int e = tid; e < m * q4; e += nt) {
      const int i = e / q4, w = (e - i * q4) << 2;
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
      if (w < live) {
        va = __ldg(reinterpret_cast<const float4*>(xr + i * ab + w));
        vb = __ldg(reinterpret_cast<const float4*>(xi + i * ab + w));
      }
      const int s = i * span + w;
      sr[pad(s)] = va.x;
      sr[pad(s + 1)] = va.y;
      sr[pad(s + 2)] = va.z;
      sr[pad(s + 3)] = va.w;
      si[pad(s)] = vb.x;
      si[pad(s + 1)] = vb.y;
      si[pad(s + 2)] = vb.z;
      si[pad(s + 3)] = vb.w;
    }
  } else {
    for (int e = tid; e < m * span; e += nt) {
      const int i = e / span, w = e - i * span;
      const bool ok = w < live;
      sr[pad(e)] = ok ? xr[i * ab + w] : 0.f;
      si[pad(e)] = ok ? xi[i * ab + w] : 0.f;
    }
  }
  __syncthreads();
  fft_rows::run_passes(sr, si, dr, di, tr, ti, p, m * p.rows, tid, nt);
  // the encode: thread item (k group, w) sums kRowsK coded rows at word w
  // of every shard; for each k the block's output is one run of live
  // floats at out[q, k, c0, 0]
  float* hr = outr + q * n * ab + (long long)c0 * b;
  float* hi = outi + q * n * ab + (long long)c0 * b;
  const int groups = (n + kRowsK - 1) / kRowsK;
  for (int e = tid; e < groups * live; e += nt) {
    const int k0 = (e / live) * kRowsK, w = e - (e / live) * live;
    float accr[kRowsK], acci[kRowsK];
#pragma unroll
    for (int r = 0; r < kRowsK; ++r) accr[r] = acci[r] = 0.f;
    for (int i = 0; i < m; ++i) {
      const float zr = sr[pad(i * span + w)], zi = si[pad(i * span + w)];
#pragma unroll
      for (int r = 0; r < kRowsK; ++r) {
        // rows past n repeat row n - 1, and are not stored
        const int g = min(k0 + r, n - 1) * m + i;
        cmac(accr[r], acci[r], __ldg(gr + g), __ldg(gi + g), zr, zi);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsK; ++r) {
      if (k0 + r < n) {
        hr[(k0 + r) * ab + w] = accr[r];
        hi[(k0 + r) * ab + w] = acci[r];
      }
    }
  }
}

// Launch encode_rows_kernel: the plan's tile is the rows c a block takes,
// its layout the folded working set.
int launch_encode_rows(const float* t1r, const float* t1i, const float* gr,
                       const float* gi, const float* twr, const float* twi,
                       float* outr, float* outi, int q, int m, int n, int a,
                       const fft_cols::FftSpec& s, cudaStream_t stream) {
  if (s.passes < 0 || s.passes > fft_rows::kMaxPasses || s.tile < 1 ||
      s.n < 1)
    return (int)cudaErrorInvalidValue;
  fft_rows::Plan p;
  memset(&p, 0, sizeof(p));
  p.n = s.n;
  p.rows = s.tile;
  p.passes = s.passes;
  for (int k = 0; k < s.passes; ++k) p.radix[k] = s.radix[k];
  fft_rows::Layout o;
  memcpy(&o, s.layout, sizeof(o));
  const size_t smem = (size_t)o.total * sizeof(float);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        encode_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (a + p.rows - 1) / p.rows;
  const long long blocks = (long long)q * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  encode_rows_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      t1r, t1i, gr, gi, twr, twi, outr, outi, m, n, a, tiles, p, o);
  return (int)cudaGetLastError();
}

}  // namespace

// c: (q, m, a, b) message planes; g: (n, m); w: (a, b); ta, tb: the (a,)
// and (b,) f32 tables of w^t; t1: (q, m, a, b) scratch; z: (q, m, a, b)
// scratch of the three-launch route (unused when fold); out: (q, n, a,
// b); sa: the column FFT plan of a over b columns; sb: the row plan of
// b -- the folded one (fourstep_fft.encode_rows_spec) when fold, else
// the row FFT's (fft_rows_spec).  Host memory for sa and sb.  Returns
// the first nonzero cudaGetLastError() of the two or three launches.
extern "C" int encode_fourstep_f32(
    const float* cr, const float* ci, const float* gr, const float* gi,
    const float* wr, const float* wi, const float* tar, const float* tai,
    const float* tbr, const float* tbi, float* t1r, float* t1i, float* zr,
    float* zi, float* outr, float* outi, int q, int m, int n,
    const fft_cols::FftSpec* sa, const fft_cols::FftSpec* sb, int fold,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int a = sa->n, b = sb->n;
  // T1_i = (F_A @ M_i) * W: the columns of every shard, plain store
  int err = fft_cols::launch(cr, ci, t1r, t1i, tar, tai, wr, wi,
                             (long long)q * m, b, 1, false, *sa, st);
  if (err != 0) return err;
  if (fold)  // out[q] = G @ (T1 @ F_B), row c of the m shards a block
    return launch_encode_rows(t1r, t1i, gr, gi, tbr, tbi, outr, outi, q, m,
                              n, a, *sb, st);
  // Z = T1 @ F_B over every row, then out[q] = G @ Z[q]
  err = fft_rows::launch(t1r, t1i, zr, zi, tbr, tbi, (long long)q * m * a, b,
                         sb->radix, sb->passes, sb->tile, sb->layout, st);
  if (err != 0) return err;
  return launch_bcmatmul(gr, gi, 0, zr, zi, outr, outi, q, n, m,
                         (long long)a * b, st);
}
