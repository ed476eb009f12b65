// The c2c coded-FFT bucket past the whole-bucket kernel's shared memory.
//
// Replaces the TPU kernel kernels/coded_pipeline.py::_streaming_bucket_call
// of the JAX package in both its modes: planes (coded_fft_bucket_streaming,
// the service's host decode-matrix path, with host-built decode planes)
// and masked (coded_fft_bucket_streaming_masked, the default
// device-decode path, from the raw responder masks).  Per request q, from
// the raw request x (length s = m*L, L = A*B) and its (m, N) scatter
// decode matrix D, the same function as coded_bucket.cu's kernels:
//
//   0. decode        masked mode only: one block per request turns its
//                    raw (N,) mask row into D -- the first m responders
//                    (short rows filled with the first non-responders),
//                    the closed-form Lagrange inverse of G[subset] in the
//                    reference's shuffled locator order with node angles
//                    reduced as integers (block_subset_decode of
//                    bucket.cuh, the masked bucket kernels' own), its
//                    columns scattered to the responders' worker slots
//                    and zeros elsewhere -- into a (q, m, N) scratch;
//   1. column pass   T1_i = (F_A @ M_i) * W for every message shard
//                    M_i[a][b] = x[i + (a*B + b)*m], read in place: the
//                    request viewed as an (A, B*m) matrix IS the m shards
//                    interleaved column by column, so one column FFT over
//                    it (fft_cols.cuh, ld = B*m) transforms them all; its
//                    last pass applies W[c][col / m], and its store
//                    de-interleaves, column col = b*m + i to t1[c][i][b]:
//                    t1 is (A, m, B);
//   2. row pass      Z_i = T1_i @ F_B: the row FFT of fft_rows.cuh over
//                    t1's A*m contiguous B-point rows, as fourstep_stage2
//                    runs it, so z is (A, m, B) with Z_i[c][d] the
//                    spectrum at the natural index c + d*A;
//   3. code          at each payload position (c, d): every worker's
//                    result b_r = G[r] . t over all N rows, then
//                    c^ = D . b (the TPU kernel's two contractions, kept
//                    apart: D . G is the identity for a scatter D), the
//                    recombine twiddle (pre-permuted: read at c*B + d),
//                    the length-m DFT, and the natural-order output
//                    X[j*L + c + d*A].
//
// The TPU kernel streams phases 1 and 2+3 through VMEM tiles with
// hand-rolled double-buffered DMA inside one launch, because a grid step
// there is sequential and VMEM is large.  Here blocks run in parallel
// and a phase boundary needs every block of the previous phase done, so
// the three phases are three launches on one stream, and the masked mode
// is four: its decode launch runs once per request ahead of them, where
// the TPU kernel forms the decode weights in VMEM at every tile.  Folding
// that decode into the code launch would repeat it in each of its ~1,000
// blocks per request, and its locator product runs on one thread.  The
// intermediates t1 and z live in device memory (scratch the wrapper
// allocates), each (q, s) like the request, and D (q, m, N): nothing N/m
// times wider than the request is written, which the stage route's coded
// spectra are.
//
// What bounds it on the H100: bytes.  For the service's 2^20-point
// bucket (q = 16, m = 4, N = 8: A = B = 512) the function needs an FFT
// of each shard and O(N*m) coding work per position, about 0.04 ms of
// FP32 work, against about 0.08 ms to read x, D and the planes and write
// the output once.  Phases 1 and 2 are Stockham FFTs, each reading and
// writing the request once (the f32 tables of A and B in place of the
// dense F_A and F_B planes): TC = 8 columns a tile at A = 512, so phase
// 1 reads 32-byte runs, and its de-interleaved store writes runs of 8/m
// floats (two at m = 4), under a sector, which the neighbouring tiles'
// blocks complete in L2.  Phase 3
// is bytes: one thread per position, G, D and F_m in shared memory, a
// warp over 4 c x 8 d positions so z and the twiddle are read in whole
// 32-byte sectors and the output in half sectors.  The decode launch is
// latency: q blocks of O(m^2) work (one thread walks the locator
// product), then m*N stores per request.
//
// Precision.  Each entry has a *_bf16 twin (precision="bf16"): the
// tables of A and B, W, the recombine twiddle and F_m in bfloat16 (TW),
// widened to f32 as they load.  The payload, G, D, the decode launch and
// the intermediates stay f32.

#include "bucket.cuh"
#include "fft_cols.cuh"

namespace {

constexpr int kCodeThreads = 256;
constexpr int kTileD = 8;                        // d positions per row
constexpr int kTileC = kCodeThreads / kTileD;    // c positions per block

// Phase 3.  Grid: (ceil(B/kTileD), ceil(A/kTileC), q).  Shared memory:
// G (n, m), this request's D (m, n) and F_m (m, m), planar.
template <int MM, class TW>
__global__ void __launch_bounds__(kCodeThreads)
stream_code_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                   const float* __restrict__ dr, const float* __restrict__ di,
                   const float* __restrict__ gr, const float* __restrict__ gi,
                   const TW* __restrict__ twr, const TW* __restrict__ twi,
                   const TW* __restrict__ fmr, const TW* __restrict__ fmi,
                   float* __restrict__ outr,
                   float* __restrict__ outi, int n, int m, int A, int B) {
  extern __shared__ float smem[];
  float* gs_r = smem;          float* gs_i = gs_r + n * m;
  float* d_r = gs_i + n * m;   float* d_i = d_r + m * n;
  float* fm_r = d_i + m * n;   float* fm_i = fm_r + m * m;
  const long long q = blockIdx.z;
  const int L = A * B;
  const long long s = (long long)m * L;
  for (int t = threadIdx.x; t < n * m; t += blockDim.x) {
    gs_r[t] = gr[t];
    gs_i[t] = gi[t];
    d_r[t] = dr[q * m * n + t];
    d_i[t] = di[q * m * n + t];
  }
  for (int t = threadIdx.x; t < m * m; t += blockDim.x) {
    fm_r[t] = widen(fmr[t]);
    fm_i[t] = widen(fmi[t]);
  }
  __syncthreads();
  const int d = blockIdx.x * kTileD + threadIdx.x % kTileD;
  const int c = blockIdx.y * kTileC + threadIdx.x / kTileD;
  if (c >= A || d >= B) return;
  const float* zq_r = zr + q * s;
  const float* zq_i = zi + q * s;
  float tr[MM], ti[MM], hr[MM], hi[MM];
#pragma unroll
  for (int i = 0; i < MM; ++i) {
    hr[i] = hi[i] = 0.f;
    if (i < m) {
      const long long off = ((long long)c * m + i) * B + d;  // Z_i[c][d]
      tr[i] = zq_r[off];
      ti[i] = zq_i[off];
    }
  }
#pragma unroll 1
  for (int r = 0; r < n; ++r) {
    float br = 0.f, bi = 0.f;  // worker r's result b = G[r] . t
#pragma unroll
    for (int i = 0; i < MM; ++i)
      if (i < m) cmac(br, bi, gs_r[r * m + i], gs_i[r * m + i], tr[i], ti[i]);
#pragma unroll
    for (int j = 0; j < MM; ++j)  // decode: c^ += D[:, r] * b
      if (j < m) cmac(hr[j], hi[j], d_r[j * n + r], d_i[j * n + r], br, bi);
  }
  const int lp = c * B + d;  // the position in the scrambled order
#pragma unroll
  for (int j = 0; j < MM; ++j) {
    if (j < m) {
      const float w_re = widen(twr[(long long)j * L + lp]);
      const float w_im = widen(twi[(long long)j * L + lp]);
      const float u = hr[j] * w_re - hi[j] * w_im;
      hi[j] = hr[j] * w_im + hi[j] * w_re;
      hr[j] = u;
    }
  }
  const long long l = c + (long long)d * A;  // natural payload index
#pragma unroll 1
  for (int jp = 0; jp < m; ++jp) {
    float accr = 0.f, acci = 0.f;
#pragma unroll
    for (int j = 0; j < MM; ++j)
      if (j < m) cmac(accr, acci, fm_r[jp * m + j], fm_i[jp * m + j], hr[j], hi[j]);
    outr[q * s + (long long)jp * L + l] = accr;
    outi[q * s + (long long)jp * L + l] = acci;
  }
}

constexpr int kDecodeThreads = 128;

// Phase 0 (masked mode).  Grid: (q).  Shared memory: block_subset_decode's
// DecodeSmem, 6*m*m + 4*m + 2 floats and m ints.  Writes this request's
// (m, n) scatter decode planes D[i][k] = inv(G[subset])[i][j] where
// subset_j = k, and 0 in the other n - m columns.
__global__ void __launch_bounds__(kDecodeThreads)
stream_decode_kernel(const float* __restrict__ mk,
                     const int* __restrict__ perm,
                     const float* __restrict__ gr,
                     const float* __restrict__ gi, float* __restrict__ dr,
                     float* __restrict__ di, int n, int m, float ntau) {
  extern __shared__ float smem[];
  const int mm = m * m;
  DecodeSmem d;
  d.gs_r = smem;           d.gs_i = d.gs_r + mm;
  d.pw_r = d.gs_i + mm;    d.pw_i = d.pw_r + mm;
  d.qm_r = d.pw_i + mm;    d.qm_i = d.qm_r + mm;
  d.loc_r = d.qm_i + mm;   d.loc_i = d.loc_r + (m + 1);
  d.nd_r = d.loc_i + (m + 1);
  d.nd_i = d.nd_r + m;
  d.sub = reinterpret_cast<int*>(d.nd_i + m);
  const long long q = blockIdx.x;
  block_subset_decode(mk + q * n, perm, gr, gi, n, m, ntau, d);
  float* dq_r = dr + q * m * n;
  float* dq_i = di + q * m * n;
  for (int e = threadIdx.x; e < m * n; e += blockDim.x) {
    const int i = e / n, k = e % n;
    float vr = 0.f, vi = 0.f;
    for (int j = 0; j < m; ++j) {
      if (d.sub[j] == k) {
        vr = d.qm_r[i * m + j];
        vi = d.qm_i[i * m + j];
      }
    }
    dq_r[e] = vr;
    dq_i[e] = vi;
  }
}

template <int MM, class TW>
int launch_code(const float* zr, const float* zi, const float* dr,
                const float* di, const float* gr, const float* gi,
                const TW* twr, const TW* twi, const TW* fmr, const TW* fmi,
                float* outr, float* outi, int q, int n, int m, int a, int b,
                cudaStream_t st) {
  const size_t smem = (size_t)(4 * n * m + 2 * m * m) * sizeof(float);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_code_kernel<MM, TW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((b + kTileD - 1) / kTileD),
                  (unsigned)((a + kTileC - 1) / kTileC), (unsigned)q);
  stream_code_kernel<MM, TW><<<grid, kCodeThreads, smem, st>>>(
      zr, zi, dr, di, gr, gi, twr, twi, fmr, fmi, outr, outi, n, m, a, b);
  return (int)cudaGetLastError();
}

// Phases 1-3 on the (q, m, n) decode planes d.  sa: the column FFT plan
// of a over b*m columns; sb: the row FFT plan of b.
template <class TW>
int launch_phases(const float* xr, const float* xi, const float* dr,
                  const float* di, const float* gr, const float* gi,
                  const TW* wr, const TW* wi, const TW* tar, const TW* tai,
                  const TW* tbr, const TW* tbi, const TW* twr,
                  const TW* twi, const TW* fmr, const TW* fmi, float* t1r,
                  float* t1i, float* zr,
                  float* zi, float* outr, float* outi, int q, int n, int m,
                  const fft_cols::FftSpec& sa, const fft_cols::FftSpec& sb,
                  cudaStream_t st) {
  const int a = sa.n, b = sb.n;
  // 1. column FFT over the interleaved (a, b*m) view, twiddle W[c][bb] on
  //    every shard, shards out as (a, m, b)
  int err = fft_cols::launch(xr, xi, t1r, t1i, tar, tai, wr, wi, q, b * m, m,
                             false, sa, st);
  if (err != 0) return err;
  // 2. row FFT of the (q*a*m) b-point rows
  err = fft_rows::launch(t1r, t1i, zr, zi, tbr, tbi, (long long)q * a * m,
                         b, sb.radix, sb.passes, sb.tile, sb.layout, st);
  if (err != 0) return err;
  // 3. encode, decode, recombine, natural order
  if (m <= 4)
    return launch_code<4, TW>(zr, zi, dr, di, gr, gi, twr, twi, fmr, fmi, outr,
                          outi, q, n, m, a, b, st);
  if (m <= 8)
    return launch_code<8, TW>(zr, zi, dr, di, gr, gi, twr, twi, fmr, fmi, outr,
                          outi, q, n, m, a, b, st);
  if (m <= 16)
    return launch_code<16, TW>(zr, zi, dr, di, gr, gi, twr, twi, fmr, fmi, outr,
                           outi, q, n, m, a, b, st);
  if (m <= 32)
    return launch_code<32, TW>(zr, zi, dr, di, gr, gi, twr, twi, fmr, fmi, outr,
                           outi, q, n, m, a, b, st);
  return (int)cudaErrorInvalidValue;
}

// Masked mode: the decode launch, then the three phases.
template <class TW>
int masked_phases(const float* xr, const float* xi, const float* masks,
                  const int* perm, const float* gr, const float* gi,
                  const TW* wr, const TW* wi, const TW* tar, const TW* tai,
                  const TW* tbr, const TW* tbi, const TW* twr,
                  const TW* twi, const TW* fmr, const TW* fmi, float* dr,
                  float* di, float* t1r, float* t1i, float* zr, float* zi,
                  float* outr, float* outi, int q, int n, int m, float ntau,
                  const fft_cols::FftSpec* sa, const fft_cols::FftSpec* sb,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 1 || m > 32) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(6 * m * m + 4 * m + 2) * sizeof(float) +
                      (size_t)m * sizeof(int);
  stream_decode_kernel<<<q, kDecodeThreads, smem, st>>>(masks, perm, gr, gi,
                                                        dr, di, n, m, ntau);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_phases(xr, xi, dr, di, gr, gi, wr, wi, tar, tai, tbr, tbi,
                       twr, twi, fmr, fmi, t1r, t1i, zr, zi, outr, outi, q, n,
                       m, *sa, *sb, st);
}

}  // namespace

using bf16 = __nv_bfloat16;

// x: (q, s) planes; d: (q, m, n) scatter decode planes; g: (n, m);
// w: (a, b); ta, tb: the (a,) and (b,) tables of w^t; tw: (m, a*b)
// pre-scrambled; fm: (m, m); t1, z: (q, s) scratch; out: (q, s); sa, sb:
// the plans of launch_phases, in host memory.  w, ta, tb, tw and fm are
// f32 here, bf16 in the _bf16 twin.  m in [1, 32], q at most 65,535 and
// 4*(4*n*m + 2*m*m) bytes within the opt-in shared memory: the wrapper
// checks.  Returns the first nonzero cudaGetLastError() of the three
// launches.
extern "C" int coded_bucket_streaming_f32(
    const float* xr, const float* xi, const float* dr, const float* di,
    const float* gr, const float* gi, const float* wr, const float* wi,
    const float* tar, const float* tai, const float* tbr, const float* tbi,
    const float* twr, const float* twi, const float* fmr, const float* fmi,
    float* t1r, float* t1i, float* zr, float* zi, float* outr, float* outi,
    int q, int n, int m, const fft_cols::FftSpec* sa,
    const fft_cols::FftSpec* sb, void* stream) {
  return launch_phases(xr, xi, dr, di, gr, gi, wr, wi, tar, tai, tbr, tbi,
                       twr, twi, fmr, fmi, t1r, t1i, zr, zi, outr, outi, q, n,
                       m, *sa, *sb, (cudaStream_t)stream);
}

extern "C" int coded_bucket_streaming_bf16(
    const float* xr, const float* xi, const float* dr, const float* di,
    const float* gr, const float* gi, const bf16* wr, const bf16* wi,
    const bf16* tar, const bf16* tai, const bf16* tbr, const bf16* tbi,
    const bf16* twr, const bf16* twi, const bf16* fmr, const bf16* fmi,
    float* t1r, float* t1i, float* zr, float* zi, float* outr, float* outi,
    int q, int n, int m, const fft_cols::FftSpec* sa,
    const fft_cols::FftSpec* sb, void* stream) {
  return launch_phases(xr, xi, dr, di, gr, gi, wr, wi, tar, tai, tbr, tbi,
                       twr, twi, fmr, fmi, t1r, t1i, zr, zi, outr, outi, q, n,
                       m, *sa, *sb, (cudaStream_t)stream);
}

// Masked mode: masks (q, n) float (nonzero = responded); perm (m,) int32,
// the locator's factor order; ntau = -2*pi/n as float; dr, di: (q, m, n)
// scratch for the decode planes; the rest as coded_bucket_streaming_f32.
// Same checks by the wrapper.  Returns the first nonzero
// cudaGetLastError() of the four launches.
extern "C" int coded_bucket_streaming_masked_f32(
    const float* xr, const float* xi, const float* masks, const int* perm,
    const float* gr, const float* gi, const float* wr, const float* wi,
    const float* tar, const float* tai, const float* tbr, const float* tbi,
    const float* twr, const float* twi, const float* fmr, const float* fmi,
    float* dr, float* di, float* t1r, float* t1i, float* zr, float* zi,
    float* outr, float* outi, int q, int n, int m, float ntau,
    const fft_cols::FftSpec* sa, const fft_cols::FftSpec* sb,
    void* stream) {
  return masked_phases(xr, xi, masks, perm, gr, gi, wr, wi, tar, tai, tbr,
                       tbi, twr, twi, fmr, fmi, dr, di, t1r, t1i, zr, zi,
                       outr, outi, q, n, m, ntau, sa, sb, stream);
}

extern "C" int coded_bucket_streaming_masked_bf16(
    const float* xr, const float* xi, const float* masks, const int* perm,
    const float* gr, const float* gi, const bf16* wr, const bf16* wi,
    const bf16* tar, const bf16* tai, const bf16* tbr, const bf16* tbi,
    const bf16* twr, const bf16* twi, const bf16* fmr, const bf16* fmi,
    float* dr, float* di, float* t1r, float* t1i, float* zr, float* zi,
    float* outr, float* outi, int q, int n, int m, float ntau,
    const fft_cols::FftSpec* sa, const fft_cols::FftSpec* sb,
    void* stream) {
  return masked_phases(xr, xi, masks, perm, gr, gi, wr, wi, tar, tai, tbr,
                       tbi, twr, twi, fmr, fmi, dr, di, t1r, t1i, zr, zi,
                       outr, outi, q, n, m, ntau, sa, sb, stream);
}
