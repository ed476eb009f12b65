// Batched four-step DFT of a length-L shard, L = A * B, on planar float32.
//
// Replaces four TPU kernels of the JAX package's kernels/fourstep_fft.py:
// fourstep_fused (one launch, the whole A x B matrix of a row on chip),
// the two-pass pair fourstep_stage1 (column DFT + twiddle) and
// fourstep_stage2 (row DFT), and fourstep_streaming (rows past one
// block, natural-order output).  For every batch row, with
// M[a, b] = x[a*B + b]:
//
//   T1 = (F_A @ M) * W        column pass: A-point DFTs + twiddle
//   out = T1 @ F_B            row pass:    B-point DFTs
//
// and out[c, d] holds X[c + d*A], the reference's scrambled order (the
// dispatch layer unscrambles with one transpose).  fourstep_streaming
// writes the row pass transposed instead, out[d][c] = X[d*A + c]: the
// natural order, with no unscramble pass after it.
//
// What bounds it on the H100: bytes.  Counted as an FFT (5*L*log2(L)
// flops per row), the work is far below the traffic of reading the input
// and writing the output once: for the 2^20-point plan (128 rows of
// L = 2^18) that is about 0.05 ms of FP32 work against 0.16 ms of
// traffic, and for the 4096-point plan (512 rows of L = 1024) about
// 0.0004 ms against 0.0025 ms.  fourstep_fused's passes are dense DFTs,
// 8*L*(A + B) flops per row, about 10x an FFT's at L = 1024.
//
// Design.  fourstep_fused runs one block per batch row: it stages the
// row's A x B matrix in shared memory, writes the column pass into a
// second shared buffer, and streams the row pass straight to the output.
// F_A, W and F_B are read from global memory, where they are small and
// stay in L2.  The shared working set (two A x B complex planes, 16*A*B
// bytes) is laid out by fourstep_fft.fourstep_layout on the Python side,
// which passes the word offsets in at launch; the same reckoning is the
// fused gate (ops.fourstep_fusable, against 232,448 bytes), so shards up
// to L = 8192 fuse and longer ones take the two-pass route.
//
// The two-pass route and fourstep_streaming run no dense DFT.  Their
// passes are the shared-memory Stockham FFTs of fft_cols.cuh (A points
// down tiles of TC columns) and fft_rows.cuh (B-point rows, ceil(2048/B)
// a block), their radix plans and working sets passed in at launch
// (fourstep_fft.fft_cols_spec / fft_rows_spec), one f32 table of w^t in
// place of each DFT plane.  fourstep_stage1 is one column FFT over the
// batch's (A, B) matrices (ld = B) with W folded into its last pass and
// the plain store, T1 (batch, A, B): its 1-D grid of batch * tiles
// blocks takes any batch in one launch.  fourstep_stage2 is the row FFT
// of T1's batch*A rows.  T1 sits in device memory between the two
// launches.
//
// fourstep_streaming's launch 1 transforms the columns of x (ld = B),
// folds W into the last pass and stores transposed: T1^T (batch, B, A),
// one contiguous run a tile.  Launch 2 transforms the columns of T1^T
// (ld = A) and stores them in place: out[d][c] = X[d*A + c], natural
// order, TC-float runs.  Both launches read TC-float runs (32 bytes at
// A = B = 512).  The other way -- fft_rows.cuh over T1's rows with a
// transposed store -- would write runs of one block's rows: 4 rows of
// B = 512, 16 bytes, half a sector.  The TPU kernel streams both passes
// through VMEM tiles inside one launch; here the pass boundary needs
// every block of the column pass done, so it is a launch boundary.

#include <cstring>

#include "common.cuh"
#include "fft_cols.cuh"

namespace {

// Word offsets of the fused kernel's shared arrays, then the total, in
// this order; the caller computes them (fourstep_fft.fourstep_layout).
struct FusedLayout {
  long long x, t1, total;
};

constexpr int kFusedThreads = 256;

__global__ void __launch_bounds__(kFusedThreads)
fourstep_fused_kernel(const float* __restrict__ xr,
                      const float* __restrict__ xi,
                      const float* __restrict__ far,
                      const float* __restrict__ fai,
                      const float* __restrict__ wr,
                      const float* __restrict__ wi,
                      const float* __restrict__ fbr,
                      const float* __restrict__ fbi, float* __restrict__ outr,
                      float* __restrict__ outi, int A, int B, FusedLayout o) {
  extern __shared__ float smem[];
  const int L = A * B;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* x_r = smem + o.x;
  float* x_i = x_r + L;
  float* t_r = smem + o.t1;
  float* t_i = t_r + L;
  const long long base = (long long)blockIdx.x * L;

  for (int t = tid; t < L; t += nt) {
    x_r[t] = xr[base + t];
    x_i[t] = xi[base + t];
  }
  __syncthreads();
  for (int t = tid; t < L; t += nt) {  // T1 = (F_A @ M) * W
    const int c = t / B, bb = t % B;
    float accr = 0.f, acci = 0.f;
    for (int a = 0; a < A; ++a)
      cmac(accr, acci, far[c * A + a], fai[c * A + a], x_r[a * B + bb],
           x_i[a * B + bb]);
    const float w_r = wr[t], w_i = wi[t];
    t_r[t] = accr * w_r - acci * w_i;
    t_i[t] = accr * w_i + acci * w_r;
  }
  __syncthreads();
  for (int t = tid; t < L; t += nt) {  // out = T1 @ F_B
    const int c = t / B, d = t % B;
    float accr = 0.f, acci = 0.f;
    for (int bb = 0; bb < B; ++bb)
      cmac(accr, acci, t_r[c * B + bb], t_i[c * B + bb], fbr[bb * B + d],
           fbi[bb * B + d]);
    outr[base + t] = accr;
    outi[base + t] = acci;
  }
}

}  // namespace

// x, out: (batch, a, b) planes; fa: (a, a); w: (a, b); fb: (b, b);
// layout: the 3 words of FusedLayout, in host memory.  One launch.
extern "C" int fourstep_fused_f32(const float* xr, const float* xi,
                                  const float* far, const float* fai,
                                  const float* wr, const float* wi,
                                  const float* fbr, const float* fbi,
                                  float* outr, float* outi, int batch, int a,
                                  int b, const long long* layout,
                                  void* stream) {
  FusedLayout o;
  memcpy(&o, layout, sizeof(FusedLayout));
  const size_t smem = (size_t)o.total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fourstep_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fourstep_fused_kernel<<<batch, kFusedThreads, smem,
                          (cudaStream_t)stream>>>(xr, xi, far, fai, wr, wi,
                                                  fbr, fbi, outr, outi, a, b,
                                                  o);
  return (int)cudaGetLastError();
}

// Column pass: out[z] = (F_A @ x[z]) * W for z < batch.  x, out:
// (batch, a, b) with a = sa->n; w: (a, b); ta: the (a,) f32 table of
// w^t; sa: the column FFT plan of a over b columns (host memory).  One
// launch.
extern "C" int fourstep_stage1_f32(const float* xr, const float* xi,
                                   const float* wr, const float* wi,
                                   const float* tar, const float* tai,
                                   float* outr, float* outi, long long batch,
                                   int b, const fft_cols::FftSpec* sa,
                                   void* stream) {
  return fft_cols::launch(xr, xi, outr, outi, tar, tai, wr, wi, batch, b, 1,
                          false, *sa, (cudaStream_t)stream);
}

// Row pass: out[row] = DFT_b(t[row]) for the n_rows contiguous b-point
// rows of t (the (batch, a, b) column-pass result: n_rows = batch*a), in
// natural order -- t @ F_B.  tw: the (b,) planes of w^t; radix: the
// plan's `passes` radices; rows: rows a block takes; layout: the 4 words
// of fft_rows::Layout (host memory).  One launch.
extern "C" int fourstep_stage2_f32(const float* tr, const float* ti,
                                   const float* twr, const float* twi,
                                   float* outr, float* outi, long long n_rows,
                                   int b, const int* radix, int passes,
                                   int rows, const long long* layout,
                                   void* stream) {
  return fft_rows::launch(tr, ti, outr, outi, twr, twi, n_rows, b, radix,
                          passes, rows, layout, (cudaStream_t)stream);
}

// Streaming four-step: out[z] = (((F_A @ x[z]) * W) @ F_B)^T for
// z < batch, natural order: out (batch, b, a) with out[z][d][c] =
// X[d*a + c].  x: (batch, a, b); w: (a, b); ta, tb: the (a,) and (b,)
// f32 tables of w^t; t1: (batch, b, a) scratch; sa, sb: the column FFT
// plans of a (over b columns) and b (over a columns), in host memory.
// Two launches; returns the first nonzero cudaGetLastError().
extern "C" int fourstep_streaming_f32(const float* xr, const float* xi,
                                      const float* wr, const float* wi,
                                      const float* tar, const float* tai,
                                      const float* tbr, const float* tbi,
                                      float* t1r, float* t1i, float* outr,
                                      float* outi, long long batch,
                                      const fft_cols::FftSpec* sa,
                                      const fft_cols::FftSpec* sb,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int a = sa->n, b = sb->n;
  // T1^T = ((F_A @ x) * W)^T: the columns of x, stored transposed
  int err = fft_cols::launch(xr, xi, t1r, t1i, tar, tai, wr, wi, batch, b, 1,
                             true, *sa, st);
  if (err != 0) return err;
  // out = (T1 @ F_B)^T: the columns of T1^T, stored in place
  return fft_cols::launch(t1r, t1i, outr, outi, tbr, tbi, nullptr, nullptr,
                          batch, a, 1, false, *sb, st);
}
