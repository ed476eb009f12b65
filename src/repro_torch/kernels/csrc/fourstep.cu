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
// traffic, and for the 4096-point plan (512 rows of L = 1024: 8.4 MB,
// 0.0025 ms at 3.35 TB/s) about 0.0004 ms against 0.0025 ms.
//
// Design.  fourstep_fused is fft_block.cuh's kernel with the two-factor
// store: one block takes fft_rows_per_block(L) whole rows (two at
// L = 1024), runs the row FFT's Stockham passes over each row in shared
// memory from the L-point f32 table of w^t -- no column pass, no twiddle
// pass, no F_A, W or F_B read on the card: the table's entries are
// theirs, bit for bit -- and stores out[c*B + d] = X[c + d*A], the
// reference's scrambled order, reading the natural row at c + d*A.
// multistep_fused's block mode is the same kernel with the k-digit store
// (multistep.cu).  Its working set is fourstep_fft.fft_block_layout(L),
// which fits one block wherever the fused gate (ops.fourstep_fusable, the
// dense design's 16*L bytes against 232,448: L up to 14,528) admits a
// row; the gate itself is unchanged, so no length changed route.
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
#include "fft_block.cuh"
#include "fft_cols.cuh"

// Each entry comes twice: *_f32 on the f32 tables and planes, *_bf16 on
// their bfloat16 twins (precision="bf16": the tables of w^t and the
// twiddle W rounded to bf16, widened as the kernels load them).  The
// payload and the output are f32 in both.
using bf16 = __nv_bfloat16;

namespace {

template <class TW>
int fused(const float* xr, const float* xi, const TW* twr, const TW* twi,
          float* outr, float* outi, long long batch, int a, int b,
          const int* radix, int passes, int rows, const long long* layout,
          void* stream) {
  const int factors[2] = {a, b};
  return fft_block::launch(xr, xi, outr, outi, twr, twi, batch, factors, 2,
                           radix, passes, rows, layout,
                           (cudaStream_t)stream);
}

template <class TW>
int stage1(const float* xr, const float* xi, const TW* wr, const TW* wi,
           const TW* tar, const TW* tai, float* outr, float* outi,
           long long batch, int b, const fft_cols::FftSpec* sa,
           void* stream) {
  return fft_cols::launch(xr, xi, outr, outi, tar, tai, wr, wi, batch, b, 1,
                          false, *sa, (cudaStream_t)stream);
}

template <class TW>
int streaming(const float* xr, const float* xi, const TW* wr, const TW* wi,
              const TW* tar, const TW* tai, const TW* tbr, const TW* tbi,
              float* t1r, float* t1i, float* outr, float* outi,
              long long batch, const fft_cols::FftSpec* sa,
              const fft_cols::FftSpec* sb, void* stream) {
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

}  // namespace

// x, out: (batch, a, b) planes; tw: the (a*b,) table of w^t; radix:
// the row FFT's `passes` radices (product a*b); rows: rows a block takes;
// layout: the 4 words of fourstep_fft.fft_block_layout (host memory).
// out[z][c][d] = X_z[c + d*a].  One launch.
extern "C" int fourstep_fused_f32(const float* xr, const float* xi,
                                  const float* twr, const float* twi,
                                  float* outr, float* outi, long long batch,
                                  int a, int b, const int* radix, int passes,
                                  int rows, const long long* layout,
                                  void* stream) {
  return fused(xr, xi, twr, twi, outr, outi, batch, a, b, radix, passes,
               rows, layout, stream);
}

extern "C" int fourstep_fused_bf16(const float* xr, const float* xi,
                                   const bf16* twr, const bf16* twi,
                                   float* outr, float* outi, long long batch,
                                   int a, int b, const int* radix, int passes,
                                   int rows, const long long* layout,
                                   void* stream) {
  return fused(xr, xi, twr, twi, outr, outi, batch, a, b, radix, passes,
               rows, layout, stream);
}

// Column pass: out[z] = (F_A @ x[z]) * W for z < batch.  x, out:
// (batch, a, b) with a = sa->n; w: (a, b); ta: the (a,) table of w^t; sa:
// the column FFT plan of a over b columns (host memory).  One launch.
extern "C" int fourstep_stage1_f32(const float* xr, const float* xi,
                                   const float* wr, const float* wi,
                                   const float* tar, const float* tai,
                                   float* outr, float* outi, long long batch,
                                   int b, const fft_cols::FftSpec* sa,
                                   void* stream) {
  return stage1(xr, xi, wr, wi, tar, tai, outr, outi, batch, b, sa, stream);
}

extern "C" int fourstep_stage1_bf16(const float* xr, const float* xi,
                                    const bf16* wr, const bf16* wi,
                                    const bf16* tar, const bf16* tai,
                                    float* outr, float* outi,
                                    long long batch, int b,
                                    const fft_cols::FftSpec* sa,
                                    void* stream) {
  return stage1(xr, xi, wr, wi, tar, tai, outr, outi, batch, b, sa, stream);
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

extern "C" int fourstep_stage2_bf16(const float* tr, const float* ti,
                                    const bf16* twr, const bf16* twi,
                                    float* outr, float* outi,
                                    long long n_rows, int b, const int* radix,
                                    int passes, int rows,
                                    const long long* layout, void* stream) {
  return fft_rows::launch(tr, ti, outr, outi, twr, twi, n_rows, b, radix,
                          passes, rows, layout, (cudaStream_t)stream);
}

// Streaming four-step: out[z] = (((F_A @ x[z]) * W) @ F_B)^T for
// z < batch, natural order: out (batch, b, a) with out[z][d][c] =
// X[d*a + c].  x: (batch, a, b); w: (a, b); ta, tb: the (a,) and (b,)
// tables of w^t; t1: (batch, b, a) scratch; sa, sb: the column FFT plans
// of a (over b columns) and b (over a columns), in host memory.  Two
// launches; returns the first nonzero cudaGetLastError().
extern "C" int fourstep_streaming_f32(const float* xr, const float* xi,
                                      const float* wr, const float* wi,
                                      const float* tar, const float* tai,
                                      const float* tbr, const float* tbi,
                                      float* t1r, float* t1i, float* outr,
                                      float* outi, long long batch,
                                      const fft_cols::FftSpec* sa,
                                      const fft_cols::FftSpec* sb,
                                      void* stream) {
  return streaming(xr, xi, wr, wi, tar, tai, tbr, tbi, t1r, t1i, outr, outi,
                   batch, sa, sb, stream);
}

extern "C" int fourstep_streaming_bf16(const float* xr, const float* xi,
                                       const bf16* wr, const bf16* wi,
                                       const bf16* tar, const bf16* tai,
                                       const bf16* tbr, const bf16* tbi,
                                       float* t1r, float* t1i, float* outr,
                                       float* outi, long long batch,
                                       const fft_cols::FftSpec* sa,
                                       const fft_cols::FftSpec* sb,
                                       void* stream) {
  return streaming(xr, xi, wr, wi, tar, tai, tbr, tbi, t1r, t1i, outr, outi,
                   batch, sa, sb, stream);
}
