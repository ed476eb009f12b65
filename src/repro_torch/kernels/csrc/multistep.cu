// Mixed-radix (multistep) four-step DFT of a length-L row, L = f1*...*fk,
// on planar float32.
//
// Replaces the TPU kernel multistep_fused of the JAX package's
// kernels/fourstep_fft.py: k stages over a row held on chip, one launch.
// Stage i splits what is left of the row as (lead, f, rest),
// lead = f1*...*f(i-1), rest = f(i+1)*...*fk, and computes
//
//   out[lead, c, r] = tw[c, r] * sum_j F[c, j] * x[lead, j, r]
//
// with F the (f, f) DFT and tw the (f, rest) inter-stage twiddle (none on
// the last stage).  After k stages the row holds the scrambled digit
// order X[c1 + f1*c2 + f1*f2*c3 + ...] at flat (c1, ..., ck), as the TPU
// kernel leaves it; the dispatch layer unscrambles with one permute.
//
// What bounds it on the H100: bytes.  Counted as an FFT (5*L*log2(L)
// flops per row) the work is below the traffic of reading the input and
// writing the output once: 512 rows of L = 1024 move 8.4 MB (0.0025 ms
// at 3.35 TB/s) for 0.0004 ms of FP32 work, 128 rows of L = 2^18 move
// 537 MB (0.16 ms) for 0.045 ms.
//
// Design.  Two modes, chosen on the Python side from the plan alone
// (fourstep_fft.multistep_mode):
//
// * Block mode, one launch, where the row fits one block: the kernel of
//   fft_block.cuh, the one fourstep_fused runs, with the plan's k-digit
//   store.  Each block runs the row FFT's Stockham passes over whole rows
//   in shared memory from the L-point f32 table of w^t, whose entries
//   are those of every stage's (f, f) DFT plane and (f, rest) twiddle,
//   bit for bit -- the card reads none of those planes -- and stores the
//   natural row at X[c1 + f1*c2 + f1*f2*c3 + ...] into flat (c1, ..., ck).
//   The k stages of the reference differ from one another only in that
//   store.  The working set is fourstep_fft.fft_block_layout(L); the
//   block-mode gate stays the dense design's reckoning
//   (fourstep_fft.multistep_layout: the row, its ping-pong and every
//   stage's DFT planes against 232,448 bytes), so no plan changed mode.
// * Per-stage mode, k launches through a device ping-pong (the output and
//   one scratch pair), where the row does not fit: stage i < k is one
//   launch of fft_cols.cuh's column FFT over the (lead, f, rest) view
//   (f points down rest columns of each lead, the (f, rest) twiddle
//   applied as its last pass stores, the plain store), and the last stage
//   (rest = 1) one launch of fft_rows.cuh's row FFT over the lead rows
//   of f points.  Each reads and writes the rows once, with no dense DFT:
//   the stage's DFT comes from the f32 table of w_f^t
//   (fourstep_fft.fft_rows_twiddles), bit for bit the entries of its F
//   plane, which the card does not read.  The plans and the tables' word
//   offsets come from fourstep_fft.fft_cols_spec / fft_rows_spec.  The
//   TPU kernel keeps a 2 MiB row (L = 2^18) in VMEM for all stages; here
//   a stage needs the whole previous stage done, so the stage boundary is
//   a launch boundary.
//
// FP32 on CUDA cores with FP32 accumulation.

#include <cstring>

#include "common.cuh"
#include "fft_block.cuh"
#include "fft_cols.cuh"

constexpr int kMaxStages = 32;  // fourstep_fft.MAX_STAGES

// Each entry comes twice: *_f32 on the f32 tables and twiddle planes,
// *_bf16 on their bfloat16 twins (precision="bf16"); payload f32 in both.
using bf16 = __nv_bfloat16;

namespace {

template <class TW>
int stages(const float* xr, const float* xi, float* outr, float* outi,
           float* tr, float* ti, const void* const* tables,
           const void* const* twiddles, const fft_cols::FftSpec* specs,
           int k, long long batch, void* stream) {
  if (k < 1 || k > kMaxStages) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  long long L = 1;
  for (int s = 0; s < k; ++s) L *= specs[s].n;
  const float* sr = xr;
  const float* si = xi;
  long long n_lead = batch, rest = L;
  for (int s = 0; s < k; ++s) {
    const fft_cols::FftSpec& spec = specs[s];
    const int f = spec.n;
    rest /= f;
    const bool to_out = (k - 1 - s) % 2 == 0;
    float* dr = to_out ? outr : tr;
    float* di = to_out ? outi : ti;
    const TW* tbr = (const TW*)tables[2 * s];
    const TW* tbi = (const TW*)tables[2 * s + 1];
    int err;
    if (s + 1 < k) {
      if (rest > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      err = fft_cols::launch(sr, si, dr, di, tbr, tbi,
                             (const TW*)twiddles[2 * s],
                             (const TW*)twiddles[2 * s + 1], n_lead,
                             (int)rest, 1, false, spec, st);
    } else {
      err = fft_rows::launch(sr, si, dr, di, tbr, tbi, n_lead, f,
                             spec.radix, spec.passes, spec.tile, spec.layout,
                             st);
    }
    if (err != 0) return err;
    sr = dr;
    si = di;
    n_lead *= f;
  }
  return 0;
}

}  // namespace

// Block mode, one launch.  x, out: (batch, L) planes, L = prod(factors);
// tw: the (L,) table of w^t; radix: the row FFT's `passes` radices
// (product L); rows: rows a block takes; layout: the 4 words of
// fourstep_fft.fft_block_layout (host memory).  Returns the CUDA error.
extern "C" int multistep_block_f32(const float* xr, const float* xi,
                                   float* outr, float* outi,
                                   const float* twr, const float* twi,
                                   const int* factors, int k,
                                   long long batch, const int* radix,
                                   int passes, int rows,
                                   const long long* layout, void* stream) {
  return fft_block::launch(xr, xi, outr, outi, twr, twi, batch, factors, k,
                           radix, passes, rows, layout,
                           (cudaStream_t)stream);
}

extern "C" int multistep_block_bf16(const float* xr, const float* xi,
                                    float* outr, float* outi,
                                    const bf16* twr, const bf16* twi,
                                    const int* factors, int k,
                                    long long batch, const int* radix,
                                    int passes, int rows,
                                    const long long* layout, void* stream) {
  return fft_block::launch(xr, xi, outr, outi, twr, twi, batch, factors, k,
                           radix, passes, rows, layout,
                           (cudaStream_t)stream);
}

// Per-stage mode, k launches.  x, out, t: (batch, L) planes (t scratch);
// tables: 2k device pointers, the (f,) table of w_f^t of each stage;
// twiddles: 2(k - 1) device pointers, the (f, rest) twiddle planes of
// every stage but the last; specs: the k stage plans in host memory
// (fourstep_fft.fft_cols_spec(f, rest) for stage i < k, fft_rows_spec(f)
// for the last).  The stages alternate between out and t so that the
// last lands in out.  Returns the first nonzero CUDA error.
extern "C" int multistep_stages_f32(const float* xr, const float* xi,
                                    float* outr, float* outi, float* tr,
                                    float* ti, const void* const* tables,
                                    const void* const* twiddles,
                                    const fft_cols::FftSpec* specs, int k,
                                    long long batch, void* stream) {
  return stages<float>(xr, xi, outr, outi, tr, ti, tables, twiddles, specs,
                       k, batch, stream);
}

extern "C" int multistep_stages_bf16(const float* xr, const float* xi,
                                     float* outr, float* outi, float* tr,
                                     float* ti, const void* const* tables,
                                     const void* const* twiddles,
                                     const fft_cols::FftSpec* specs, int k,
                                     long long batch, void* stream) {
  return stages<bf16>(xr, xi, outr, outi, tr, ti, tables, twiddles, specs,
                      k, batch, stream);
}
