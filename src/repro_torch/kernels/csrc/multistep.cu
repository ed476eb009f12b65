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
// writing the output once: 512 rows of L = 1024 move 8.4 MB (0.0025 ms)
// for 0.0004 ms of FP32 work, 128 rows of L = 2^18 move 537 MB (0.16 ms)
// for 0.045 ms.
//
// Design.  Two modes, chosen on the Python side from the plan alone
// (fourstep_fft.multistep_mode):
//
// * Block mode, one launch, where the row fits one block: the block
//   stages its row in shared memory, with a ping-pong buffer, and every
//   stage's (f, f) DFT planes; it runs the k stages in turn as dense DFTs
//   (8*L*sum(f) flops per row, 5.8x an FFT's for (16, 16, 4)) with a
//   barrier between them, and the last stage stores straight to the
//   output.  The twiddles are read from global memory (small, L2-
//   resident).  The working set is laid out by
//   fourstep_fft.multistep_layout, which passes the word offsets in at
//   launch; the same reckoning is the block-mode gate (232,448 bytes):
//   16 KiB a row at L = 1024, rows up to L ~ 14,000 fit.  A thread takes
//   one column and four consecutive outputs c where a lead's columns are
//   at least a warp wide, else one output, the lanes walking c.
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
#include "fft_cols.cuh"

namespace {

constexpr int kMaxStages = 32;    // fourstep_fft.MAX_STAGES
constexpr int kThreads = 256;
constexpr int kOutsPerThread = 4;  // outputs c per thread, wide columns
constexpr int kWide = 32;          // columns a warp reads coalesced

struct Plan {
  int k;
  int f[kMaxStages];
  const float* fr[kMaxStages];
  const float* fi[kMaxStages];
  const float* twr[kMaxStages];  // nullptr on the last stage
  const float* twi[kMaxStages];
};

// Word offsets of the block-mode shared arrays, in this order; the caller
// computes them (fourstep_fft.multistep_layout: x, y, F per stage, total).
struct BlockLayout {
  long long x, y, f[kMaxStages], total;
};

__device__ __forceinline__ void store_out(float accr, float acci, int c,
                                          int r, int rs,
                                          const float* __restrict__ twr,
                                          const float* __restrict__ twi,
                                          float* dr, float* di, int o) {
  if (twr != nullptr) {
    const int t = c * rs + r;
    const float w_r = twr[t], w_i = twi[t];
    const float o_r = accr * w_r - acci * w_i;
    acci = accr * w_i + acci * w_r;
    accr = o_r;
  }
  dr[o] = accr;
  di[o] = acci;
}

// One stage over a row of nl leads of (f, rs) complex values, index
// lead*f*rs + j*rs + r:
//   d[lead*f*rs + c*rs + r] =
//       tw[c*rs + r] * sum_j F[c*f + j] * x[lead*f*rs + j*rs + r]
// tw: the (f, rs) twiddle planes, or nullptr.  Threads tid, tid + nt, ...
__device__ void stage_tile(const float* xr, const float* xi, int nl, int f,
                           int rs, const float* fr, const float* fi,
                           const float* __restrict__ twr,
                           const float* __restrict__ twi, float* dr,
                           float* di, int tid, int nt) {
  const int cols = nl * rs;
  if (rs >= kWide) {
    const int groups = (f + kOutsPerThread - 1) / kOutsPerThread;
    for (int w = tid; w < cols * groups; w += nt) {
      const int col = w % cols, c0 = (w / cols) * kOutsPerThread;
      const int r = col % rs;
      const int base = (col / rs) * f * rs + r;
      float accr[kOutsPerThread], acci[kOutsPerThread];
#pragma unroll
      for (int u = 0; u < kOutsPerThread; ++u) accr[u] = acci[u] = 0.f;
      for (int j = 0; j < f; ++j) {
        const float x_r = xr[base + j * rs], x_i = xi[base + j * rs];
#pragma unroll
        for (int u = 0; u < kOutsPerThread; ++u) {
          if (c0 + u < f)
            cmac(accr[u], acci[u], fr[(c0 + u) * f + j],
                 fi[(c0 + u) * f + j], x_r, x_i);
        }
      }
#pragma unroll
      for (int u = 0; u < kOutsPerThread; ++u) {
        const int c = c0 + u;
        if (c < f)
          store_out(accr[u], acci[u], c, r, rs, twr, twi, dr, di,
                    base + c * rs);
      }
    }
  } else {
    for (int w = tid; w < cols * f; w += nt) {
      const int c = w % f, col = w / f;
      const int r = col % rs;
      const int base = (col / rs) * f * rs + r;
      float accr = 0.f, acci = 0.f;
      for (int j = 0; j < f; ++j)
        cmac(accr, acci, fr[j * f + c], fi[j * f + c], xr[base + j * rs],
             xi[base + j * rs]);
      store_out(accr, acci, c, r, rs, twr, twi, dr, di, base + c * rs);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
multistep_block_kernel(const float* __restrict__ xr,
                       const float* __restrict__ xi, float* __restrict__ outr,
                       float* __restrict__ outi, Plan p, BlockLayout o,
                       int L) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long row = (long long)blockIdx.x * L;
  for (int s = 0; s < p.k; ++s) {
    const int ff = p.f[s] * p.f[s];
    float* fr = smem + o.f[s];
    for (int t = tid; t < ff; t += nt) {
      fr[t] = p.fr[s][t];
      fr[ff + t] = p.fi[s][t];
    }
  }
  float* sr = smem + o.x;
  float* si = sr + L;
  float* dr = smem + o.y;
  float* di = dr + L;
  for (int t = tid; t < L; t += nt) {
    sr[t] = xr[row + t];
    si[t] = xi[row + t];
  }
  __syncthreads();
  int lead = 1, rest = L;
  for (int s = 0; s < p.k; ++s) {
    const int f = p.f[s];
    rest /= f;
    const bool last = s + 1 == p.k;
    const float* fr = smem + o.f[s];
    stage_tile(sr, si, lead, f, rest, fr, fr + f * f, p.twr[s], p.twi[s],
               last ? outr + row : dr, last ? outi + row : di, tid, nt);
    __syncthreads();
    float* t = sr;
    sr = dr;
    dr = t;
    t = si;
    si = di;
    di = t;
    lead *= f;
  }
}

}  // namespace

// Block mode, one launch.  x, out: (batch, L) planes, L = prod(factors);
// planes: 4k - 2 device pointers, per stage the (f, f) DFT planes then
// (all but the last) the (f, rest) twiddle planes; layout: the k + 3
// words of BlockLayout (host memory).  Returns the CUDA error.
extern "C" int multistep_block_f32(const float* xr, const float* xi,
                                   float* outr, float* outi,
                                   const void* const* planes,
                                   const int* factors, int k, int batch,
                                   const long long* layout, void* stream) {
  if (k < 1 || k > kMaxStages) return (int)cudaErrorInvalidValue;
  Plan p;
  memset(&p, 0, sizeof(p));
  p.k = k;
  long long L = 1;
  int idx = 0;
  for (int s = 0; s < k; ++s) {
    p.f[s] = factors[s];
    L *= factors[s];
    p.fr[s] = (const float*)planes[idx++];
    p.fi[s] = (const float*)planes[idx++];
    if (s + 1 < k) {
      p.twr[s] = (const float*)planes[idx++];
      p.twi[s] = (const float*)planes[idx++];
    }
  }
  BlockLayout o;
  memset(&o, 0, sizeof(o));
  o.x = layout[0];
  o.y = layout[1];
  for (int s = 0; s < k; ++s) o.f[s] = layout[2 + s];
  o.total = layout[2 + k];
  const size_t smem = (size_t)o.total * sizeof(float);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        multistep_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (batch < 1) return 0;
  multistep_block_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      xr, xi, outr, outi, p, o, (int)L);
  return (int)cudaGetLastError();
}

// Per-stage mode, k launches.  x, out, t: (batch, L) planes (t scratch);
// tables: 2k device pointers, the (f,) f32 table of w_f^t of each stage;
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
    const float* tbr = (const float*)tables[2 * s];
    const float* tbi = (const float*)tables[2 * s + 1];
    int err;
    if (s + 1 < k) {
      if (rest > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      err = fft_cols::launch(sr, si, dr, di, tbr, tbi,
                             (const float*)twiddles[2 * s],
                             (const float*)twiddles[2 * s + 1], n_lead,
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
