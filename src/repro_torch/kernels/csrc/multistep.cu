// Mixed-radix (multistep) four-step DFT of a length-L row, L = f1*...*fk,
// on planar float32.
//
// Replaces the TPU kernel multistep_fused of the JAX package's
// kernels/fourstep_fft.py: k dense stages over a row held on chip, one
// launch.  Stage i splits what is left of the row as (lead, f, rest),
// lead = f1*...*f(i-1), rest = f(i+1)*...*fk, and computes
//
//   out[lead, c, r] = tw[c, r] * sum_j F[c, j] * x[lead, j, r]
//
// with F the dense (f, f) DFT and tw the (f, rest) inter-stage twiddle
// (none on the last stage).  After k stages the row holds the scrambled
// digit order X[c1 + f1*c2 + f1*f2*c3 + ...] at flat (c1, ..., ck), as the
// TPU kernel leaves it; the dispatch layer unscrambles with one permute.
//
// What bounds it on the H100: bytes.  Counted as an FFT (5*L*log2(L)
// flops per row) the work is below the traffic of reading the input and
// writing the output once: 512 rows of L = 1024 move 8.4 MB (0.0025 ms)
// for 0.0004 ms of FP32 work, 128 rows of L = 2^18 move 537 MB (0.16 ms)
// for 0.045 ms.  This first port does more work than an FFT: each stage is
// a dense DFT, 8*L*sum(f) flops per row (5.8x an FFT's for (16, 16, 4),
// 17x for (64, 64, 64)).
//
// Design.  Two modes, chosen on the Python side from the plan alone
// (fourstep_fft.multistep_mode):
//
// * Block mode, one launch, where the row fits one block: the block
//   stages its row in shared memory, with a ping-pong buffer, and every
//   stage's (f, f) DFT planes; it runs the k stages in turn with a
//   barrier between them, and the last stage stores straight to the
//   output.  The twiddles are read from global memory (small, L2-
//   resident).  The working set is laid out by
//   fourstep_fft.multistep_layout, which passes the word offsets in at
//   launch; the same reckoning is the block-mode gate (232,448 bytes):
//   16 KiB a row at L = 1024, rows up to L ~ 14,000 fit.
// * Per-stage mode, k launches through a device ping-pong (the output and
//   one scratch pair), where the row does not fit: each launch runs one
//   stage over every row, a block taking one tile of up to 4096 complex
//   values -- (f, up to 4096/f) columns of one lead, or whole (f, rest)
//   leads when rest is short -- into shared memory with coalesced loads,
//   and storing its outputs.  The TPU kernel keeps a 2 MiB row (L = 2^18)
//   in VMEM for all stages; here a stage needs the whole previous stage
//   done, so the stage boundary is a launch boundary.
//
// In both modes a stage runs one of two thread maps.  Where a lead's
// columns are at least a warp wide, a thread takes one column and four
// consecutive outputs c (its inputs read once for the four; a warp reads
// consecutive columns and one broadcast F entry).  Where they are shorter
// (the last stages, rest = 1), a thread takes one output and the lanes
// walk c: they read one broadcast input and consecutive F entries,
// F[j*f + c] = F[c*f + j], since every DFT matrix is symmetric.  FP32 on
// CUDA cores with FP32 accumulation; a radix FFT over the tile is the way
// to the bound.

#include <cstring>

#include "common.cuh"

namespace {

constexpr int kMaxStages = 32;    // fourstep_fft.MAX_STAGES
constexpr int kTileElems = 4096;  // fourstep_fft.STAGE_TILE
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

// Tile index -> index in the destination (or source) array:
// base + (i / seg) * stride + i % seg, or base + i when stride is 0.
struct Map {
  long long base, seg, stride;
  __device__ __forceinline__ long long operator()(long long i) const {
    return stride == 0 ? base + i : base + (i / seg) * stride + i % seg;
  }
};

__device__ __forceinline__ void store_out(float accr, float acci, int c,
                                          int r, long long rest,
                                          long long r0,
                                          const float* __restrict__ twr,
                                          const float* __restrict__ twi,
                                          float* dr, float* di,
                                          long long o) {
  if (twr != nullptr) {
    const long long t = (long long)c * rest + r0 + r;
    const float w_r = twr[t], w_i = twi[t];
    const float o_r = accr * w_r - acci * w_i;
    acci = accr * w_i + acci * w_r;
    accr = o_r;
  }
  dr[o] = accr;
  di[o] = acci;
}

// One stage over a tile of nl leads of (f, rs) complex values, tile index
// lead*f*rs + j*rs + r:
//   dst[map(lead*f*rs + c*rs + r)] =
//       tw[c*rest + r0 + r] * sum_j F[c*f + j] * x[lead*f*rs + j*rs + r]
// tw: the (f, rest) twiddle planes, or nullptr.  Threads tid, tid + nt, ...
__device__ void stage_tile(const float* xr, const float* xi, int nl, int f,
                           int rs, const float* fr, const float* fi,
                           const float* __restrict__ twr,
                           const float* __restrict__ twi, long long rest,
                           long long r0, float* dr, float* di, Map map,
                           int tid, int nt) {
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
          store_out(accr[u], acci[u], c, r, rest, r0, twr, twi, dr, di,
                    map(base + c * rs));
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
      store_out(accr, acci, c, r, rest, r0, twr, twi, dr, di,
                map(base + c * rs));
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
  const Map ident = {0, 1, 0};
  int lead = 1, rest = L;
  for (int s = 0; s < p.k; ++s) {
    const int f = p.f[s];
    rest /= f;
    const bool last = s + 1 == p.k;
    const float* fr = smem + o.f[s];
    stage_tile(sr, si, lead, f, rest, fr, fr + f * f, p.twr[s], p.twi[s],
               rest, 0, last ? outr + row : dr, last ? outi + row : di,
               ident, tid, nt);
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

__host__ __device__ __forceinline__ int tile_cols(int f) {
  return f >= kTileElems ? 1 : kTileElems / f;
}

// One stage over every row: n_lead leads of (f, rest) in src -> dst.
__global__ void __launch_bounds__(kThreads)
multistep_stage_kernel(const float* __restrict__ sr,
                       const float* __restrict__ si, float* __restrict__ dr,
                       float* __restrict__ di, const float* __restrict__ fr,
                       const float* __restrict__ fi,
                       const float* __restrict__ twr,
                       const float* __restrict__ twi, long long n_lead, int f,
                       long long rest) {
  extern __shared__ float tile[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rt = tile_cols(f);
  float* tr = tile;
  float* ti = tile + (size_t)f * rt;
  // rest >= rt: tiles of rt columns of one lead; else whole leads
  const long long per_lead = rest >= rt ? (rest + rt - 1) / rt : 0;
  const long long leads_per_tile = rest >= rt ? 1 : rt / rest;
  const long long n_tiles = per_lead ? n_lead * per_lead
                                     : (n_lead + leads_per_tile - 1) /
                                           leads_per_tile;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int nl, rs;
    long long r0;
    Map map;
    if (per_lead) {
      const long long lead = t / per_lead;
      r0 = (t % per_lead) * rt;
      rs = (int)min((long long)rt, rest - r0);
      nl = 1;
      map = {lead * f * rest + r0, rs, rest};
    } else {
      const long long lead0 = t * leads_per_tile;
      nl = (int)min(leads_per_tile, n_lead - lead0);
      rs = (int)rest;
      r0 = 0;
      map = {lead0 * f * rest, 1, 0};
    }
    const int n = nl * f * rs;
    for (int i = tid; i < n; i += nt) {
      const long long g = map(i);
      tr[i] = sr[g];
      ti[i] = si[g];
    }
    __syncthreads();
    stage_tile(tr, ti, nl, f, rs, fr, fi, twr, twi, rest, r0, dr, di, map,
               tid, nt);
    __syncthreads();
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= kSmemDefault) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// x, out: (batch, L) planes, L = prod(factors); planes: 4k - 2 device
// pointers, per stage the (f, f) DFT planes then (all but the last) the
// (f, rest) twiddle planes; layout: the k + 3 words of BlockLayout (host
// memory) for block mode -- one launch -- or nullptr for per-stage mode:
// k launches, t (batch, L) scratch planes.  Returns the first nonzero
// CUDA error.
extern "C" int multistep_fused_f32(const float* xr, const float* xi,
                                   float* outr, float* outi, float* tr,
                                   float* ti, const void* const* planes,
                                   const int* factors, int k, int batch,
                                   const long long* layout, void* stream) {
  if (k < 1 || k > kMaxStages) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
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
  if (layout != nullptr) {
    BlockLayout o;
    memset(&o, 0, sizeof(o));
    o.x = layout[0];
    o.y = layout[1];
    for (int s = 0; s < k; ++s) o.f[s] = layout[2 + s];
    o.total = layout[2 + k];
    const size_t smem = (size_t)o.total * sizeof(float);
    int err = set_smem((const void*)multistep_block_kernel, smem);
    if (err != 0) return err;
    multistep_block_kernel<<<batch, kThreads, smem, st>>>(xr, xi, outr, outi,
                                                         p, o, (int)L);
    return (int)cudaGetLastError();
  }
  const float* sr = xr;
  const float* si = xi;
  long long n_lead = batch, rest = L;
  for (int s = 0; s < k; ++s) {
    const int f = p.f[s];
    rest /= f;
    // the last stage lands in out: stages alternate out and scratch
    const bool to_out = (k - 1 - s) % 2 == 0;
    float* dr = to_out ? outr : tr;
    float* di = to_out ? outi : ti;
    const int rt = tile_cols(f);
    const size_t smem = 2 * (size_t)f * rt * sizeof(float);
    int err = set_smem((const void*)multistep_stage_kernel, smem);
    if (err != 0) return err;
    const long long n_tiles =
        rest >= rt ? n_lead * ((rest + rt - 1) / rt)
                   : (n_lead + rt / rest - 1) / (rt / rest);
    const unsigned grid = (unsigned)(n_tiles < (1 << 20) ? n_tiles : 1 << 20);
    multistep_stage_kernel<<<grid, kThreads, smem, st>>>(
        sr, si, dr, di, p.fr[s], p.fi[s], p.twr[s], p.twi[s], n_lead, f,
        rest);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    sr = dr;
    si = di;
    n_lead *= f;
  }
  return 0;
}
