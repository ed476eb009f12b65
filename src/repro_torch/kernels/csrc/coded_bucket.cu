// The whole c2c coded-FFT bucket in one launch, masked or planes.
//
// Replaces two TPU kernels of the JAX package's
// kernels/coded_pipeline.py: coded_fft_bucket_masked (entry
// coded_bucket_masked_f32) and coded_fft_bucket (entry coded_bucket_f32).
// Per request q of the bucket, from the raw request x (length s = m*L)
// and its (N,) responder mask:
//
//   1. subset  = the first m responders in index order, short rows filled
//                with the first non-responders (ops.mask_subsets' stable
//                argsort); inv = inv(G[subset]) in closed form (Lagrange:
//                locator product in the reference's shuffled order `perm`,
//                suffix-form deflation, 1/A'(x_j)), node angles reduced as
//                integers (subset_j * d mod N) before the float multiply --
//                block_subset_decode of bucket.cuh, shared with the
//                real-kind bucket kernels;
//   2. the L-point DFT of each of the m interleaved message shards
//      c_i[j] = x[j*m + i];
//   3. at every payload position l: worker results b_r = G[subset_r] . t,
//      decode c^ = inv . b, recombine twiddle w_s^(j*l), length-m DFT;
//   4. natural-order output X[j*L + l].
//
// The planes kernel (kPlanes) takes the request's host-built (m, N)
// scatter decode matrix D in place of the mask: step 1 stages D and all
// N rows of G (block_stage_planes), and step 3 computes every worker's
// result b_r = G[r] . t over r < N, then c^ = D . b -- the TPU kernel's
// two contractions, kept apart (D . G is the identity for a scatter D:
// folded, the coded computation would vanish), the zero straggler
// columns of D included.
//
// What bounds it on the H100: bytes.  Counted as FFTs (5*L*log2(L) flops
// per shard) plus the O(m^2) coding work per payload position, the
// service's default bucket (64 requests, s = 4096, m = 4, N = 8) needs
// about 0.5 us of FP32 work against about 1.25 us to read x and write the
// output once.
//
// Design.  One block per request, every working array in shared memory.
//   Load: the request's s values are read as one contiguous run, 16
//   bytes a thread where aligned, and de-interleaved as they land: x[j*m
//   + i] goes to shard row i, point j.  The rows sit in groups of `rows`
//   consecutive shards (Plan.rows), each group its own padded plane
//   (pad(a) = a + a/32, fft_rows.cuh's), so shard i, point j is word
//   (i / rows) * gp + pad((i % rows) * L + j), gp the padded words of a
//   full group.
//   Shard FFTs: each group runs the Stockham passes of fft_rows.cuh
//   (run_passes: the radix plan fourstep_fft.fft_rows_plan(L), the f32
//   table of w_L^t staged once a block, natural-order spectra) from its
//   rows in place to one ping-pong buffer of a group's size; an odd
//   number of passes leaves the spectra in the buffer, and they are
//   copied back.  So the kernel reads no DFT plane: its twiddles are
//   entries of the table, bit for bit those of F_A and F_B.
//   Code phase: one thread per natural l, everything after the DFT mixes
//   only the shard axis, in registers.  A warp reads the spectra at
//   consecutive words and stores the output in consecutive floats.  The
//   recombine twiddle of shard j at l is w_s^(j*l) (j*l < s), read from
//   the f32 table of the s-point twiddles -- the entry the reference's
//   plane holds at that position, bit for bit -- at stride j across a
//   warp, from L2.
// The working set is laid out by coded_pipeline.bucket_fft_layout, which
// also picks the group rows (all m shards in one group where the block
// holds them, fewer where it would not fit) and passes the word offsets
// in at launch.  The
// route's gate stays coded_pipeline.bucket_layout, the dense design's
// reckoning: this layout fits one block wherever that one does.
//
// Precision.  Each entry has a *_bf16 twin (precision="bf16"): the tables
// of L and of s and F_m in bfloat16 (TW), widened to f32 as they load --
// the L-point table and F_m into shared memory, the recombine twiddle as
// it is read.  The payload, G, the decode (with its sincosf) and shared
// memory stay f32, so the layout and the gate are the f32 entries'.

#include <cstring>

#include "bucket.cuh"
#include "fft_rows.cuh"

namespace {

using fft_rows::pad;

// Word offsets of every shared array, then the total, in this order; the
// caller computes them (coded_pipeline.bucket_fft_layout).
struct Layout {
  long long z, y, tab, gs, fm, pw, qm, loc, nodes, sub, total;
};

template <class TW>
struct BucketArgs {
  const float* xr;
  const float* xi;
  const float* masks;  // masked kernel: (q, n) responder masks
  const int* perm;
  const float* dr;     // planes kernel: (q, m, n) scatter decode planes
  const float* di;
  const float* gr;
  const float* gi;
  const TW* tabr;      // (L,) table of w_L^t
  const TW* tabi;
  const TW* twr;       // (s,) table of w_s^t
  const TW* twi;
  const TW* fmr;       // (m, m) DFT
  const TW* fmi;
  float* outr;
  float* outi;
  int n, m;
  float ntau;          // -2*pi/n rounded to float
  fft_rows::Plan plan; // L, the group rows, the radices
  Layout o;            // shared-memory word offsets
};

// Threads a block: 512 where the code phase's registers allow (its
// per-thread arrays are 4*MM floats), 256 for MM = 32.  One block an SM
// is the launch's own bound (a block a request), and naming it keeps
// ptxas from spilling to fit two (MM = 8 spilled 8 bytes at 64
// registers without it)
constexpr int threads_for(int mm) { return mm <= 16 ? 512 : 256; }

template <int MM, bool kPlanes, class TW>
__global__ void __launch_bounds__(threads_for(MM), 1)
coded_bucket_kernel(BucketArgs<TW> p) {
  extern __shared__ float smem[];
  const int m = p.m, n = p.n;
  const int L = p.plan.n, rows = p.plan.rows;
  const int s = m * L;
  const long long q = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout& o = p.o;
  const int R = kPlanes ? n : m;  // worker rows the decode contracts
  const int gp = pad(rows * L - 1) + 1;  // words of a full group's plane
  const int groups = (m + rows - 1) / rows;
  const int zplane = (int)((o.y - o.z) / 2);
  float* z_r = smem + o.z;      float* z_i = z_r + zplane;
  float* y_r = smem + o.y;      float* y_i = y_r + gp;
  float* tb_r = smem + o.tab;   float* tb_i = tb_r + (o.gs - o.tab) / 2;
  float* gs_r = smem + o.gs;    float* gs_i = gs_r + R * m;
  float* fm_r = smem + o.fm;    float* fm_i = fm_r + m * m;
  float* pw_r = smem + o.pw;    float* pw_i = pw_r + m * m;
  float* qm_r = smem + o.qm;    float* qm_i = qm_r + m * R;
  float* loc_r = smem + o.loc;  float* loc_i = loc_r + (m + 1);
  float* nd_r = smem + o.nodes; float* nd_i = nd_r + m;
  int* sub = reinterpret_cast<int*>(smem + o.sub);

  // -- the L-point table and F_m ------------------------------------------
  for (int t = tid; t < L; t += nt) {
    tb_r[pad(t)] = widen(p.tabr[t]);
    tb_i[pad(t)] = widen(p.tabi[t]);
  }
  block_copy(fm_r, p.fmr, m * m);
  block_copy(fm_i, p.fmi, m * m);

  // -- 1. subset and inv(G[subset]), or G and the request's D ------------
  if (kPlanes) {
    block_stage_planes(p.gr, p.gi, p.dr + q * m * n, p.di + q * m * n, n, m,
                       gs_r, gs_i, qm_r, qm_i);
  } else {
    const DecodeSmem dsm{gs_r, gs_i, pw_r, pw_i, qm_r, qm_i,
                         loc_r, loc_i, nd_r, nd_i, sub};
    block_subset_decode(p.masks + q * n, p.perm, p.gr, p.gi, n, m, p.ntau,
                        dsm);
  }

  // -- load: x[j*m + i] -> shard row i, point j ---------------------------
  const float* xq_r = p.xr + q * s;
  const float* xq_i = p.xi + q * s;
  int head = 0;
  if (fft_rows::aligned16(xq_r, xq_i)) {
    head = s & ~3;
    for (int t = tid; t < (s >> 2); t += nt) {
      const float4 a = reinterpret_cast<const float4*>(xq_r)[t];
      const float4 b = reinterpret_cast<const float4*>(xq_i)[t];
      const float va[4] = {a.x, a.y, a.z, a.w};
      const float vb[4] = {b.x, b.y, b.z, b.w};
      int j = (4 * t) / m, i = 4 * t - j * m;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = i / rows;
        const int w = g * gp + pad((i - g * rows) * L + j);
        z_r[w] = va[u];
        z_i[w] = vb[u];
        if (++i == m) {
          i = 0;
          ++j;
        }
      }
    }
  }
  for (int e = head + tid; e < s; e += nt) {
    const int j = e / m, i = e - j * m, g = i / rows;
    const int w = g * gp + pad((i - g * rows) * L + j);
    z_r[w] = xq_r[e];
    z_i[w] = xq_i[e];
  }
  __syncthreads();

  // -- 2. the L-point DFT of every shard, a group of rows at a time -------
  for (int g = 0; g < groups; ++g) {
    const int live = min(rows, m - g * rows);
    float* sr = z_r + g * gp;
    float* si = z_i + g * gp;
    float* dr = y_r;
    float* di = y_i;
    fft_rows::run_passes(sr, si, dr, di, tb_r, tb_i, p.plan, live, tid, nt);
    if (sr != z_r + g * gp) {  // odd passes: the spectra are in y
      for (int t = tid; t < live * L; t += nt) {
        z_r[g * gp + pad(t)] = sr[pad(t)];
        z_i[g * gp + pad(t)] = si[pad(t)];
      }
      __syncthreads();
    }
  }

  // -- 3./4. encode, decode, recombine at each natural payload index l ----
  float* outq_r = p.outr + q * s;
  float* outq_i = p.outi + q * s;
  for (int l = tid; l < L; l += nt) {
    float tr[MM], ti[MM], hr[MM], hi[MM];
    int g = 0, r = 0;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      hr[i] = hi[i] = 0.f;
      if (i < m) {
        const int w = g * gp + pad(r * L + l);  // X_i[l]
        tr[i] = z_r[w];
        ti[i] = z_i[w];
        if (++r == rows) {
          r = 0;
          ++g;
        }
      }
    }
#pragma unroll 1
    for (int rr = 0; rr < R; ++rr) {
      float br = 0.f, bi = 0.f;  // worker row rr's result b = G[rr] . t
#pragma unroll
      for (int i = 0; i < MM; ++i)
        if (i < m)
          cmac(br, bi, gs_r[rr * m + i], gs_i[rr * m + i], tr[i], ti[i]);
#pragma unroll
      for (int j = 0; j < MM; ++j)  // decode: c^ += inv[:, rr] * b (or D)
        if (j < m)
          cmac(hr[j], hi[j], qm_r[j * R + rr], qm_i[j * R + rr], br, bi);
    }
#pragma unroll
    for (int j = 0; j < MM; ++j) {
      if (j < m) {
        const float w_re = ldg_f32(p.twr + j * l);
        const float w_im = ldg_f32(p.twi + j * l);
        const float u = hr[j] * w_re - hi[j] * w_im;
        hi[j] = hr[j] * w_im + hi[j] * w_re;
        hr[j] = u;
      }
    }
#pragma unroll 1
    for (int jp = 0; jp < m; ++jp) {
      float accr = 0.f, acci = 0.f;
#pragma unroll
      for (int j = 0; j < MM; ++j)
        if (j < m)
          cmac(accr, acci, fm_r[jp * m + j], fm_i[jp * m + j], hr[j], hi[j]);
      outq_r[jp * L + l] = accr;
      outq_i[jp * L + l] = acci;
    }
  }
}

template <int MM, bool kPlanes, class TW>
int launch(const BucketArgs<TW>& p, int q, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      coded_bucket_kernel<MM, kPlanes, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (q < 1) return 0;
  coded_bucket_kernel<MM, kPlanes, TW>
      <<<q, threads_for(MM), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Both entries: the plan and the layout words into p, then the instance
// for m.
template <bool kPlanes, class TW>
int dispatch(BucketArgs<TW>& p, int q, int ell, const int* radix,
             int passes, int rows, const long long* layout, void* stream) {
  const int m = p.m;
  if (m < 1 || ell < 1 || rows < 1 || rows > m || passes < 0 ||
      passes > fft_rows::kMaxPasses)
    return (int)cudaErrorInvalidValue;
  memset(&p.plan, 0, sizeof(p.plan));
  p.plan.n = ell;
  p.plan.rows = rows;
  p.plan.passes = passes;
  for (int k = 0; k < passes; ++k) p.plan.radix[k] = radix[k];
  memcpy(&p.o, layout, sizeof(Layout));
  const size_t smem = (size_t)p.o.total * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 4) return launch<4, kPlanes, TW>(p, q, smem, st);
  if (m <= 8) return launch<8, kPlanes, TW>(p, q, smem, st);
  if (m <= 16) return launch<16, kPlanes, TW>(p, q, smem, st);
  if (m <= 32) return launch<32, kPlanes, TW>(p, q, smem, st);
  return (int)cudaErrorInvalidValue;
}

template <class TW>
int masked_entry(const float* xr, const float* xi, const float* masks,
                 const int* perm, const float* gr, const float* gi,
                 const TW* tabr, const TW* tabi, const TW* twr,
                 const TW* twi, const TW* fmr, const TW* fmi, float* outr,
                 float* outi, int q, int n, int m, int ell, float ntau,
                 const int* radix, int passes, int rows,
                 const long long* layout, void* stream) {
  BucketArgs<TW> p{xr, xi, masks, perm, nullptr, nullptr, gr, gi, tabr,
                   tabi, twr, twi, fmr, fmi, outr, outi, n, m, ntau, {}, {}};
  return dispatch<false>(p, q, ell, radix, passes, rows, layout, stream);
}

template <class TW>
int planes_entry(const float* xr, const float* xi, const float* dr,
                 const float* di, const float* gr, const float* gi,
                 const TW* tabr, const TW* tabi, const TW* twr,
                 const TW* twi, const TW* fmr, const TW* fmi, float* outr,
                 float* outi, int q, int n, int m, int ell, const int* radix,
                 int passes, int rows, const long long* layout,
                 void* stream) {
  BucketArgs<TW> p{xr, xi, nullptr, nullptr, dr, di, gr, gi, tabr, tabi,
                   twr, twi, fmr, fmi, outr, outi, n, m, 0.f, {}, {}};
  return dispatch<true>(p, q, ell, radix, passes, rows, layout, stream);
}

}  // namespace

using bf16 = __nv_bfloat16;

// The device's opt-in shared memory per block (the gate's limit), or -1.
extern "C" int device_smem_per_block_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// x: (q, s) planes; masks: (q, n) float; perm: (m,) int32; g: (n, m);
// tab: the (ell,) table of w_ell^t; tw: the (s,) table of w_s^t; fm:
// (m, m); out: (q, s); radix: the `passes` radices of ell
// (fourstep_fft.fft_rows_plan); rows: the shards of a group; layout: the
// 11 words of Layout, in host memory (coded_pipeline.bucket_fft_layout).
// tab, tw and fm are f32 here, bf16 in the _bf16 twin.  m must be in
// [1, 32]; the wrapper checks.
extern "C" int coded_bucket_masked_f32(
    const float* xr, const float* xi, const float* masks, const int* perm,
    const float* gr, const float* gi, const float* tabr, const float* tabi,
    const float* twr, const float* twi, const float* fmr, const float* fmi,
    float* outr, float* outi, int q, int n, int m, int ell, float ntau,
    const int* radix, int passes, int rows, const long long* layout,
    void* stream) {
  return masked_entry(xr, xi, masks, perm, gr, gi, tabr, tabi, twr, twi,
                      fmr, fmi, outr, outi, q, n, m, ell, ntau, radix,
                      passes, rows, layout, stream);
}

extern "C" int coded_bucket_masked_bf16(
    const float* xr, const float* xi, const float* masks, const int* perm,
    const float* gr, const float* gi, const bf16* tabr, const bf16* tabi,
    const bf16* twr, const bf16* twi, const bf16* fmr, const bf16* fmi,
    float* outr, float* outi, int q, int n, int m, int ell, float ntau,
    const int* radix, int passes, int rows, const long long* layout,
    void* stream) {
  return masked_entry(xr, xi, masks, perm, gr, gi, tabr, tabi, twr, twi,
                      fmr, fmi, outr, outi, q, n, m, ell, ntau, radix,
                      passes, rows, layout, stream);
}

// As coded_bucket_masked_f32, with d: (q, m, n) scatter decode planes in
// place of the masks (layout: bucket_fft_layout(masked=False)).
extern "C" int coded_bucket_f32(
    const float* xr, const float* xi, const float* dr, const float* di,
    const float* gr, const float* gi, const float* tabr, const float* tabi,
    const float* twr, const float* twi, const float* fmr, const float* fmi,
    float* outr, float* outi, int q, int n, int m, int ell, const int* radix,
    int passes, int rows, const long long* layout, void* stream) {
  return planes_entry(xr, xi, dr, di, gr, gi, tabr, tabi, twr, twi, fmr, fmi,
                      outr, outi, q, n, m, ell, radix, passes, rows, layout,
                      stream);
}

extern "C" int coded_bucket_bf16(
    const float* xr, const float* xi, const float* dr, const float* di,
    const float* gr, const float* gi, const bf16* tabr, const bf16* tabi,
    const bf16* twr, const bf16* twi, const bf16* fmr, const bf16* fmi,
    float* outr, float* outi, int q, int n, int m, int ell, const int* radix,
    int passes, int rows, const long long* layout, void* stream) {
  return planes_entry(xr, xi, dr, di, gr, gi, tabr, tabi, twr, twi, fmr, fmi,
                      outr, outi, q, n, m, ell, radix, passes, rows, layout,
                      stream);
}
