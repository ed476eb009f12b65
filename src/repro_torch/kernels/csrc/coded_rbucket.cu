// The whole r2c coded-FFT bucket in one launch, masked or planes.
//
// Replaces two TPU kernels of the JAX package's
// kernels/coded_pipeline.py: coded_rfft_bucket_masked (entry
// coded_rbucket_masked_f32, plain twin coded_pipeline.rbucket_body_masked)
// and coded_rfft_bucket (entry coded_rbucket_f32, twin rbucket_body).
// Per request q of the bucket, from the REAL request x (length
// s = m*L = 2*m*n2) and its (N,) responder mask (one byte a worker, the
// service's bool mask read in place, so no conversion launch precedes
// the kernel):
//
//   1. subset and inv(G[subset]) -- block_subset_decode of bucket.cuh,
//      exactly as the c2c bucket kernel does them;
//   2. the n2-point DFT of each of the m pair-packed message shards
//      z_i[t] = x[i + 2tm] + 1j*x[i + (2t+1)m];
//   3. at every packed position p: worker results b_r = G[subset_r] . t,
//      decode h = inv . b, written back in place -- the decoded spectra
//      H_i = fft(z_i) stay in shared memory, because
//   4. the Hermitian split pairs position p with n2 - p:
//      C_i[p] = E_p + O_p * omega_L^p with E = (Z_p + conj Z_{n2-p})/2,
//      O = -j(Z_p - conj Z_{n2-p})/2; then C_i[L-p] = conj(C_i[p]), the
//      recombine twiddle omega_s^{iu}, and only the m//2+1 DFT rows that
//      feed the s//2+1 non-redundant bins X[j*L + u].
//
// The planes kernel (kPlanes) takes the request's host-built (m, N)
// scatter decode matrix D in place of the mask: step 1 stages D and all
// N rows of G, and step 3 computes every worker's result over r < N,
// then h = D . b (see coded_bucket.cu for why the two stay apart).
//
// What bounds it on the H100: bytes.  The default bucket (64 requests,
// s = 4096, m = 4, N = 8) reads 1 MiB of requests and writes 1 MiB of
// half spectra; with G, the masks, the tables, the recombine twiddle and
// the DFT rows about 2.1 MB, some 0.63 us at 3.35 TB/s, against about
// 0.3 us of FP32 work counted as FFTs.
//
// Design.  One block per request, every working array in shared memory,
// on the pieces of the c2c bucket kernel (coded_bucket.cu).
//   Load: the request's s real values are read as one contiguous run,
//   16 bytes a thread where aligned, and de-interleaved as they land:
//   element e is shard i = (e mod 2m) mod m, point t = e / 2m, on the
//   real plane where e mod 2m < m and the imaginary one otherwise.  The
//   shards sit in groups of `rows` consecutive shards, each group its own
//   padded plane (pad(a) = a + a/32, fft_rows.cuh's): shard i, point t is
//   word (i / rows) * gp + pad((i % rows) * n2 + t), gp the padded words
//   of a full group.
//   Shard FFTs: each group runs the Stockham passes of fft_rows.cuh
//   (run_passes: the radix plan fourstep_fft.fft_rows_plan(n2), the f32
//   table of w_n2^t staged once a block) from its shards in place to one
//   ping-pong buffer of a group's size; an odd number of passes leaves
//   the spectra in the buffer, and they are copied back.  The spectra
//   come out in NATURAL order, so the code phase and the split read
//   positions p and n2 - p directly.  The kernel reads no DFT plane: F_A,
//   F_B and W stay on the host side of the wrapper.
//   Code phase: one thread per packed position, the worker results and
//   the decode in registers, the decoded values written back to the
//   same words.  Split: one thread per output position u, its pair of
//   spectra read at consecutive words across a warp, the split twiddle
//   (swr: the L-point table's first n2+1 entries, bit for bit) and the
//   natural-order recombine twiddle read coalesced at j*L + u, the DFT
//   rows from shared memory, the bins stored in consecutive floats.
// The working set is laid out by coded_pipeline.bucket_fft_layout with
// the block's m//2+1 DFT rows, which also picks the group rows, and
// passed in at launch.  The route's gate stays
// coded_pipeline.rbucket_layout, the dense design's reckoning: this
// layout fits one block wherever that one does.
//
// Precision.  Each entry has a *_bf16 twin (precision="bf16"): the
// n2-point table, the split twiddle, the recombine twiddle and the DFT
// rows in bfloat16 (TW), widened to f32 as they load.  The payload, G,
// the decode and shared memory stay f32: the layout is the f32 entries'.

#include <cstring>

#include "bucket.cuh"
#include "fft_rows.cuh"

namespace {

using fft_rows::pad;

// Word offsets of every shared array, then the total, in this order; the
// caller computes them (coded_pipeline.bucket_fft_layout).
struct Layout {
  long long z, y, tab, gs, fh, pw, qm, loc, nodes, sub, total;
};

template <class TW>
struct RBucketArgs {
  const float* xr;
  const unsigned char* masks;  // masked kernel: (q, n) responder bytes
  const int* perm;
  const float* dr;     // planes kernel: (q, m, n) scatter decode planes
  const float* di;
  const float* gr;
  const float* gi;
  const TW* tabr;      // (n2,) table of w_n2^t
  const TW* tabi;
  const TW* swr;       // (n2+1,) split twiddle omega_L^p
  const TW* swi;
  const TW* twr;       // (m, L) recombine twiddle, natural order
  const TW* twi;
  const TW* fhr;       // (m//2+1, m) DFT rows
  const TW* fhi;
  float* outr;         // (q, s//2+1)
  float* outi;
  int n, m;
  float ntau;          // -2*pi/n rounded to float
  fft_rows::Plan plan; // n2, the group rows, the radices
  Layout o;            // shared-memory word offsets
};

// Threads a block: 512 where the code phase's registers allow (its
// per-thread arrays are 4*MM floats), 256 for MM = 32; one block an SM,
// as coded_bucket.cu names it, so ptxas does not spill to fit two
constexpr int threads_for(int mm) { return mm <= 16 ? 512 : 256; }

template <int MM, bool kPlanes, class TW>
__global__ void __launch_bounds__(threads_for(MM), 1)
coded_rbucket_kernel(RBucketArgs<TW> p) {
  extern __shared__ float smem[];
  const int m = p.m, n = p.n;
  const int n2 = p.plan.n, rows = p.plan.rows;  // packed shard length L/2
  const int L = 2 * n2;
  const int s = m * L;
  const int sh = s / 2 + 1;
  const int hrows = m / 2 + 1;
  const long long q = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout& o = p.o;
  const int R = kPlanes ? n : m;  // worker rows the decode contracts
  const int gp = pad(rows * n2 - 1) + 1;  // words of a full group's plane
  const int groups = (m + rows - 1) / rows;
  const int zplane = (int)((o.y - o.z) / 2);
  float* z_r = smem + o.z;      float* z_i = z_r + zplane;
  float* y_r = smem + o.y;      float* y_i = y_r + gp;
  float* tb_r = smem + o.tab;   float* tb_i = tb_r + (o.gs - o.tab) / 2;
  float* gs_r = smem + o.gs;    float* gs_i = gs_r + R * m;
  float* fh_r = smem + o.fh;    float* fh_i = fh_r + hrows * m;
  float* pw_r = smem + o.pw;    float* pw_i = pw_r + m * m;
  float* qm_r = smem + o.qm;    float* qm_i = qm_r + m * R;
  float* loc_r = smem + o.loc;  float* loc_i = loc_r + (m + 1);
  float* nd_r = smem + o.nodes; float* nd_i = nd_r + m;
  int* sub = reinterpret_cast<int*>(smem + o.sub);

  // -- the n2-point table and the DFT rows --------------------------------
  for (int t = tid; t < n2; t += nt) {
    tb_r[pad(t)] = widen(p.tabr[t]);
    tb_i[pad(t)] = widen(p.tabi[t]);
  }
  block_copy(fh_r, p.fhr, hrows * m);
  block_copy(fh_i, p.fhi, hrows * m);

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

  // -- load: x[t*2m + k] -> shard k mod m, point t, plane k >= m ----------
  const float* xq = p.xr + q * s;
  const int m2 = 2 * m;
  int head = 0;
  if (fft_rows::aligned16(xq, xq)) {
    head = s & ~3;
    for (int v = tid; v < (s >> 2); v += nt) {
      const float4 a = reinterpret_cast<const float4*>(xq)[v];
      const float va[4] = {a.x, a.y, a.z, a.w};
      int t = (4 * v) / m2, k = 4 * v - t * m2;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool im = k >= m;
        const int i = im ? k - m : k;
        const int g = i / rows;
        (im ? z_i : z_r)[g * gp + pad((i - g * rows) * n2 + t)] = va[u];
        if (++k == m2) {
          k = 0;
          ++t;
        }
      }
    }
  }
  for (int e = head + tid; e < s; e += nt) {
    const int t = e / m2, k = e - t * m2;
    const bool im = k >= m;
    const int i = im ? k - m : k;
    const int g = i / rows;
    (im ? z_i : z_r)[g * gp + pad((i - g * rows) * n2 + t)] = xq[e];
  }
  __syncthreads();

  // -- 2. the n2-point DFT of every shard, a group of shards at a time ----
  for (int g = 0; g < groups; ++g) {
    const int live = min(rows, m - g * rows);
    float* sr = z_r + g * gp;
    float* si = z_i + g * gp;
    float* dr = y_r;
    float* di = y_i;
    fft_rows::run_passes(sr, si, dr, di, tb_r, tb_i, p.plan, live, tid, nt);
    if (sr != z_r + g * gp) {  // odd passes: the spectra are in y
      for (int t = tid; t < live * n2; t += nt) {
        z_r[g * gp + pad(t)] = sr[pad(t)];
        z_i[g * gp + pad(t)] = si[pad(t)];
      }
      __syncthreads();
    }
  }

  // -- 3. encode + decode at each natural packed position, in place -------
  for (int pp = tid; pp < n2; pp += nt) {
    float tr[MM], ti[MM], hr[MM], hi[MM];
    int g = 0, r = 0;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      hr[i] = hi[i] = 0.f;
      if (i < m) {
        const int w = g * gp + pad(r * n2 + pp);  // Z_i[pp]
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
      for (int j = 0; j < MM; ++j)  // decode: h += inv[:, rr] * b (or D)
        if (j < m)
          cmac(hr[j], hi[j], qm_r[j * R + rr], qm_i[j * R + rr], br, bi);
    }
    g = r = 0;
#pragma unroll
    for (int j = 0; j < MM; ++j) {
      if (j < m) {
        const int w = g * gp + pad(r * n2 + pp);
        z_r[w] = hr[j];
        z_i[w] = hi[j];
        if (++r == rows) {
          r = 0;
          ++g;
        }
      }
    }
  }
  __syncthreads();

  // -- 4. split, Hermitian extension, twiddle, m//2+1 rows, cut -----------
  float* outq_r = p.outr + q * sh;
  float* outq_i = p.outi + q * sh;
  for (int u = tid; u < L; u += nt) {
    const bool lower = u <= n2;
    const int sp = lower ? u : L - u;       // split index in [0, n2]
    const int pa = sp == n2 ? 0 : sp;       // Z[sp mod n2]
    const int pb = sp == 0 ? 0 : n2 - sp;   // Z[(n2 - sp) mod n2]
    const float sw_re = ldg_f32(p.swr + sp), sw_im = ldg_f32(p.swi + sp);
    float ur[MM], ui[MM];
    int g = 0, r = 0;
#pragma unroll
    for (int j = 0; j < MM; ++j) {
      if (j < m) {
        const int wa = g * gp + pad(r * n2 + pa);
        const int wb = g * gp + pad(r * n2 + pb);
        if (++r == rows) {
          r = 0;
          ++g;
        }
        const float ar = z_r[wa], ai = z_i[wa];
        const float br = z_r[wb], bi = z_i[wb];
        const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
        const float our = 0.5f * (ai + bi), oui = -0.5f * (ar - br);
        const float cr = er + our * sw_re - oui * sw_im;
        float ci = ei + our * sw_im + oui * sw_re;
        if (!lower) ci = -ci;  // C[L-p] = conj(C[p])
        const float w_re = ldg_f32(p.twr + j * L + u);
        const float w_im = ldg_f32(p.twi + j * L + u);
        ur[j] = cr * w_re - ci * w_im;
        ui[j] = cr * w_im + ci * w_re;
      }
    }
#pragma unroll 1
    for (int jr = 0; jr < hrows; ++jr) {
      const int k = jr * L + u;
      if (k >= sh) break;
      float accr = 0.f, acci = 0.f;
#pragma unroll
      for (int j = 0; j < MM; ++j)
        if (j < m)
          cmac(accr, acci, fh_r[jr * m + j], fh_i[jr * m + j], ur[j], ui[j]);
      outq_r[k] = accr;
      outq_i[k] = acci;
    }
  }
}

template <int MM, bool kPlanes, class TW>
int launch(const RBucketArgs<TW>& p, int q, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      coded_rbucket_kernel<MM, kPlanes, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (q < 1) return 0;
  coded_rbucket_kernel<MM, kPlanes, TW>
      <<<q, threads_for(MM), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Both entries: the plan and the layout words into p, then the instance
// for m.
template <bool kPlanes, class TW>
int dispatch(RBucketArgs<TW>& p, int q, int n2, const int* radix,
             int passes, int rows, const long long* layout, void* stream) {
  const int m = p.m;
  if (m < 1 || n2 < 1 || rows < 1 || rows > m || passes < 0 ||
      passes > fft_rows::kMaxPasses)
    return (int)cudaErrorInvalidValue;
  memset(&p.plan, 0, sizeof(p.plan));
  p.plan.n = n2;
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
int masked_entry(const float* xr, const unsigned char* masks,
                 const int* perm, const float* gr, const float* gi,
                 const TW* tabr, const TW* tabi, const TW* swr,
                 const TW* swi, const TW* twr, const TW* twi, const TW* fhr,
                 const TW* fhi, float* outr, float* outi, int q, int n,
                 int m, int n2, float ntau, const int* radix, int passes,
                 int rows, const long long* layout, void* stream) {
  RBucketArgs<TW> p{xr, masks, perm, nullptr, nullptr, gr, gi, tabr, tabi,
                    swr, swi, twr, twi, fhr, fhi, outr, outi, n, m, ntau,
                    {}, {}};
  return dispatch<false>(p, q, n2, radix, passes, rows, layout, stream);
}

template <class TW>
int planes_entry(const float* xr, const float* dr, const float* di,
                 const float* gr, const float* gi, const TW* tabr,
                 const TW* tabi, const TW* swr, const TW* swi,
                 const TW* twr, const TW* twi, const TW* fhr, const TW* fhi,
                 float* outr, float* outi, int q, int n, int m, int n2,
                 const int* radix, int passes, int rows,
                 const long long* layout, void* stream) {
  RBucketArgs<TW> p{xr, nullptr, nullptr, dr, di, gr, gi, tabr, tabi, swr,
                    swi, twr, twi, fhr, fhi, outr, outi, n, m, 0.f, {}, {}};
  return dispatch<true>(p, q, n2, radix, passes, rows, layout, stream);
}

}  // namespace

using bf16 = __nv_bfloat16;

// x: (q, s) real plane; masks: (q, n) bytes, nonzero = responded; perm:
// (m,) int32; g: (n, m);
// tab: the (n2,) table of w_n2^t for n2 = s/(2m); sw: (n2+1,);
// tw: (m, 2*n2) natural order; fh: (m//2+1, m); out: (q, s//2+1) planes;
// radix: the `passes` radices of n2 (fourstep_fft.fft_rows_plan); rows:
// the shards of a group; layout: the 11 words of Layout, in host memory
// (coded_pipeline.bucket_fft_layout with m//2+1 DFT rows).  tab, sw, tw
// and fh are f32 here, bf16 in the _bf16 twin.  m must be in [1, 32];
// the wrapper checks.
extern "C" int coded_rbucket_masked_f32(
    const float* xr, const unsigned char* masks, const int* perm,
    const float* gr,
    const float* gi, const float* tabr, const float* tabi, const float* swr,
    const float* swi, const float* twr, const float* twi, const float* fhr,
    const float* fhi, float* outr, float* outi, int q, int n, int m, int n2,
    float ntau, const int* radix, int passes, int rows,
    const long long* layout, void* stream) {
  return masked_entry(xr, masks, perm, gr, gi, tabr, tabi, swr, swi, twr,
                      twi, fhr, fhi, outr, outi, q, n, m, n2, ntau, radix,
                      passes, rows, layout, stream);
}

extern "C" int coded_rbucket_masked_bf16(
    const float* xr, const unsigned char* masks, const int* perm,
    const float* gr, const float* gi, const bf16* tabr, const bf16* tabi,
    const bf16* swr, const bf16* swi, const bf16* twr, const bf16* twi,
    const bf16* fhr, const bf16* fhi, float* outr, float* outi, int q, int n,
    int m, int n2, float ntau, const int* radix, int passes, int rows,
    const long long* layout, void* stream) {
  return masked_entry(xr, masks, perm, gr, gi, tabr, tabi, swr, swi, twr,
                      twi, fhr, fhi, outr, outi, q, n, m, n2, ntau, radix,
                      passes, rows, layout, stream);
}

// As coded_rbucket_masked_f32, with d: (q, m, n) scatter decode planes in
// place of the masks (layout: bucket_fft_layout(masked=False)).
extern "C" int coded_rbucket_f32(
    const float* xr, const float* dr, const float* di, const float* gr,
    const float* gi, const float* tabr, const float* tabi, const float* swr,
    const float* swi, const float* twr, const float* twi, const float* fhr,
    const float* fhi, float* outr, float* outi, int q, int n, int m, int n2,
    const int* radix, int passes, int rows, const long long* layout,
    void* stream) {
  return planes_entry(xr, dr, di, gr, gi, tabr, tabi, swr, swi, twr, twi,
                      fhr, fhi, outr, outi, q, n, m, n2, radix, passes, rows,
                      layout, stream);
}

extern "C" int coded_rbucket_bf16(
    const float* xr, const float* dr, const float* di, const float* gr,
    const float* gi, const bf16* tabr, const bf16* tabi, const bf16* swr,
    const bf16* swi, const bf16* twr, const bf16* twi, const bf16* fhr,
    const bf16* fhi, float* outr, float* outi, int q, int n, int m, int n2,
    const int* radix, int passes, int rows, const long long* layout,
    void* stream) {
  return planes_entry(xr, dr, di, gr, gi, tabr, tabi, swr, swi, twr, twi,
                      fhr, fhi, outr, outi, q, n, m, n2, radix, passes, rows,
                      layout, stream);
}
