// The whole c2r coded-FFT bucket in one launch, masked or planes.
//
// Replaces two TPU kernels of the JAX package's
// kernels/coded_pipeline.py: coded_irfft_bucket_masked (entry
// coded_irbucket_masked_f32, plain twin
// coded_pipeline.irbucket_body_masked) and coded_irfft_bucket (entry
// coded_irbucket_f32, twin irbucket_body).  Per request q of the
// bucket, from the half spectrum y (h = s/2 + 1 bins, s = m*L = 2*m*n2)
// and its (N,) responder mask (one byte a worker, the service's bool mask
// read in place, so no conversion launch precedes the kernel):
//
//   1. subset and inv(G[subset]) -- block_subset_decode of bucket.cuh;
//   2. the Hermitian extension X of y, the endpoint bins' imaginary parts
//      dropped as numpy.fft.irfft does, and the adjoint recombine
//      butterfly T_i[t] = conj(omega_s^{it}) * sum_r omega_m^{+ir}
//      X[r*L + t] for t <= n2;
//   3. pack_half pairs position p with n2 - p: z_i[p] = E_p + 1j*O_p,
//      E = (T_p + conj T_{n2-p})/2, O = (T_p - conj T_{n2-p})/2 *
//      omega_L^{+p};
//   4. the ifft of the packed shards by the conj trick: the kernel
//      transforms conj(z_i) forward, encodes with conj(G), and takes
//      b = (re/n2, -im/n2) -- ifft(G z) exactly;
//   5. at every packed position: decode h = inv . b, and unpack the pair
//      into the real output o_i[2p] = Re h_i / m, o_i[2p+1] = Im h_i / m,
//      out[t*m + i] = o_i[t].
//
// The planes kernel (kPlanes) takes the request's host-built (m, N)
// scatter decode matrix D in place of the mask: step 1 stages D and all
// N rows of G, and step 5 computes every worker's result over r < N,
// then h = D . b (see coded_bucket.cu for why the two stay apart).
//
// What bounds it on the H100: bytes, as for the r2c kernel, its mirror
// (1 MiB of half spectra in, 1 MiB of real rows out at the default
// bucket: 64 requests, s = 4096, m = 4, N = 8).
//
// Design.  One block per request, every working array in shared memory,
// on the pieces of the r2c kernel (coded_rbucket.cu), whose phases run
// here in reverse order.
//   Message stage: one thread per position t <= n2 reads the m bins
//   X[r*L + t] (coalesced across t for each r), applies the +sign m-point
//   DFT from shared memory and the conjugate recombine twiddle ctw[i*L +
//   t] (coalesced), and writes T_i[t] straight into the word that shard
//   i's point t takes in the FFT's layout: the shards sit in groups of
//   `rows` consecutive shards, each group its own padded plane (pad(a) =
//   a + a/32, fft_rows.cuh's), shard i, point t at word (i / rows) * gp +
//   pad((i % rows) * n2 + t), gp the padded words of a full group.
//   T_i[n2], which has no word there, goes to an m-entry side array.
//   Pack: one thread per pair {p, n2 - p} of a shard reads T_p and
//   T_{n2-p} (T_n2 from the side array for p = 0) and writes the two
//   packed, conjugated values back to the same two words, in place.
//   Shard FFTs: each group runs the Stockham passes of fft_rows.cuh
//   (run_passes: the radix plan fourstep_fft.fft_rows_plan(n2), the f32
//   table of w_n2^t staged once a block) from its shards in place to one
//   ping-pong buffer of a group's size; an odd number of passes leaves
//   the spectra in the buffer, and they are copied back.  The spectra
//   come out in NATURAL order.  The kernel reads no DFT plane: F_A, F_B
//   and W stay on the host side of the wrapper.
//   Code phase: one thread per packed position p reads the m spectra at
//   natural index p (consecutive words across a warp), runs the encode
//   and the decode in registers, and stores its pair of output rows,
//   2*m consecutive floats (float4 where m % 4 == 0 and the row is
//   aligned).
// The working set is laid out by coded_pipeline.bucket_fft_layout with
// the m rows of the +sign F_m and the 2m side words, which also picks the
// group rows, and passed in at launch.  The route's gate stays
// coded_pipeline.irbucket_layout, the dense design's reckoning: this
// layout fits one block wherever that one does.
//
// Precision.  Each entry has a *_bf16 twin (precision="bf16"): the
// n2-point table, the +sign F_m, the conjugate recombine twiddle and the
// pack twiddle in bfloat16 (TW), widened to f32 as they load.  The
// payload, G, the decode and shared memory stay f32: the layout is the
// f32 entries'.

#include <cstring>

#include "bucket.cuh"
#include "fft_rows.cuh"

namespace {

using fft_rows::pad;

// Word offsets of every shared array, then the total, in this order; the
// caller computes them (coded_pipeline.bucket_fft_layout(..., side=2*m)).
struct Layout {
  long long z, y, tab, gs, fp, pw, qm, loc, nodes, sub, side, total;
};

template <class TW>
struct IRBucketArgs {
  const float* yr;     // (q, s//2+1)
  const float* yi;
  const unsigned char* masks;  // masked kernel: (q, n) responder bytes
  const int* perm;
  const float* dr;     // planes kernel: (q, m, n) scatter decode planes
  const float* di;
  const float* gr;
  const float* gi;
  const TW* tabr;      // (n2,) table of w_n2^t
  const TW* tabi;
  const TW* fpr;       // (m, m) +sign DFT
  const TW* fpi;
  const TW* ctwr;      // (m, L) conjugate recombine twiddle
  const TW* ctwi;
  const TW* pwr;       // (n2+1,) pack twiddle omega_L^{+p}
  const TW* pwi;
  float* out;          // (q, s) real
  int n, m;
  float ntau;          // -2*pi/n rounded to float
  fft_rows::Plan plan; // n2, the group rows, the radices
  Layout o;            // shared-memory word offsets
};

// Threads a block: 512 where the code phase's registers allow (its
// per-thread arrays are 4*MM floats), 256 for MM = 32; one block an SM,
// as coded_rbucket.cu takes them, so ptxas does not spill to fit two
constexpr int threads_for(int mm) { return mm <= 16 ? 512 : 256; }

// conj(z) for z = E + 1j*O, E = (a + conj b)/2, O = (a - conj b)/2 * w:
// one packed value from T_p = a, T_{n2-p} = b and the pack twiddle w.
__device__ __forceinline__ void pack_conj(float ar, float ai, float br,
                                          float bi, float wr, float wi,
                                          float& zr, float& zi) {
  const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
  const float dr = 0.5f * (ar - br), di = 0.5f * (ai + bi);
  const float our = dr * wr - di * wi;
  const float oui = dr * wi + di * wr;
  zr = er - oui;     // z = E + 1j*O ...
  zi = -(ei + our);  // ... conjugated for the forward FFT
}

template <int MM, bool kPlanes, class TW>
__global__ void __launch_bounds__(threads_for(MM), 1)
coded_irbucket_kernel(IRBucketArgs<TW> p) {
  extern __shared__ float smem[];
  const int m = p.m, n = p.n;
  const int n2 = p.plan.n, rows = p.plan.rows;  // packed shard length L/2
  const int L = 2 * n2;
  const int s = m * L;
  const int half = s / 2;
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
  float* fp_r = smem + o.fp;    float* fp_i = fp_r + m * m;
  float* pw_r = smem + o.pw;    float* pw_i = pw_r + m * m;
  float* qm_r = smem + o.qm;    float* qm_i = qm_r + m * R;
  float* loc_r = smem + o.loc;  float* loc_i = loc_r + (m + 1);
  float* nd_r = smem + o.nodes; float* nd_i = nd_r + m;
  int* sub = reinterpret_cast<int*>(smem + o.sub);
  float* se_r = smem + o.side;  float* se_i = se_r + m;  // T_i[n2]

  // -- the n2-point table and the +sign DFT -------------------------------
  for (int t = tid; t < n2; t += nt) {
    tb_r[pad(t)] = widen(p.tabr[t]);
    tb_i[pad(t)] = widen(p.tabi[t]);
  }
  block_copy(fp_r, p.fpr, m * m);
  block_copy(fp_i, p.fpi, m * m);

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

  // -- 2. Hermitian extension + adjoint butterfly, t in [0, n2] -----------
  const float* yq_r = p.yr + q * (half + 1);
  const float* yq_i = p.yi + q * (half + 1);
  for (int t = tid; t <= n2; t += nt) {
    float xr[MM], xi[MM];
#pragma unroll
    for (int r = 0; r < MM; ++r) {
      if (r < m) {
        const int v = r * L + t;
        if (v <= half) {
          xr[r] = yq_r[v];
          xi[r] = (v == 0 || v == half) ? 0.f : yq_i[v];
        } else {  // X[v] = conj(Y[s - v])
          xr[r] = yq_r[s - v];
          xi[r] = -yq_i[s - v];
        }
      }
    }
    int g = 0, row = 0;
#pragma unroll 1
    for (int i = 0; i < m; ++i) {
      float accr = 0.f, acci = 0.f;
#pragma unroll
      for (int r = 0; r < MM; ++r)
        if (r < m)
          cmac(accr, acci, fp_r[i * m + r], fp_i[i * m + r], xr[r], xi[r]);
      const float c_re = ldg_f32(p.ctwr + i * L + t);
      const float c_im = ldg_f32(p.ctwi + i * L + t);
      const float vr = accr * c_re - acci * c_im;
      const float vi = accr * c_im + acci * c_re;
      if (t < n2) {
        const int w = g * gp + pad(row * n2 + t);
        z_r[w] = vr;
        z_i[w] = vi;
      } else {
        se_r[i] = vr;
        se_i[i] = vi;
      }
      if (++row == rows) {
        row = 0;
        ++g;
      }
    }
  }
  __syncthreads();

  // -- 3. pack_half in place, conjugated: one thread a pair {p, n2 - p} ---
  const int pairs = n2 / 2 + 1;
  for (int e = tid; e < m * pairs; e += nt) {
    const int i = e / pairs, pp = e - i * pairs;
    const int g = i / rows;
    const int base = g * gp, off = (i - g * rows) * n2;
    const int wa = base + pad(off + pp);
    const int wb = pp == 0 ? -1 : base + pad(off + n2 - pp);
    const float ar = z_r[wa], ai = z_i[wa];
    const float br = pp == 0 ? se_r[i] : z_r[wb];
    const float bi = pp == 0 ? se_i[i] : z_i[wb];
    float zr, zi;
    pack_conj(ar, ai, br, bi, ldg_f32(p.pwr + pp), ldg_f32(p.pwi + pp), zr,
              zi);
    if (pp > 0 && 2 * pp != n2) {  // the partner n2 - p, from the same two
      float ur, ui;
      pack_conj(br, bi, ar, ai, ldg_f32(p.pwr + n2 - pp),
                ldg_f32(p.pwi + n2 - pp), ur, ui);
      z_r[wb] = ur;
      z_i[wb] = ui;
    }
    z_r[wa] = zr;
    z_i[wa] = zi;
  }
  __syncthreads();

  // -- 4. the n2-point DFT of every shard, a group of shards at a time ----
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

  // -- 5. encode with conj(G), scale, decode, unpack at each position -----
  const float fn2 = (float)n2, fm = (float)m;
  float* outq = p.out + q * s;
  const bool vec = (m & 3) == 0 && fft_rows::aligned16(outq, outq);
  for (int pp = tid; pp < n2; pp += nt) {
    float tr[MM], ti[MM], hr[MM], hi[MM];
    int g = 0, row = 0;
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      hr[i] = hi[i] = 0.f;
      if (i < m) {
        const int w = g * gp + pad(row * n2 + pp);  // fft(conj z_i)[pp]
        tr[i] = z_r[w];
        ti[i] = z_i[w];
        if (++row == rows) {
          row = 0;
          ++g;
        }
      }
    }
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      float br = 0.f, bi = 0.f;  // conj(G[r]) . fft(conj z)
#pragma unroll
      for (int i = 0; i < MM; ++i)
        if (i < m)
          cmac(br, bi, gs_r[r * m + i], -gs_i[r * m + i], tr[i], ti[i]);
      br = br / fn2;  // conj and 1/n2: worker row r's ifft(G z)
      bi = bi / -fn2;
#pragma unroll
      for (int j = 0; j < MM; ++j)  // decode: h += inv[:, r] * b (or D)
        if (j < m)
          cmac(hr[j], hi[j], qm_r[j * R + r], qm_i[j * R + r], br, bi);
    }
    float* even = outq + 2LL * pp * m;  // o_j[2p], then o_j[2p+1]
    if (vec) {
#pragma unroll
      for (int j = 0; j < MM; j += 4) {
        if (j < m) {
          reinterpret_cast<float4*>(even)[j / 4] = make_float4(
              hr[j] / fm, hr[j + 1] / fm, hr[j + 2] / fm, hr[j + 3] / fm);
          reinterpret_cast<float4*>(even + m)[j / 4] = make_float4(
              hi[j] / fm, hi[j + 1] / fm, hi[j + 2] / fm, hi[j + 3] / fm);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < MM; ++j) {
        if (j < m) {
          even[j] = hr[j] / fm;
          even[m + j] = hi[j] / fm;
        }
      }
    }
  }
}

template <int MM, bool kPlanes, class TW>
int launch(const IRBucketArgs<TW>& p, int q, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      coded_irbucket_kernel<MM, kPlanes, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (q < 1) return 0;
  coded_irbucket_kernel<MM, kPlanes, TW>
      <<<q, threads_for(MM), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Both entries: the plan and the layout words into p, then the instance
// for m.
template <bool kPlanes, class TW>
int dispatch(IRBucketArgs<TW>& p, int q, int n2, const int* radix,
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
int masked_entry(const float* yr, const float* yi,
                 const unsigned char* masks, const int* perm,
                 const float* gr, const float* gi, const TW* tabr,
                 const TW* tabi, const TW* fpr, const TW* fpi,
                 const TW* ctwr, const TW* ctwi, const TW* pwr,
                 const TW* pwi, float* out, int q, int n, int m, int n2,
                 float ntau, const int* radix, int passes, int rows,
                 const long long* layout, void* stream) {
  IRBucketArgs<TW> p{yr, yi, masks, perm, nullptr, nullptr, gr, gi, tabr,
                     tabi, fpr, fpi, ctwr, ctwi, pwr, pwi, out, n, m, ntau,
                     {}, {}};
  return dispatch<false>(p, q, n2, radix, passes, rows, layout, stream);
}

template <class TW>
int planes_entry(const float* yr, const float* yi, const float* dr,
                 const float* di, const float* gr, const float* gi,
                 const TW* tabr, const TW* tabi, const TW* fpr,
                 const TW* fpi, const TW* ctwr, const TW* ctwi,
                 const TW* pwr, const TW* pwi, float* out, int q, int n,
                 int m, int n2, const int* radix, int passes, int rows,
                 const long long* layout, void* stream) {
  IRBucketArgs<TW> p{yr, yi, nullptr, nullptr, dr, di, gr, gi, tabr, tabi,
                     fpr, fpi, ctwr, ctwi, pwr, pwi, out, n, m, 0.f, {}, {}};
  return dispatch<true>(p, q, n2, radix, passes, rows, layout, stream);
}

}  // namespace

using bf16 = __nv_bfloat16;

// y: (q, s//2+1) planes; masks: (q, n) bytes, nonzero = responded; perm:
// (m,) int32; g: (n, m); tab: the (n2,) table of w_n2^t for
// n2 = s/(2m); fp: (m, m); ctw: (m, 2*n2); pw: (n2+1,); out: (q, s) real;
// radix: the `passes` radices of n2 (fourstep_fft.fft_rows_plan); rows:
// the shards of a group; layout: the 12 words of Layout, in host memory
// (coded_pipeline.bucket_fft_layout with side=2*m).  tab, fp, ctw and pw
// are f32 here, bf16 in the _bf16 twin.  m must be in [1, 32]; the
// wrapper checks.
extern "C" int coded_irbucket_masked_f32(
    const float* yr, const float* yi, const unsigned char* masks,
    const int* perm, const float* gr, const float* gi, const float* tabr,
    const float* tabi, const float* fpr, const float* fpi, const float* ctwr,
    const float* ctwi, const float* pwr, const float* pwi, float* out, int q,
    int n, int m, int n2, float ntau, const int* radix, int passes, int rows,
    const long long* layout, void* stream) {
  return masked_entry(yr, yi, masks, perm, gr, gi, tabr, tabi, fpr, fpi,
                      ctwr, ctwi, pwr, pwi, out, q, n, m, n2, ntau, radix,
                      passes, rows, layout, stream);
}

extern "C" int coded_irbucket_masked_bf16(
    const float* yr, const float* yi, const unsigned char* masks,
    const int* perm, const float* gr, const float* gi, const bf16* tabr,
    const bf16* tabi, const bf16* fpr, const bf16* fpi, const bf16* ctwr,
    const bf16* ctwi, const bf16* pwr, const bf16* pwi, float* out, int q,
    int n, int m, int n2, float ntau, const int* radix, int passes, int rows,
    const long long* layout, void* stream) {
  return masked_entry(yr, yi, masks, perm, gr, gi, tabr, tabi, fpr, fpi,
                      ctwr, ctwi, pwr, pwi, out, q, n, m, n2, ntau, radix,
                      passes, rows, layout, stream);
}

// As coded_irbucket_masked_f32, with d: (q, m, n) scatter decode planes
// in place of the masks (layout: bucket_fft_layout(masked=False,
// side=2*m)).
extern "C" int coded_irbucket_f32(
    const float* yr, const float* yi, const float* dr, const float* di,
    const float* gr, const float* gi, const float* tabr, const float* tabi,
    const float* fpr, const float* fpi, const float* ctwr, const float* ctwi,
    const float* pwr, const float* pwi, float* out, int q, int n, int m,
    int n2, const int* radix, int passes, int rows, const long long* layout,
    void* stream) {
  return planes_entry(yr, yi, dr, di, gr, gi, tabr, tabi, fpr, fpi, ctwr,
                      ctwi, pwr, pwi, out, q, n, m, n2, radix, passes, rows,
                      layout, stream);
}

extern "C" int coded_irbucket_bf16(
    const float* yr, const float* yi, const float* dr, const float* di,
    const float* gr, const float* gi, const bf16* tabr, const bf16* tabi,
    const bf16* fpr, const bf16* fpi, const bf16* ctwr, const bf16* ctwi,
    const bf16* pwr, const bf16* pwi, float* out, int q, int n, int m,
    int n2, const int* radix, int passes, int rows, const long long* layout,
    void* stream) {
  return planes_entry(yr, yi, dr, di, gr, gi, tabr, tabi, fpr, fpi, ctwr,
                      ctwi, pwr, pwi, out, q, n, m, n2, radix, passes, rows,
                      layout, stream);
}
