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
//   2. the m interleaved message shards c_i[j] = x[i + j*m], each an A x B
//      matrix, through the four-step DFT ((F_A @ M_i) * W) @ F_B;
//   3. at every payload position l: worker results b_r = G[subset_r] . t,
//      decode c^ = inv . b, recombine twiddle, length-m DFT;
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
// Everything after the four-step mixes only the shard axis at a fixed l,
// so it runs in registers, one thread per l.  The recombine twiddle plane
// arrives pre-permuted to the four-step order (the reference's contract),
// so it is read at the scrambled index c*B + d of natural l = c + d*A.
//
// What bounds it on the H100: bytes.  Counted as FFTs (5*L*log2(L) flops
// per shard) plus the O(m^2) coding work per payload position, the
// service's default bucket (64 requests, s = 4096, m = 4, N = 8) needs
// about 0.5 us of FP32 work against about 1.25 us to read x and write the
// output once.  This first port does more work than that: its four-step
// is two dense DFT contractions (8*L*(A + B) flops per shard), one block
// per request with every working array in shared memory -- the planes
// F_A, F_B, W, F_m, one message shard, the column-pass result, the m
// shard spectra (padded pitch B+1 so the l-walk reads conflict-free) and
// the O(m^2) decode state -- and plain shared-memory DFT loops; the launch
// is only as wide as the bucket, so it leaves SMs idle at small q.  The
// working set is laid out by coded_pipeline.bucket_layout on the Python
// side, which passes the word offsets in at launch: that one reckoning is
// also the fused gate (ops.coded_bucket_fusable, against 232,448 bytes).
// The planes kernel does 2*N*m complex MACs per position where the
// masked one does 2*m*m, and stages 4*N*m words of G and D.

#include <cstring>

#include "bucket.cuh"

namespace {

// Word offsets of every shared array, then the total, in this order; the
// caller computes them (coded_pipeline.bucket_layout).
struct Layout {
  long long fa, fb, w, msg, t1, z, gs, fm, pw, qm, loc, nodes, sub, total;
};

struct BucketArgs {
  const float* xr;
  const float* xi;
  const float* masks;  // masked kernel: (q, n) responder masks
  const int* perm;
  const float* dr;     // planes kernel: (q, m, n) scatter decode planes
  const float* di;
  const float* gr;
  const float* gi;
  const float* far;
  const float* fai;
  const float* wr;
  const float* wi;
  const float* fbr;
  const float* fbi;
  const float* twr;
  const float* twi;
  const float* fmr;
  const float* fmi;
  float* outr;
  float* outi;
  int n, m, a, b;
  float ntau;  // -2*pi/n rounded to float
  Layout o;    // shared-memory word offsets
};

constexpr int kThreads = 256;

template <int MM, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
coded_bucket_kernel(BucketArgs p) {
  extern __shared__ float smem[];
  const int m = p.m, n = p.n, A = p.a, B = p.b;
  const int L = A * B;
  const long long s = (long long)m * L;
  const long long q = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout& o = p.o;
  const int R = kPlanes ? n : m;  // worker rows the decode contracts
  float* fa_r = smem + o.fa;   float* fa_i = fa_r + A * A;
  float* fb_r = smem + o.fb;   float* fb_i = fb_r + B * B;
  float* w_r = smem + o.w;     float* w_i = w_r + L;
  float* msg_r = smem + o.msg; float* msg_i = msg_r + L;
  float* t1_r = smem + o.t1;   float* t1_i = t1_r + L;
  const int zp = B + 1;
  float* z_r = smem + o.z;     float* z_i = z_r + (size_t)m * A * zp;
  float* gs_r = smem + o.gs;   float* gs_i = gs_r + R * m;
  float* fm_r = smem + o.fm;   float* fm_i = fm_r + m * m;
  float* pw_r = smem + o.pw;   float* pw_i = pw_r + m * m;
  float* qm_r = smem + o.qm;   float* qm_i = qm_r + m * R;
  float* loc_r = smem + o.loc; float* loc_i = loc_r + (m + 1);
  float* nd_r = smem + o.nodes; float* nd_i = nd_r + m;
  int* sub = reinterpret_cast<int*>(smem + o.sub);

  // -- shared planes ------------------------------------------------------
  block_copy(fa_r, p.far, A * A); block_copy(fa_i, p.fai, A * A);
  block_copy(fb_r, p.fbr, B * B); block_copy(fb_i, p.fbi, B * B);
  block_copy(w_r, p.wr, L);       block_copy(w_i, p.wi, L);
  block_copy(fm_r, p.fmr, m * m); block_copy(fm_i, p.fmi, m * m);

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

  // -- 2. four-step DFT of every message shard ----------------------------
  for (int i = 0; i < m; ++i) {
    for (int t = tid; t < L; t += nt) {  // M_i[a][b] = x[i + (a*B + b)*m]
      msg_r[t] = p.xr[q * s + (long long)t * m + i];
      msg_i[t] = p.xi[q * s + (long long)t * m + i];
    }
    __syncthreads();
    block_fourstep_tile(msg_r, msg_i, t1_r, t1_i, fa_r, fa_i, w_r, w_i, fb_r,
                        fb_i, z_r + (size_t)i * A * zp,
                        z_i + (size_t)i * A * zp, A, B, zp);
  }

  // -- 3./4. encode, decode, recombine at each natural payload index l ----
  for (int l = tid; l < L; l += nt) {
    const int c = l % A, d = l / A;
    const int zo = c * zp + d;  // spectrum slot of X_i[l]
    const int lp = c * B + d;   // the same slot in the scrambled order
    float tr[MM], ti[MM], hr[MM], hi[MM];
#pragma unroll
    for (int i = 0; i < MM; ++i) {
      hr[i] = hi[i] = 0.f;
      if (i < m) {
        tr[i] = z_r[(size_t)i * A * zp + zo];
        ti[i] = z_i[(size_t)i * A * zp + zo];
      }
    }
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      float br = 0.f, bi = 0.f;  // worker row r's result b = G[r] . t
#pragma unroll
      for (int i = 0; i < MM; ++i)
        if (i < m) cmac(br, bi, gs_r[r * m + i], gs_i[r * m + i], tr[i], ti[i]);
#pragma unroll
      for (int j = 0; j < MM; ++j)  // decode: c^ += inv[:, r] * b (or D)
        if (j < m) cmac(hr[j], hi[j], qm_r[j * R + r], qm_i[j * R + r], br, bi);
    }
#pragma unroll
    for (int j = 0; j < MM; ++j) {
      if (j < m) {
        const float w_re = p.twr[(long long)j * L + lp];
        const float w_im = p.twi[(long long)j * L + lp];
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
        if (j < m) cmac(accr, acci, fm_r[jp * m + j], fm_i[jp * m + j], hr[j], hi[j]);
      p.outr[q * s + (long long)jp * L + l] = accr;
      p.outi[q * s + (long long)jp * L + l] = acci;
    }
  }
}

template <int MM, bool kPlanes>
int launch(const BucketArgs& p, int q, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      coded_bucket_kernel<MM, kPlanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  coded_bucket_kernel<MM, kPlanes><<<q, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Both entries: the layout words into p, then the instance for m.
template <bool kPlanes>
int dispatch(BucketArgs& p, int q, int m, const long long* layout,
             void* stream) {
  memcpy(&p.o, layout, sizeof(Layout));
  const size_t smem = (size_t)p.o.total * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 4) return launch<4, kPlanes>(p, q, smem, st);
  if (m <= 8) return launch<8, kPlanes>(p, q, smem, st);
  if (m <= 16) return launch<16, kPlanes>(p, q, smem, st);
  if (m <= 32) return launch<32, kPlanes>(p, q, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The device's opt-in shared memory per block (the gate's limit), or -1.
extern "C" int device_smem_per_block_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// x: (q, s) planes; masks: (q, n) float; perm: (m,) int32; g: (n, m);
// fa: (a, a); w: (a, b); fb: (b, b); tw: (m, a*b) pre-scrambled; fm: (m, m);
// out: (q, s); layout: the 14 words of Layout, in host memory.  m must be
// in [1, 32]; the wrapper checks.
extern "C" int coded_bucket_masked_f32(
    const float* xr, const float* xi, const float* masks, const int* perm,
    const float* gr, const float* gi, const float* far, const float* fai,
    const float* wr, const float* wi, const float* fbr, const float* fbi,
    const float* twr, const float* twi, const float* fmr, const float* fmi,
    float* outr, float* outi, int q, int n, int m, int a, int b, float ntau,
    const long long* layout, void* stream) {
  BucketArgs p{xr, xi, masks, perm, nullptr, nullptr, gr, gi, far, fai,
               wr, wi, fbr, fbi, twr, twi, fmr, fmi, outr, outi,
               n, m, a, b, ntau, {}};
  return dispatch<false>(p, q, m, layout, stream);
}

// As coded_bucket_masked_f32, with d: (q, m, n) scatter decode planes in
// place of the masks (layout: coded_pipeline.bucket_layout(masked=False)).
extern "C" int coded_bucket_f32(
    const float* xr, const float* xi, const float* dr, const float* di,
    const float* gr, const float* gi, const float* far, const float* fai,
    const float* wr, const float* wi, const float* fbr, const float* fbi,
    const float* twr, const float* twi, const float* fmr, const float* fmi,
    float* outr, float* outi, int q, int n, int m, int a, int b,
    const long long* layout, void* stream) {
  BucketArgs p{xr, xi, nullptr, nullptr, dr, di, gr, gi, far, fai, wr, wi,
               fbr, fbi, twr, twi, fmr, fmi, outr, outi, n, m, a, b, 0.f, {}};
  return dispatch<true>(p, q, m, layout, stream);
}
