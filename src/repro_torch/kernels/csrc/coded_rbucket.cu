// The whole r2c coded-FFT bucket in one launch, masked or planes.
//
// Replaces two TPU kernels of the JAX package's
// kernels/coded_pipeline.py: coded_rfft_bucket_masked (entry
// coded_rbucket_masked_f32, plain twin coded_pipeline.rbucket_body_masked)
// and coded_rfft_bucket (entry coded_rbucket_f32, twin rbucket_body).
// Per request q of the bucket, from the REAL request x (length
// s = m*L = 2*m*n2) and its (N,) responder mask:
//
//   1. subset and inv(G[subset]) -- block_subset_decode of bucket.cuh,
//      exactly as the c2c bucket kernel does them;
//   2. the m pair-packed message shards z_i[j] = x[i + 2jm]
//      + 1j*x[i + (2j+1)m], each an A x B matrix (n2 = L/2 = A*B),
//      through the four-step DFT;
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
// Unlike the c2c kernel the twiddle plane arrives in NATURAL order: the
// split needs natural reversed indexing, so step 3 reads the four-step's
// scrambled slot c*(B+1) + d of natural p = c + d*A and the rest works
// in natural order.
//
// What bounds it on the H100: bytes.  The default bucket (64 requests,
// s = 4096, m = 4, N = 8) reads 1 MiB of requests and writes 1 MiB of
// half spectra (about 0.6 us at 3.35 TB/s) against some 0.3 us of FP32
// work counted as FFTs.  Like the c2c kernel this first port does more
// work than that -- dense DFT loops in shared memory, one block per
// request -- and leaves SMs idle at small q.  Its shared working set is
// laid out by coded_pipeline.rbucket_layout, passed in at launch; that
// one reckoning is also the gate (ops.coded_rbucket_fusable).

#include <cstring>

#include "bucket.cuh"

namespace {

// Word offsets of every shared array, then the total, in this order; the
// caller computes them (coded_pipeline.rbucket_layout).
struct Layout {
  long long fa, fb, w, msg, t1, z, gs, fh, pw, qm, loc, nodes, sub, total;
};

struct RBucketArgs {
  const float* xr;
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
  const float* swr;  // (n2+1,) split twiddle omega_L^p
  const float* swi;
  const float* twr;  // (m, L) recombine twiddle, natural order
  const float* twi;
  const float* fhr;  // (m//2+1, m) DFT rows
  const float* fhi;
  float* outr;       // (q, s//2+1)
  float* outi;
  int n, m, a, b;
  float ntau;  // -2*pi/n rounded to float
  Layout o;    // shared-memory word offsets
};

constexpr int kThreads = 256;

template <int MM, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
coded_rbucket_kernel(RBucketArgs p) {
  extern __shared__ float smem[];
  const int m = p.m, n = p.n, A = p.a, B = p.b;
  const int n2 = A * B;  // packed shard length L/2
  const int L = 2 * n2;
  const long long s = (long long)m * L;
  const long long sh = s / 2 + 1;
  const int rows = m / 2 + 1;
  const long long q = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout& o = p.o;
  const int R = kPlanes ? n : m;  // worker rows the decode contracts
  float* fa_r = smem + o.fa;   float* fa_i = fa_r + A * A;
  float* fb_r = smem + o.fb;   float* fb_i = fb_r + B * B;
  float* w_r = smem + o.w;     float* w_i = w_r + n2;
  float* msg_r = smem + o.msg; float* msg_i = msg_r + n2;
  float* t1_r = smem + o.t1;   float* t1_i = t1_r + n2;
  const int zp = B + 1;
  float* z_r = smem + o.z;     float* z_i = z_r + (size_t)m * A * zp;
  float* gs_r = smem + o.gs;   float* gs_i = gs_r + R * m;
  float* fh_r = smem + o.fh;   float* fh_i = fh_r + rows * m;
  float* pw_r = smem + o.pw;   float* pw_i = pw_r + m * m;
  float* qm_r = smem + o.qm;   float* qm_i = qm_r + m * R;
  float* loc_r = smem + o.loc; float* loc_i = loc_r + (m + 1);
  float* nd_r = smem + o.nodes; float* nd_i = nd_r + m;
  int* sub = reinterpret_cast<int*>(smem + o.sub);

  // -- shared planes ------------------------------------------------------
  block_copy(fa_r, p.far, A * A); block_copy(fa_i, p.fai, A * A);
  block_copy(fb_r, p.fbr, B * B); block_copy(fb_i, p.fbi, B * B);
  block_copy(w_r, p.wr, n2);      block_copy(w_i, p.wi, n2);
  block_copy(fh_r, p.fhr, rows * m); block_copy(fh_i, p.fhi, rows * m);

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

  // -- 2. four-step DFT of every pair-packed message shard ----------------
  const float* x = p.xr + q * s;
  for (int i = 0; i < m; ++i) {
    for (int t = tid; t < n2; t += nt) {  // z_i[t], t = a*B + b
      msg_r[t] = x[2LL * t * m + i];
      msg_i[t] = x[(2LL * t + 1) * m + i];
    }
    __syncthreads();
    block_fourstep_tile(msg_r, msg_i, t1_r, t1_i, fa_r, fa_i, w_r, w_i, fb_r,
                        fb_i, z_r + (size_t)i * A * zp,
                        z_i + (size_t)i * A * zp, A, B, zp);
  }

  // -- 3. encode + decode at each packed position, in place ---------------
  for (int pp = tid; pp < n2; pp += nt) {
    const int zo = (pp % A) * zp + pp / A;  // slot of natural index pp
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
      for (int j = 0; j < MM; ++j)  // decode: h += inv[:, r] * b (or D)
        if (j < m) cmac(hr[j], hi[j], qm_r[j * R + r], qm_i[j * R + r], br, bi);
    }
#pragma unroll
    for (int j = 0; j < MM; ++j) {
      if (j < m) {
        z_r[(size_t)j * A * zp + zo] = hr[j];
        z_i[(size_t)j * A * zp + zo] = hi[j];
      }
    }
  }
  __syncthreads();

  // -- 4. split, Hermitian extension, twiddle, m//2+1 rows, cut -----------
  for (int u = tid; u < L; u += nt) {
    const bool lower = u <= n2;
    const int sp = lower ? u : L - u;       // split index in [0, n2]
    const int pa = sp == n2 ? 0 : sp;       // Z[sp mod n2]
    const int pb = sp == 0 ? 0 : n2 - sp;   // Z[(n2 - sp) mod n2]
    const int za = (pa % A) * zp + pa / A;
    const int zb = (pb % A) * zp + pb / A;
    const float sw_re = p.swr[sp], sw_im = p.swi[sp];
    float ur[MM], ui[MM];
#pragma unroll
    for (int j = 0; j < MM; ++j) {
      if (j < m) {
        const float ar = z_r[(size_t)j * A * zp + za];
        const float ai = z_i[(size_t)j * A * zp + za];
        const float br = z_r[(size_t)j * A * zp + zb];
        const float bi = z_i[(size_t)j * A * zp + zb];
        const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
        const float our = 0.5f * (ai + bi), oui = -0.5f * (ar - br);
        const float cr = er + our * sw_re - oui * sw_im;
        float ci = ei + our * sw_im + oui * sw_re;
        if (!lower) ci = -ci;  // C[L-p] = conj(C[p])
        const float w_re = p.twr[(long long)j * L + u];
        const float w_im = p.twi[(long long)j * L + u];
        ur[j] = cr * w_re - ci * w_im;
        ui[j] = cr * w_im + ci * w_re;
      }
    }
#pragma unroll 1
    for (int jr = 0; jr < rows; ++jr) {
      const long long k = (long long)jr * L + u;
      if (k >= sh) break;
      float accr = 0.f, acci = 0.f;
#pragma unroll
      for (int j = 0; j < MM; ++j)
        if (j < m) cmac(accr, acci, fh_r[jr * m + j], fh_i[jr * m + j], ur[j], ui[j]);
      p.outr[q * sh + k] = accr;
      p.outi[q * sh + k] = acci;
    }
  }
}

template <int MM, bool kPlanes>
int launch(const RBucketArgs& p, int q, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      coded_rbucket_kernel<MM, kPlanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  coded_rbucket_kernel<MM, kPlanes><<<q, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Both entries: the layout words into p, then the instance for m.
template <bool kPlanes>
int dispatch(RBucketArgs& p, int q, int m, const long long* layout,
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

// x: (q, s) real plane; masks: (q, n) float; perm: (m,) int32; g: (n, m);
// fa: (a, a); w: (a, b); fb: (b, b) for n2 = a*b = s/(2m); sw: (n2+1,);
// tw: (m, 2*n2) natural order; fh: (m//2+1, m); out: (q, s//2+1) planes;
// layout: the 14 words of Layout, in host memory.  m must be in [1, 32];
// the wrapper checks.
extern "C" int coded_rbucket_masked_f32(
    const float* xr, const float* masks, const int* perm, const float* gr,
    const float* gi, const float* far, const float* fai, const float* wr,
    const float* wi, const float* fbr, const float* fbi, const float* swr,
    const float* swi, const float* twr, const float* twi, const float* fhr,
    const float* fhi, float* outr, float* outi, int q, int n, int m, int a,
    int b, float ntau, const long long* layout, void* stream) {
  RBucketArgs p{xr, masks, perm, nullptr, nullptr, gr, gi, far, fai, wr, wi,
                fbr, fbi, swr, swi, twr, twi, fhr, fhi, outr, outi,
                n, m, a, b, ntau, {}};
  return dispatch<false>(p, q, m, layout, stream);
}

// As coded_rbucket_masked_f32, with d: (q, m, n) scatter decode planes in
// place of the masks (layout: coded_pipeline.rbucket_layout(masked=False)).
extern "C" int coded_rbucket_f32(
    const float* xr, const float* dr, const float* di, const float* gr,
    const float* gi, const float* far, const float* fai, const float* wr,
    const float* wi, const float* fbr, const float* fbi, const float* swr,
    const float* swi, const float* twr, const float* twi, const float* fhr,
    const float* fhi, float* outr, float* outi, int q, int n, int m, int a,
    int b, const long long* layout, void* stream) {
  RBucketArgs p{xr, nullptr, nullptr, dr, di, gr, gi, far, fai, wr, wi, fbr,
                fbi, swr, swi, twr, twi, fhr, fhi, outr, outi,
                n, m, a, b, 0.f, {}};
  return dispatch<true>(p, q, m, layout, stream);
}
