// The whole c2r coded-FFT bucket in one launch, masked or planes.
//
// Replaces two TPU kernels of the JAX package's
// kernels/coded_pipeline.py: coded_irfft_bucket_masked (entry
// coded_irbucket_masked_f32, plain twin
// coded_pipeline.irbucket_body_masked) and coded_irfft_bucket (entry
// coded_irbucket_f32, twin irbucket_body).  Per request q of the
// bucket, from the half spectrum y (h = s/2 + 1 bins, s = m*L = 2*m*n2)
// and its (N,) responder mask:
//
//   1. subset and inv(G[subset]) -- block_subset_decode of bucket.cuh;
//   2. the Hermitian extension X of y, the endpoint bins' imaginary parts
//      dropped as numpy.fft.irfft does, and the adjoint recombine
//      butterfly T_i[t] = conj(omega_s^{it}) * sum_r omega_m^{+ir}
//      X[r*L + t] for t <= n2, staged in shared memory because
//   3. pack_half pairs position p with n2 - p: z_i[p] = E_p + 1j*O_p,
//      E = (T_p + conj T_{n2-p})/2, O = (T_p - conj T_{n2-p})/2 *
//      omega_L^{+p};
//   4. the ifft of the packed shards through the forward four-step, by
//      the conj trick: the kernel transforms conj(z_i), encodes with
//      conj(G), and takes b = (re/n2, -im/n2) -- ifft(G z) exactly;
//   5. at every packed position: decode h = inv . b, and unpack the pair
//      into the real output o_i[2p] = Re h_i / m, o_i[2p+1] = Im h_i / m,
//      out[t*m + i] = o_i[t].
//
// The planes kernel (kPlanes) takes the request's host-built (m, N)
// scatter decode matrix D in place of the mask: step 1 stages D and all
// N rows of G, and step 5 computes every worker's result over r < N,
// then h = D . b (see coded_bucket.cu for why the two stay apart).
//
// What bounds it on the H100: bytes, as for the r2c kernel (1 MiB of
// half spectra in, 1 MiB of real rows out at the default bucket).  This
// first port runs dense DFT loops in shared memory, one block per
// request.  Its shared working set is laid out by
// coded_pipeline.irbucket_layout, passed in at launch; that reckoning is
// also the gate (ops.coded_irbucket_fusable).

#include <cstring>

#include "bucket.cuh"

namespace {

// Word offsets of every shared array, then the total, in this order; the
// caller computes them (coded_pipeline.irbucket_layout).
struct Layout {
  long long fa, fb, w, msg, t1, z, tt, gs, fp, pw, qm, loc, nodes, sub, total;
};

struct IRBucketArgs {
  const float* yr;     // (q, s//2+1)
  const float* yi;
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
  const float* fpr;    // (m, m) +sign DFT
  const float* fpi;
  const float* ctwr;   // (m, L) conjugate recombine twiddle
  const float* ctwi;
  const float* pwr;    // (n2+1,) pack twiddle omega_L^{+p}
  const float* pwi;
  float* out;          // (q, s) real
  int n, m, a, b;
  float ntau;  // -2*pi/n rounded to float
  Layout o;    // shared-memory word offsets
};

constexpr int kThreads = 256;

template <int MM, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
coded_irbucket_kernel(IRBucketArgs p) {
  extern __shared__ float smem[];
  const int m = p.m, n = p.n, A = p.a, B = p.b;
  const int n2 = A * B;  // packed shard length L/2
  const int L = 2 * n2;
  const long long s = (long long)m * L;
  const long long half = s / 2;
  const long long h = half + 1;
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
  const int tp = n2 + 1;       // pitch of the folded spectra
  float* tt_r = smem + o.tt;   float* tt_i = tt_r + (size_t)m * tp;
  float* gs_r = smem + o.gs;   float* gs_i = gs_r + R * m;
  float* fp_r = smem + o.fp;   float* fp_i = fp_r + m * m;
  float* pw_r = smem + o.pw;   float* pw_i = pw_r + m * m;
  float* qm_r = smem + o.qm;   float* qm_i = qm_r + m * R;
  float* loc_r = smem + o.loc; float* loc_i = loc_r + (m + 1);
  float* nd_r = smem + o.nodes; float* nd_i = nd_r + m;
  int* sub = reinterpret_cast<int*>(smem + o.sub);

  // -- shared planes ------------------------------------------------------
  block_copy(fa_r, p.far, A * A); block_copy(fa_i, p.fai, A * A);
  block_copy(fb_r, p.fbr, B * B); block_copy(fb_i, p.fbi, B * B);
  block_copy(w_r, p.wr, n2);      block_copy(w_i, p.wi, n2);
  block_copy(fp_r, p.fpr, m * m); block_copy(fp_i, p.fpi, m * m);

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
  const float* y_r = p.yr + q * h;
  const float* y_i = p.yi + q * h;
  for (int t = tid; t <= n2; t += nt) {
    float xr[MM], xi[MM];
#pragma unroll
    for (int r = 0; r < MM; ++r) {
      if (r < m) {
        const long long v = (long long)r * L + t;
        if (v <= half) {
          xr[r] = y_r[v];
          xi[r] = (v == 0 || v == half) ? 0.f : y_i[v];
        } else {  // X[v] = conj(Y[s - v])
          xr[r] = y_r[s - v];
          xi[r] = -y_i[s - v];
        }
      }
    }
#pragma unroll 1
    for (int i = 0; i < m; ++i) {
      float accr = 0.f, acci = 0.f;
#pragma unroll
      for (int r = 0; r < MM; ++r)
        if (r < m) cmac(accr, acci, fp_r[i * m + r], fp_i[i * m + r], xr[r], xi[r]);
      const float c_re = p.ctwr[(long long)i * L + t];
      const float c_im = p.ctwi[(long long)i * L + t];
      tt_r[(size_t)i * tp + t] = accr * c_re - acci * c_im;
      tt_i[(size_t)i * tp + t] = accr * c_im + acci * c_re;
    }
  }
  __syncthreads();

  // -- 3./4. pack_half, conjugated, then the four-step of each shard -------
  for (int i = 0; i < m; ++i) {
    const float* ti_r = tt_r + (size_t)i * tp;
    const float* ti_i = tt_i + (size_t)i * tp;
    for (int t = tid; t < n2; t += nt) {
      const float mr = ti_r[t], mi = ti_i[t];
      const float rr = ti_r[n2 - t], ri = -ti_i[n2 - t];  // conj(T[n2-t])
      const float er = 0.5f * (mr + rr), ei = 0.5f * (mi + ri);
      const float dr = 0.5f * (mr - rr), di = 0.5f * (mi - ri);
      const float our = dr * p.pwr[t] - di * p.pwi[t];
      const float oui = dr * p.pwi[t] + di * p.pwr[t];
      msg_r[t] = er - oui;     // z = E + 1j*O ...
      msg_i[t] = -(ei + our);  // ... conjugated for the forward four-step
    }
    __syncthreads();
    block_fourstep_tile(msg_r, msg_i, t1_r, t1_i, fa_r, fa_i, w_r, w_i, fb_r,
                        fb_i, z_r + (size_t)i * A * zp,
                        z_i + (size_t)i * A * zp, A, B, zp);
  }

  // -- 5. encode with conj(G), scale, decode, unpack at each position -----
  const float fn2 = (float)n2, fm = (float)m;
  float* out = p.out + q * s;
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
      float br = 0.f, bi = 0.f;  // conj(G[r]) . fft(conj z)
#pragma unroll
      for (int i = 0; i < MM; ++i)
        if (i < m) cmac(br, bi, gs_r[r * m + i], -gs_i[r * m + i], tr[i], ti[i]);
      br = br / fn2;  // conj and 1/n2: worker row r's ifft(G z)
      bi = bi / -fn2;
#pragma unroll
      for (int j = 0; j < MM; ++j)  // decode: h += inv[:, r] * b (or D)
        if (j < m) cmac(hr[j], hi[j], qm_r[j * R + r], qm_i[j * R + r], br, bi);
    }
#pragma unroll
    for (int j = 0; j < MM; ++j) {
      if (j < m) {
        out[(2LL * pp) * m + j] = hr[j] / fm;
        out[(2LL * pp + 1) * m + j] = hi[j] / fm;
      }
    }
  }
}

template <int MM, bool kPlanes>
int launch(const IRBucketArgs& p, int q, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      coded_irbucket_kernel<MM, kPlanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  coded_irbucket_kernel<MM, kPlanes><<<q, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Both entries: the layout words into p, then the instance for m.
template <bool kPlanes>
int dispatch(IRBucketArgs& p, int q, int m, const long long* layout,
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

// y: (q, s//2+1) planes; masks: (q, n) float; perm: (m,) int32; g: (n, m);
// fa: (a, a); w: (a, b); fb: (b, b) for n2 = a*b = s/(2m); fp: (m, m);
// ctw: (m, 2*n2); pw: (n2+1,); out: (q, s) real; layout: the 15 words of
// Layout, in host memory.  m must be in [1, 32]; the wrapper checks.
extern "C" int coded_irbucket_masked_f32(
    const float* yr, const float* yi, const float* masks, const int* perm,
    const float* gr, const float* gi, const float* far, const float* fai,
    const float* wr, const float* wi, const float* fbr, const float* fbi,
    const float* fpr, const float* fpi, const float* ctwr, const float* ctwi,
    const float* pwr, const float* pwi, float* out, int q, int n, int m, int a,
    int b, float ntau, const long long* layout, void* stream) {
  IRBucketArgs p{yr, yi, masks, perm, nullptr, nullptr, gr, gi, far, fai,
                 wr, wi, fbr, fbi, fpr, fpi, ctwr, ctwi, pwr, pwi, out,
                 n, m, a, b, ntau, {}};
  return dispatch<false>(p, q, m, layout, stream);
}

// As coded_irbucket_masked_f32, with d: (q, m, n) scatter decode planes
// in place of the masks (layout: coded_pipeline.irbucket_layout(
// masked=False)).
extern "C" int coded_irbucket_f32(
    const float* yr, const float* yi, const float* dr, const float* di,
    const float* gr, const float* gi, const float* far, const float* fai,
    const float* wr, const float* wi, const float* fbr, const float* fbi,
    const float* fpr, const float* fpi, const float* ctwr, const float* ctwi,
    const float* pwr, const float* pwi, float* out, int q, int n, int m,
    int a, int b, const long long* layout, void* stream) {
  IRBucketArgs p{yr, yi, nullptr, nullptr, dr, di, gr, gi, far, fai, wr, wi,
                 fbr, fbi, fpr, fpi, ctwr, ctwi, pwr, pwi, out,
                 n, m, a, b, 0.f, {}};
  return dispatch<true>(p, q, m, layout, stream);
}
