// Block-level pieces shared by the bucket kernels (coded_bucket.cu,
// coded_rbucket.cu, coded_irbucket.cu, each with a masked and a planes
// variant): one block serves one request, with every working array in
// shared memory.
//
//   block_subset_decode  -- masked: the request's first m responders and
//                           the closed-form Lagrange inverse of G[subset];
//   block_stage_planes   -- planes: all N rows of G and the request's
//                           host-built (m, N) scatter decode matrix D.
//
// The kernels' shard FFTs are fft_rows.cuh's passes.  Both decodes end
// with a barrier, so their results are visible to the whole block when
// they return.  Either decode leaves R worker rows of G
// in gs (row r at gs[r*m]) and the matrix that decodes them in qm
// (column r at qm[j*R + r]): R = m for the masked kernels (the subset
// and its inverse), R = N for the planes kernels (G and D), so the
// kernels' per-position encode/decode loop is one loop over R.

#pragma once

#include "common.cuh"

// Shared-memory homes of one request's decode state (planar pairs).
struct DecodeSmem {
  float* gs_r;   // (m, m) G rows of the subset
  float* gs_i;
  float* pw_r;   // (m, m) node powers x_j^d
  float* pw_i;
  float* qm_r;   // (m, m) deflation, then inv(G[subset])
  float* qm_i;
  float* loc_r;  // (m+1,) locator coefficients
  float* loc_i;
  float* nd_r;   // (m,) nodes, then 1/A'(x_j)
  float* nd_i;
  int* sub;      // (m,) the subset
};

// A responder mask entry: a byte responded where nonzero, a float where
// past 0.5 (the 0/1 floats the c2c wrapper passes).
__device__ __forceinline__ bool responded(float v) { return v > 0.5f; }
__device__ __forceinline__ bool responded(unsigned char v) { return v != 0; }

// 1. subset = the first m responders of `mk` (see responded) in
//    index order, short rows filled with the first non-responders -- the
//    stable argsort of coded_pipeline.mask_subsets;
// 2. inv(G[subset]) in closed form: locator A(z) = prod (z - x_j) with its
//    factors taken in the order `perm` (the reference's shuffled order),
//    suffix-form deflation Q[i][j] = sum_d a[i+d+1] x_j^d, then
//    inv[i][j] = Q[i][j] / A'(x_j).  Node angles are reduced as integers
//    (sub_j * d mod n) before the float multiply by ntau = -2*pi/n.
// Leaves the subset's generator rows in d.gs and the inverse in d.qm.
template <typename Mask>
__device__ inline void block_subset_decode(const Mask* mk, const int* perm,
                                           const float* gr, const float* gi,
                                           int n, int m, float ntau,
                                           const DecodeSmem& d) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    int cnt = 0;
    for (int k = 0; k < n; ++k) {
      if (responded(mk[k])) {
        if (cnt < m) d.sub[cnt] = k;
        ++cnt;
      }
    }
    for (int k = 0; k < n && cnt < m; ++k) {
      if (!responded(mk[k])) d.sub[cnt++] = k;
    }
  }
  __syncthreads();

  // node powers P[j][d] = omega_n^(sub_j*d mod n), subset generator rows
  for (int e = tid; e < m * m; e += nt) {
    const int j = e / m, dd = e % m;
    const int k = d.sub[j];
    float sn, cs;
    sincosf(ntau * (float)((k * dd) % n), &sn, &cs);
    d.pw_r[e] = cs;
    d.pw_i[e] = sn;
    d.gs_r[e] = gr[k * m + dd];
    d.gs_i[e] = gi[k * m + dd];
  }
  for (int j = tid; j < m; j += nt) {
    float sn, cs;
    sincosf(ntau * (float)(d.sub[j] % n), &sn, &cs);
    d.nd_r[j] = cs;
    d.nd_i[j] = sn;
  }
  __syncthreads();

  // locator A(z) = prod (z - x_j), factors taken in the order `perm`
  if (tid == 0) {
    d.loc_r[0] = 1.f;
    d.loc_i[0] = 0.f;
    for (int u = 1; u <= m; ++u) d.loc_r[u] = d.loc_i[u] = 0.f;
    for (int t = 0; t < m; ++t) {
      const int i = perm[t];
      const float xr = d.nd_r[i], xi = d.nd_i[i];
      for (int u = m; u >= 0; --u) {  // a[u] <- a[u-1] - x * a[u]
        const float sr = u > 0 ? d.loc_r[u - 1] : 0.f;
        const float si = u > 0 ? d.loc_i[u - 1] : 0.f;
        const float ar = d.loc_r[u], ai = d.loc_i[u];
        d.loc_r[u] = sr - (xr * ar - xi * ai);
        d.loc_i[u] = si - (xr * ai + xi * ar);
      }
    }
  }
  __syncthreads();

  // deflation, suffix form: Q[i][j] = sum_d a[i+d+1] x_j^d
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m, j = e % m;
    float accr = 0.f, acci = 0.f;
    for (int dd = 0; i + dd + 1 <= m; ++dd)
      cmac(accr, acci, d.loc_r[i + dd + 1], d.loc_i[i + dd + 1],
           d.pw_r[j * m + dd], d.pw_i[j * m + dd]);
    d.qm_r[e] = accr;
    d.qm_i[e] = acci;
  }
  __syncthreads();

  // 1 / A'(x_j), A'(x_j) = sum_i Q[i][j] x_j^i (overwrites the nodes)
  for (int j = tid; j < m; j += nt) {
    float apr = 0.f, api = 0.f;
    for (int i = 0; i < m; ++i)
      cmac(apr, api, d.qm_r[i * m + j], d.qm_i[i * m + j], d.pw_r[j * m + i],
           d.pw_i[j * m + i]);
    const float den = apr * apr + api * api;
    d.nd_r[j] = apr / den;
    d.nd_i[j] = -api / den;
  }
  __syncthreads();
  // inv[i][j] = Q[i][j] / A'(x_j), in place
  for (int e = tid; e < m * m; e += nt) {
    const int j = e % m;
    const float qr = d.qm_r[e], qi = d.qm_i[e];
    d.qm_r[e] = qr * d.nd_r[j] - qi * d.nd_i[j];
    d.qm_i[e] = qr * d.nd_i[j] + qi * d.nd_r[j];
  }
  __syncthreads();
}

// Planes decode: G (n, m) and this request's D (m, n) into shared memory.
__device__ inline void block_stage_planes(const float* gr, const float* gi,
                                          const float* dr, const float* di,
                                          int n, int m, float* gs_r,
                                          float* gs_i, float* d_r,
                                          float* d_i) {
  for (int t = threadIdx.x; t < n * m; t += blockDim.x) {
    gs_r[t] = gr[t];
    gs_i[t] = gi[t];
    d_r[t] = dr[t];
    d_i[t] = di[t];
  }
  __syncthreads();
}

// dst[t] = src[t] for t < count, widened to f32 (a bf16 plane under
// precision="bf16"), spread over the block (no barrier).
template <class T>
__device__ inline void block_copy(float* dst, const T* src, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x)
    dst[t] = widen(src[t]);
}

